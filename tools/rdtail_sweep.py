#!/usr/bin/env python3
"""Tilings of the bf16 RDNet-tail tensor-core kernels at the full-width
RDResUNet x4's 21 dense-block tails (batch 16) on one H100.

    python3 tools/rdtail_sweep.py

For each tail it times the forward launch (``rdtail_tc_fwd``) at the
planner's tiling (``ops/rdtail.py:tail_plan``) and at the other warpgroup
counts and I splits, and the four backward launches (``rdtail_tc_bwd``) at
the planner's tiling and with one of its knobs changed (the rows kernel's
warpgroups, I chunk and split; dh's width; the weight gradients' row
share).  Each result is held against the plain version (``reference_tail``
and ``reference_tail_bwd``, their tolerances).  Times are device times by
CUDA events: the launches are queued behind a sleep kernel, so the host's
gaps between them do not count; the parameters are bf16 already, and the
backward's time includes zeroing its f32 gradients.  The card's name and
power limit come first; the totals of the planner's and of the fastest
tilings last.  Needs a CUDA device and nvcc.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the tail shapes)
from pssr2_tpu_torch.ops import rdtail  # noqa: E402

EPS = 1e-6


def device_ms(fn, reps=20):
    """Device time of ``fn()`` a call, the launches queued behind a sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("rdtail_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bt, f32 = {"dtype": torch.bfloat16, "device": dev}, {"dtype": torch.float32, "device": dev}
    totals = dict.fromkeys(("fwd plan", "fwd best", "bwd plan", "bwd best"), 0.0)
    for m, c, inter, g in chip_smoke.rd_shapes()[1]:
        x = torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
        params = [1.0 + 0.1 * torch.randn(c, device=dev, generator=gen),
                  0.1 * torch.randn(c, device=dev, generator=gen),
                  torch.randn(c, inter, device=dev, generator=gen) / c**0.5,
                  0.1 * torch.randn(inter, device=dev, generator=gen),
                  torch.randn(inter, g, device=dev, generator=gen) / inter**0.5,
                  0.1 * torch.randn(g, device=dev, generator=gen)]
        pb = [p.to(torch.bfloat16).contiguous() for p in params]
        gout = torch.randn(m, g, device=dev, generator=gen).to(torch.bfloat16)
        plan = rdtail.tail_plan(m, c, inter, g)
        kp, gk, gp = 64 * -(-c // 64), 64 * -(-g // 64), rdtail._gp(g)

        ref = rdtail.reference_tail(x, *pb, eps=EPS)
        out = torch.empty(m, g, **bt)
        wg0, ni, s0, _ = plan["fwd"]
        res = {}
        for wg in (1, 2):
            if rdtail.fwd_smem(wg, ni, gp, kp) > rdtail.SMEM_LIMIT:
                continue
            for s in range(1, min(rdtail.MAX_SPLITS, -(-inter // ni)) + 1):
                def fwd(wg=wg, s=s):
                    return rdtail._tc_fwd_fn()(x.data_ptr(), *(p.data_ptr() for p in pb), out.data_ptr(), m, c, inter,
                                               g, wg, ni, s, EPS, stream)

                if fwd() != 0:
                    raise RuntimeError(f"rdtail_tc_fwd failed at {(m, c, inter, g)}, wg {wg}, splits {s}")
                torch.cuda.synchronize()
                err, _, bound = rdtail.errors(out, ref)
                if not err <= bound:
                    raise RuntimeError(f"rdtail_tc_fwd disagrees at {(m, c, inter, g)}, wg {wg}, splits {s}: {err}")
                res[wg, s] = device_ms(fwd)
        best = min(res, key=res.get)
        ops = 2.0 * m * inter * (c + g)
        totals["fwd plan"] += res[wg0, s0]
        totals["fwd best"] += res[best]
        print(f"fwd M {m} C {c} I {inter} G {g}: plan (wg, splits) {(wg0, s0)} {res[wg0, s0]:.4f} ms "
              f"({ops / res[wg0, s0] / 1e9:.1f} TFLOP/s), best {best} {res[best]:.4f} ms; all "
              + " ".join(f"{k}:{v:.4f}" for k, v in res.items()), flush=True)

        ref_b = rdtail.reference_tail_bwd(x, *pb, gout, eps=EPS)
        h, dh, dx = torch.empty(m, c, **bt), torch.empty(m, c, **bt), torch.empty(m, c, **bt)
        zg, dz1 = torch.empty(m, inter, **bt), torch.empty(m, inter, **bt)
        grads = [torch.zeros(c, **f32), torch.zeros(c, **f32), torch.zeros(c, inter, **f32), torch.zeros(inter, **f32),
                 torch.zeros(inter, g, **f32), torch.zeros(g, **f32)]

        def bwd(rows, dh_bn, dw_rows):
            for t in grads:
                t.zero_()
            ptrs = (x, *pb[:5], gout, h, zg, dz1, dh, dx, *grads)
            return rdtail._tc_bwd_fn()(*(t.data_ptr() for t in ptrs), m, c, inter, g, *rows, dh_bn, dw_rows, EPS,
                                       stream)

        base = (plan["rows"][:3], plan["dh_bn"], plan["dw_rows"])
        variants = [base]
        for rw, rn in ((1, 64), (1, 128), (2, 64), (2, 128)):
            if rdtail.rows_smem(rw, rn, kp, gk) > rdtail.SMEM_LIMIT:
                continue
            for rs in (1, 2, 3, 4, 8, 16):
                if rs <= -(-inter // rn):
                    variants.append(((rw, rn, rs), base[1], base[2]))
        variants.append((base[0], 192 - base[1], base[2]))
        variants += [(base[0], base[1], max(64, 64 * round(base[2] * f / 64))) for f in (0.5, 2)]
        resb = {}
        ops = 2.0 * m * inter * (3 * c + 2 * g)
        for v in dict.fromkeys(variants):
            if bwd(*v) != 0:
                raise RuntimeError(f"rdtail_tc_bwd failed at {(m, c, inter, g)}, {v}")
            torch.cuda.synchronize()
            errs = rdtail.bwd_errors((dx, *grads), ref_b)
            if not all(e <= b for e, _, b in errs.values()):
                raise RuntimeError(f"rdtail_tc_bwd disagrees at {(m, c, inter, g)}, {v}: {errs}")
            resb[v] = device_ms(lambda v=v: bwd(*v))
        bb = min(resb, key=resb.get)
        totals["bwd plan"] += resb[base]
        totals["bwd best"] += resb[bb]
        print(f"bwd M {m} C {c} I {inter} G {g}: plan ((wg, ni, splits), dh_bn, dw_rows) {base} {resb[base]:.4f} ms "
              f"({ops / resb[base] / 1e9:.1f} TFLOP/s), best {bb} {resb[bb]:.4f} ms; all "
              + " ".join(f"{k}:{v:.4f}" for k, v in resb.items()), flush=True)
    print("totals over the 21 tails, ms of device time: " + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
