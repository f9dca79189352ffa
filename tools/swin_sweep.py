#!/usr/bin/env python3
"""Tilings of the bf16 Swin-block tensor-core kernels at the default
SwinIR's blocks (batch 16, 128^2 tokens, C 96, 6 heads of 16, 8 x 8
windows, MLP 192; a shifted block with DropPath keep-scales) on one H100.

    python3 tools/swin_sweep.py

It times the forward launch (``swin_tc_fwd``) and the two backward launches
(``swin_tc_bwd``) at the planner's plan (``ops/swinblock.py:tc_plan``) and
at every other (windows a block, weight stages) whose shared memory fits,
each on the planner's persistent grid, and the weight gradients' row share
at half and twice the planner's.  Each result is held against the plain
version (``reference_block`` and ``reference_block_bwd``, their
tolerances).  Times are device times by CUDA events: the launches are
queued behind a sleep kernel, so the host's gaps between them do not count;
the backward's time includes zeroing its f32 gradients.  The card's name
and power limit come first.  Needs a CUDA device and nvcc.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the SwinIR block's widths)
from pssr2_tpu_torch.ops import swinblock  # noqa: E402

EPS = chip_smoke.SWIN_EPS


def device_ms(fn, reps=10):
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
        print("swin_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    c, heads, ws, hidden = chip_smoke.SWIN_C, chip_smoke.SWIN_HEADS, chip_smoke.SWIN_WS, chip_smoke.SWIN_HIDDEN
    b, h, w, shift = chip_smoke.BATCH, chip_smoke.LR_RES, chip_smoke.LR_RES, ws // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
    gout = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
    mk = lambda *s, sc=0.1: sc * torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    params = swinblock._fold_scale(
        (1.0 + mk(c), mk(c), mk(c, 3 * c, sc=c**-0.5), mk(3 * c), mk(c, c, sc=c**-0.5), mk(c), 1.0 + mk(c), mk(c),
         mk(c, hidden, sc=c**-0.5), mk(hidden), mk(hidden, c, sc=hidden**-0.5), mk(c), mk(heads, ws * ws, ws * ws, sc=0.5)),
        (c // heads) ** -0.5)
    keep = (torch.rand(b, device=dev, generator=gen) < 0.9).float() / 0.9
    scales = (keep, keep.flip(0))
    kp = swinblock._kernel_params(x, params)
    s1, s2 = swinblock._kernel_scales(scales)
    nwin, m = b * h * w // (ws * ws), b * h * w
    ops = 3.0 * m * (8 * c * c + 4 * ws * ws * c + 4 * c * hidden)  # forward; the backward three times that
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(heads=heads, ws=ws, shift=shift, eps=EPS, scales=scales)
    with torch.no_grad():
        ref = swinblock.reference_block(x, params, **kw)
        ref_b = swinblock.reference_block_bwd(x, params, gout, **kw)
    out = torch.empty_like(x)
    dx = torch.empty_like(x)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in kp]
    widths = (c, c, c, hidden, c, hidden, c, 3 * c)
    scratch = [torch.empty((m, wd), dtype=torch.bfloat16, device=dev) for wd in widths]
    fwd_ptrs = swinblock._ptrs((x, out, *kp, s1, s2))
    bwd_ptrs = swinblock._ptrs((x, gout, dx, *kp, s1, s2, *scratch, *grads))

    for backward in (False, True):
        plan = swinblock.tc_plan(nwin, c, hidden, backward)
        grid = plan[2]
        dw0 = swinblock.tc_dw_rows(m, c, hidden)
        variants = [(plan[0], plan[1], dw0)]
        for wg in (1, 2):
            for nring in (2, 3):
                if swinblock.tc_smem(c, hidden, wg, nring, backward) <= swinblock.SMEM_LIMIT:
                    variants.append((wg, nring, dw0))
        if backward:
            variants += [(plan[0], plan[1], max(64, 64 * round(dw0 * f / 64))) for f in (0.5, 2)]
        res = {}
        for wg, nring, dw_rows in dict.fromkeys(variants):
            smem = swinblock.tc_smem(c, hidden, wg, nring, backward)
            g = min(-(-nwin // wg), swinblock.SMS * max(1, min(2 // wg, 233472 // (smem + 1024))))

            def run(wg=wg, nring=nring, dw_rows=dw_rows, g=g):
                if not backward:
                    return swinblock._tc_fwd_fn()(fwd_ptrs, b, h, w, c, heads, shift, hidden, wg, nring, g, EPS,
                                                  stream)
                for t in grads:
                    t.zero_()
                return swinblock._tc_bwd_fn()(bwd_ptrs, b, h, w, c, heads, shift, hidden, wg, nring, g, dw_rows, EPS,
                                              stream)

            if run() != 0:
                raise RuntimeError(f"swin_tc_{'bwd' if backward else 'fwd'} failed at {(wg, nring, g, dw_rows)}")
            torch.cuda.synchronize()
            if backward:
                errs = swinblock.bwd_errors((dx, *grads), ref_b)
                ok = all(e <= lim for e, _, lim in errs.values())
            else:
                errs = swinblock.errors(out, ref)
                ok = errs[0] <= errs[2]
            if not ok:
                raise RuntimeError(f"swin_tc at {(wg, nring, g, dw_rows)} disagrees with its plain version: {errs}")
            res[wg, nring, g, dw_rows] = device_ms(run)
        base = (plan[0], plan[1], grid, dw0)
        best = min(res, key=res.get)
        n_ops = ops if backward else ops / 3
        print(f"{'bwd' if backward else 'fwd'} one block: plan (windows a block, stages, grid, dW rows) {base} "
              f"{res[base]:.4f} ms ({n_ops / res[base] / 1e9:.1f} TFLOP/s), best {best} {res[best]:.4f} ms; all "
              + " ".join(f"{k}:{v:.4f}" for k, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
