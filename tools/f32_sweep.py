#!/usr/bin/env python3
"""Tilings of the f32 CUDA-core kernels (csrc/f32gemm.cuh) at the
full-width models' shapes (batch 16) on one H100.

    python3 tools/f32_sweep.py

For every convchain layer of the ResUNet x4 (``chip_smoke.layer_shapes``,
prologue as the model runs it) it times the f32 backward (``_launch_bwd``
with the layout the forward keeps) at the planner's tiling and at each dx
column tile (``f32_dx_plan``'s BN) and dW block target
(``F32_DW_TARGET_BLOCKS``); for every RDNet tail of the RDResUNet
(``chip_smoke.rd_shapes``) the CUDA-core backward at the planner's tiling
and with the GEMM launch's block target (``F32_TARGET_BLOCKS``) and the
column tiles (all 128, or the planner's choice) changed, and the
CUDA-core forward (``f32_fwd_plan``) with fc1's column tile (128, 64 or
the planner's) and fc2's block target changed; for the default SwinIR's
blocks (backward with DropPath keep-scales, shifted) the CUDA-core
backward (``swinblock.f32_plan``) with the token products' column tiles
(128, 64 or the planner's), the attention kernels' blocks an SM
(``ATTN_BLOCKS``) and the weight-gradient launch's block target changed.
Times are CUDA events over a run of calls; each total sums the shapes as
one model pass does.  The card's name and power limit come first; then
each shape's planner and fastest times, and the totals of the planner's
and the fastest settings.  Needs a CUDA device and nvcc.
"""

import itertools
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the shapes)
from pssr2_tpu_torch.ops import convchain, rdtail, swinblock  # noqa: E402

EPS = 1e-6
BATCH = 16


def events_ms(fn, reps=10):
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_conv(dev, gen):
    plan_dx, plan_dw, target = convchain.f32_dx_plan, convchain.f32_dw_plan, convchain.F32_DW_TARGET_BLOCKS
    tot_plan = tot_best = 0.0
    for cin, cout, res, n_entry, n_prologue in chip_smoke.layer_shapes():
        x = torch.randn(BATCH, res, res, cin, device=dev, generator=gen)
        weight = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, device=dev, generator=gen)
        ab = torch.stack([torch.rand(cin, device=dev, generator=gen) + 0.5,
                          0.3 * torch.randn(cin, device=dev, generator=gen)])
        gy = torch.randn(BATCH, res, res, cout, device=dev, generator=gen)
        gs1, gs2 = (0.01 * torch.randn(cout, device=dev, generator=gen) for _ in range(2))
        wkb = convchain.bwd_weight(weight, torch.float32)
        for count, a in ((n_entry, None), (n_prologue, ab)):
            if not count:
                continue
            with torch.no_grad():
                y, _, _ = convchain.fused_conv_layer(x, weight, bias, a)
                args = (x, weight, y, gy, gs1, gs2, a, wkb)
                t_plan = events_ms(lambda: convchain._launch_bwd(*args))
                times = {}
                bns = [bn for bn in (16, 32, 64, 128) if bn >= 16 and (cin > 16 or bn == 16)]
                for bn, tgt in itertools.product(bns, (264, 528, 1056)):
                    convchain.f32_dx_plan = lambda n, h, w, c, bn=bn: (bn, (-(-convchain.sub_tiles(n, h, w) // 2),
                                                                          -(-c // bn)))
                    convchain.F32_DW_TARGET_BLOCKS = tgt
                    plan_dw.cache_clear()
                    times[bn, tgt] = events_ms(lambda: convchain._launch_bwd(*args))
                convchain.f32_dx_plan, convchain.F32_DW_TARGET_BLOCKS = plan_dx, target
                plan_dw.cache_clear()
            best = min(times, key=times.get)
            tot_plan += count * t_plan
            tot_best += count * times[best]
            print(f"convchain f32 bwd {cin:4d}->{cout:4d} @{res:3d} prologue={int(a is not None)} x{count}: planner "
                  f"{plan_dx(BATCH, res, res, cin)[0]}/{target} {t_plan:.4f} ms, fastest dx BN {best[0]} dW target "
                  f"{best[1]} {times[best]:.4f} ms | " + " ".join(f"{k[0]}/{k[1]} {v:.4f}" for k, v in times.items()))
    print(f"total ResUNet f32 backward (36 layers): planner {tot_plan:.3f} ms, fastest {tot_best:.3f} ms")


def sweep_rdtail(dev, gen):
    target, bn_rule = rdtail.F32_TARGET_BLOCKS, rdtail._f32_bn
    tot_plan = tot_best = 0.0
    for m, c, inter, g in chip_smoke.rd_shapes()[1]:
        x = torch.randn(m, c, device=dev, generator=gen)
        params = (1.0 + 0.1 * torch.randn(c, device=dev, generator=gen), 0.1 * torch.randn(c, device=dev, generator=gen),
                  torch.randn(c, inter, device=dev, generator=gen) / c**0.5,
                  0.1 * torch.randn(inter, device=dev, generator=gen),
                  torch.randn(inter, g, device=dev, generator=gen) / inter**0.5,
                  0.1 * torch.randn(g, device=dev, generator=gen))
        gout = torch.randn(m, g, device=dev, generator=gen)
        with torch.no_grad():
            call = (lambda: rdtail._launch_bwd(x, params, gout, EPS))
            t_plan = events_ms(call)
            times = {}
            for mult, wide in itertools.product((4, 8, 16), (False, True)):
                rdtail.F32_TARGET_BLOCKS = mult * rdtail.SMS
                rdtail._f32_bn = (lambda n: 128) if wide else bn_rule
                rdtail.f32_plan.cache_clear()
                times[mult, wide] = events_ms(call)
            rdtail.F32_TARGET_BLOCKS, rdtail._f32_bn = target, bn_rule
            rdtail.f32_plan.cache_clear()
        best = min(times, key=times.get)
        tot_plan += t_plan
        tot_best += times[best]
        print(f"rdtail f32 bwd {(m, c, inter, g)}: planner {t_plan:.4f} ms, fastest target {best[0]} x SMS "
              f"{'all BN 128' if best[1] else 'BN by padding'} {times[best]:.4f} ms | "
              + " ".join(f"{k[0]}/{int(k[1])} {v:.4f}" for k, v in times.items()))
    print(f"total RDResUNet f32 tail backward (21 tails): planner {tot_plan:.3f} ms, fastest {tot_best:.3f} ms")


def _tail_inputs(dev, gen, m, c, inter, g):
    x = torch.randn(m, c, device=dev, generator=gen)
    params = (1.0 + 0.1 * torch.randn(c, device=dev, generator=gen), 0.1 * torch.randn(c, device=dev, generator=gen),
              torch.randn(c, inter, device=dev, generator=gen) / c**0.5,
              0.1 * torch.randn(inter, device=dev, generator=gen),
              torch.randn(inter, g, device=dev, generator=gen) / inter**0.5,
              0.1 * torch.randn(g, device=dev, generator=gen))
    return x, params


def sweep_rdtail_fwd(dev, gen):
    target, rows_bn = rdtail.F32_TARGET_BLOCKS, rdtail._f32_rows_bn
    tot_plan = tot_best = 0.0
    for m, c, inter, g in chip_smoke.rd_shapes()[1]:
        x, params = _tail_inputs(dev, gen, m, c, inter, g)
        with torch.no_grad():
            call = (lambda: rdtail._launch_fwd(x, params, EPS))
            t_plan = events_ms(call)
            times = {}
            for bn, mult in itertools.product((0, 128, 64), (4, 8, 16)):
                rdtail.F32_TARGET_BLOCKS = mult * rdtail.SMS
                rdtail._f32_rows_bn = rows_bn if bn == 0 else (lambda mm, n, bn=bn: bn)
                rdtail.f32_fwd_plan.cache_clear()
                times[bn, mult] = events_ms(call)
            rdtail.F32_TARGET_BLOCKS, rdtail._f32_rows_bn = target, rows_bn
            rdtail.f32_fwd_plan.cache_clear()
        best = min(times, key=times.get)
        tot_plan += t_plan
        tot_best += times[best]
        print(f"rdtail f32 fwd {(m, c, inter, g)}: planner {t_plan:.4f} ms, fastest fc1 BN "
              f"{best[0] or 'planner'} fc2 target {best[1]} x SMS {times[best]:.4f} ms | "
              + " ".join(f"{k[0]}/{k[1]} {v:.4f}" for k, v in times.items()))
    print(f"total RDResUNet f32 tail forward (21 tails): planner {tot_plan:.3f} ms, fastest {tot_best:.3f} ms")


def sweep_swin(dev, gen):
    c, heads, ws, hidden = chip_smoke.SWIN_C, chip_smoke.SWIN_HEADS, chip_smoke.SWIN_WS, chip_smoke.SWIN_HIDDEN
    shape, n = (BATCH, chip_smoke.LR_RES, chip_smoke.LR_RES, c), ws * ws
    mk = lambda *sz, sc=0.1: sc * torch.randn(*sz, device=dev, generator=gen)
    x, gout = torch.randn(*shape, device=dev, generator=gen), torch.randn(*shape, device=dev, generator=gen)
    params = (1.0 + mk(c), mk(c), mk(c, 3 * c, sc=c**-0.5), mk(3 * c), mk(c, c, sc=c**-0.5), mk(c), 1.0 + mk(c),
              mk(c), mk(c, hidden, sc=c**-0.5), mk(hidden), mk(hidden, c, sc=hidden**-0.5), mk(c),
              mk(heads, n, n, sc=0.5))
    keep = (torch.rand(BATCH, device=dev, generator=gen) < 0.9).float() / 0.9
    rows_bn, attn, target = swinblock._f32_rows_bn, dict(swinblock.ATTN_BLOCKS), rdtail.F32_TARGET_BLOCKS
    with torch.no_grad():
        call = (lambda: swinblock._launch_bwd(x, params, gout, heads, ws, ws // 2, EPS, (keep, keep.flip(0))))
        t_plan = events_ms(call)
        times = {}
        for bn, fwd, bwd, mult in itertools.product((0, 128, 64), (4, 8, 16), (2, 3, 4), (4, 8, 16)):
            swinblock._f32_rows_bn = rows_bn if bn == 0 else (lambda mm, nn, bn=bn: bn)
            swinblock.ATTN_BLOCKS.update(fwd=fwd, bwd=bwd)
            rdtail.F32_TARGET_BLOCKS = mult * rdtail.SMS
            swinblock.f32_plan.cache_clear()
            times[bn, fwd, bwd, mult] = events_ms(call, reps=3)
        swinblock._f32_rows_bn, rdtail.F32_TARGET_BLOCKS = rows_bn, target
        swinblock.ATTN_BLOCKS.update(attn)
        swinblock.f32_plan.cache_clear()
    best = min(times, key=times.get)
    print(f"swinblock f32 bwd {shape} shifted: planner {t_plan:.4f} ms, fastest token BN {best[0] or 'planner'}, "
          f"attention blocks an SM {best[1]} / {best[2]}, dW target {best[3]} x SMS {times[best]:.4f} ms | "
          + " ".join(f"{'/'.join(map(str, k))} {v:.4f}" for k, v in times.items()))
    print(f"total SwinIR f32 block backward (16 blocks): planner {16 * t_plan:.3f} ms, fastest {16 * times[best]:.3f} ms")


def main():
    if not torch.cuda.is_available():
        print("f32_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sweep_conv(dev, gen)
    sweep_rdtail(dev, gen)
    sweep_rdtail_fwd(dev, gen)
    sweep_swin(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
