#!/usr/bin/env python3
"""Device time of the f32 CUDA-core kernels of convchain, rdtail and the
Swin block, launch by launch, at the full-width models' shapes (batch 16)
on one H100.

    python3 tools/f32_bwd_split.py [--root DIR] [--reps N]

``--root`` names the tree whose ``pssr2_tpu_torch`` is timed (default: the
one this script lies in), so two trees can be compared in one run on one
card.  For every convchain layer shape of the ResUNet x4 and the RDResUNet
decoder (``chip_smoke.conv_shapes``; prologue on and off as the models run
them), every RDNet tail of the RDResUNet (``chip_smoke.rd_shapes``;
backward, then forward) and the default SwinIR's blocks (backward with
DropPath keep-scales, as training runs it, unshifted and shifted) it
prints the wall time of one call by CUDA events and the device time of
each kernel it launches (``torch.profiler``, summed by kernel name over
``--reps`` calls), then the totals over one model pass.  The card's name
and power limit come first.  Needs a CUDA device and nvcc.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch

EPS = 1e-6
BATCH = 16


def events_ms(fn, reps):
    """Mean time of ``fn()`` by CUDA events, after two warm calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps):
    """{kernel label: mean device ms a call} of ``fn()`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            m = re.search(r"((?:\w|::)*(?:convchain|rdtail|swin|f32g)(?:\w|::)*kernel)", evt.key)
            label = m.group(1) if m else "other"
            out[label] = out.get(label, 0.0) + evt.self_device_time_total / 1e3 / reps
    return out


def _fmt(split):
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_bwd_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke  # the tree's own shapes
    from pssr2_tpu_torch.ops import convchain, rdtail, swinblock

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    print(f"tree {Path(args.root).resolve()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}

    def add(model, count, wall, split):
        t = totals.setdefault(model, {"wall": 0.0})
        t["wall"] += count * wall
        for k, v in split.items():
            t[k] = t.get(k, 0.0) + count * v

    for (cin, cout, res), per_model in chip_smoke.conv_shapes().items():
        x = torch.randn(BATCH, res, res, cin, device=dev, generator=gen)
        weight = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, device=dev, generator=gen)
        ab = torch.stack([torch.rand(cin, device=dev, generator=gen) + 0.5,
                          0.3 * torch.randn(cin, device=dev, generator=gen)])
        gy = torch.randn(BATCH, res, res, cout, device=dev, generator=gen)
        gs1, gs2 = (0.01 * torch.randn(cout, device=dev, generator=gen) for _ in range(2))
        for prologue in (False, True):
            counts = {m: c[int(prologue)] for m, c in per_model.items() if c[int(prologue)]}
            if not counts:
                continue
            a = ab if prologue else None
            with torch.no_grad():
                y, _, _ = convchain.fused_conv_layer(x, weight, bias, a)
                call = (lambda: convchain._launch_bwd(x, weight, y, gy, gs1, gs2, a))
                wall, split = events_ms(call, args.reps), kernel_ms(call, args.reps)
            print(f"convchain f32 bwd {cin:4d}->{cout:4d} @{res:3d} prologue={int(prologue)} {counts}: "
                  f"wall {wall:.4f} ms | {_fmt(split)}")
            for model, count in counts.items():
                add(f"convchain {model}", count, wall, split)
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
            wall, split = events_ms(call, args.reps), kernel_ms(call, args.reps)
        ops = 2.0 * m * inter * (3 * c + 2 * g)
        print(f"rdtail f32 bwd M {m:5d} C {c:3d} inter {inter:4d} G {g:3d}: wall {wall:.4f} ms "
              f"({ops / wall / 1e9:.2f} TFLOP/s) | {_fmt(split)}")
        add("rdtail RDResUNet", 1, wall, split)
        with torch.no_grad():
            call = (lambda: rdtail._launch_fwd(x, params, EPS))
            wall, split = events_ms(call, args.reps), kernel_ms(call, args.reps)
        ops = 2.0 * m * inter * (c + g)
        print(f"rdtail f32 fwd M {m:5d} C {c:3d} inter {inter:4d} G {g:3d}: wall {wall:.4f} ms "
              f"({ops / wall / 1e9:.2f} TFLOP/s) | {_fmt(split)}")
        add("rdtail RDResUNet forward", 1, wall, split)
    c, heads, ws, hidden = chip_smoke.SWIN_C, chip_smoke.SWIN_HEADS, chip_smoke.SWIN_WS, chip_smoke.SWIN_HIDDEN
    shape, n = (BATCH, chip_smoke.LR_RES, chip_smoke.LR_RES, c), ws * ws
    mk = lambda *sz, sc=0.1: sc * torch.randn(*sz, device=dev, generator=gen)
    x, gout = torch.randn(*shape, device=dev, generator=gen), torch.randn(*shape, device=dev, generator=gen)
    params = (1.0 + mk(c), mk(c), mk(c, 3 * c, sc=c**-0.5), mk(3 * c), mk(c, c, sc=c**-0.5), mk(c), 1.0 + mk(c),
              mk(c), mk(c, hidden, sc=c**-0.5), mk(hidden), mk(hidden, c, sc=hidden**-0.5), mk(c),
              mk(heads, n, n, sc=0.5))
    keep = (torch.rand(BATCH, device=dev, generator=gen) < 0.9).float() / 0.9
    for shift in (0, ws // 2):
        with torch.no_grad():
            call = (lambda: swinblock._launch_bwd(x, params, gout, heads, ws, shift, EPS, (keep, keep.flip(0))))
            wall, split = events_ms(call, args.reps), kernel_ms(call, args.reps)
        print(f"swinblock f32 bwd {shape} shift {shift}: wall {wall:.4f} ms | {_fmt(split)}")
        add("swinblock SwinIR", chip_smoke.SWIN_BLOCKS // 2, wall, split)
    for model, t in totals.items():
        wall = t.pop("wall")
        what = "forward" if model.endswith("forward") else "backward"
        print(f"total {model.removesuffix(' forward')} f32 {what}: wall {wall:.3f} ms | " + _fmt(t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
