#!/usr/bin/env python3
"""Smoke run of pssr2_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--seed S]

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the CUDA kernel sources are compiled with nvcc, all at once
   (seconds, registers and spills printed);
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it, with times (CUDA events), its bound
   and a library yardstick: the convchain forward and backward at every
   distinct ResBlock layer shape of the full-width ResUNet x4 at batch 16,
   in f32 and bf16, with the prologue on and off; the SSIM forward and
   backward at (16, 1, 512, 512) f32;
4. serving: ``predict_images`` with the full-width ``ResUNet()`` x4 on 32
   synthetic 128^2 -> 512^2 tiles in f32 and bf16, with the kernels'
   launch counts read around each run, and two f32 tiles held against the
   same model on the CPU (plain versions);
5. training: the full-width ``ResUNet()`` in train mode, a few steps in
   bf16 and in f32 on 512^2 uint8 patches from ``PatchLoader`` at batch 16
   (device augment, downscale, Poisson noise; ``SSIMLoss(mix=0.8,
   ms=False)``; AdamW), with the launch counts checked per step, then one
   f32 step on 2 samples held against the same step on the CPU.

The last two lines are a JSON line of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  This script imports nothing of
JAX and nothing of the JAX package.
"""

import argparse
import copy
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, f32 on
# the CUDA cores, and the HBM3 rate.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

HIDDEN, DEPTH, SCALE, LR_RES, BATCH, TILES = [64, 128, 256, 512, 1024], 3, 4, 128, 16, 32
SOURCES = ("convchain", "convchain_bwd", "ssimfused")
# The f32 card output against the same model on the CPU, on the [0, 255]
# scale: only the order of f32 summation differs, through 45 layers.
CPU_TOL = 0.05
# Training: epochs over the TILES patches (2 steps each), learning rate, and
# the SSIM kernels' shape (the loss's images at batch 16).
TRAIN_EPOCHS, LR_RATE = 2, 1e-3
SSIM_SHAPE = (BATCH, 1, LR_RES * SCALE, LR_RES * SCALE)
# The card's f32 train step against the same step on the CPU (plain
# versions), 2 samples, same weights and (hr, lr).  At 2 samples the
# step's gradients are chaotic at the f32 rounding level: weights perturbed
# by one part in 1e7 move the CPU's own gradients by up to 18% of a deep
# layer's largest element and by 2.5% all together, as much as the card
# differs.  So the script also runs the CPU step from weights perturbed by
# PERTURB and holds the card to SELF_FACTOR times the CPU's own change,
# for: "grad", the largest over parameters of max |error| / max |CPU
# gradient|; "grads", the norm of the error over the norm of the CPU
# gradients, all parameters together; "moved", the share of parameter
# elements whose AdamW steps differ by more than LR_RATE / 2 (the first
# Adam step moves an element by about LR_RATE with the sign of its
# gradient).  Fixed bounds: "loss" (abs), "param" (abs, after the step) and
# "stat" (relative error of the running statistics).
PERTURB, SELF_FACTOR = 1e-7, 3.0
STEP_TOL = {"loss": 1e-4, "param": 2.001 * LR_RATE, "stat": 1e-3}


def layer_shapes():
    """[(cin, cout, res, n_entry, n_prologue)] of the ResBlock 3x3 layers in
    one ResUNet forward: each block's first layer has no prologue, its
    other DEPTH layers do."""
    layers, out = [1, *HIDDEN], {}
    n = len(layers) - 1
    for i in range(n):
        res = LR_RES >> i
        blocks = [(layers[i], layers[i + 1], res)]
        if i + 1 < n:
            blocks.append((layers[-i - 1] - layers[-i - 2] // 2, layers[-i - 2], LR_RES >> (n - 2 - i)))
        for cin, cout, r in blocks:
            for key, count in (((cin, cout, r), (1, 0)), ((cout, cout, r), (0, DEPTH))):
                e, p = out.get(key, (0, 0))
                out[key] = (e + count[0], p + count[1])
    return [(*k, *v) for k, v in out.items()]


def cuda_ms(fn, reps=10):
    """Mean time of ``fn()`` on the card by CUDA events, after warmup."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype):
    """Least time for some work: its bytes (each input read once, each
    output written once) over the memory rate, against its operations over
    the peak rate of the dtype.  -> (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bound_ms(n, res, cin, cout, dtype):
    """Bound of one convchain forward layer (x and y, the weights, bias,
    ab and the two sums; the conv's operations)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (n * res * res * (cin + cout) + 9 * cin * cout + cout) + 4 * (2 * cin + 2 * cout)
    return bound(nbytes, 2.0 * n * res * res * 9 * cin * cout, dtype)


def bwd_bound_ms(n, res, cin, cout, dtype, prologue):
    """Bound of one convchain backward: x, y, gy and the weights read, dx
    written in the dtype; the stat cotangents read and dW, dbias (and ab,
    d(a, b)) in f32; twice the forward's operations (dx and dW)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (n * res * res * (2 * cin + 2 * cout) + 9 * cin * cout)
    nbytes += 4 * (9 * cin * cout + 3 * cout + (4 * cin if prologue else 0))
    return bound(nbytes, 2 * 2.0 * n * res * res * 9 * cin * cout, dtype)


def ssim_bound_ms(b, h, w, backward):
    """Bound of the SSIM forward (x, y read, two sums per image written) or
    backward (x, y and the two cotangents read, gx, gy written), f32.
    Operations: the three products per pixel, the separable 11-tap blur of
    five maps (horizontal over H x W', vertical over H' x W', 2 operations
    a tap) and about 19 operations of map arithmetic and sums per VALID
    pixel; the backward adds about 30 per VALID pixel for the four maps,
    their transposed blur (horizontal over H' x W, vertical over H x W) and
    8 per pixel for gx and gy."""
    hp, wp = h - 10, w - 10
    ops = 3 * h * w + 110 * (h * wp + hp * wp) + 19 * hp * wp
    if backward:
        ops += 11 * hp * wp + 88 * (hp * w + h * w) + 8 * h * w
    nbytes = 4 * b * h * w * (4 if backward else 2) + 4 * 2 * b
    return bound(nbytes, float(b * ops), torch.float32)


def check_kernels(device, gen):
    """Phase 3a: the convchain forward kernel against reference_layer at
    every layer shape; returns per-dtype totals over one forward."""
    from pssr2_tpu_torch.ops import convchain

    totals = {}
    print(
        f"phase kernels: convchain_fwd vs plain (batch {BATCH}): max abs error (relative) <= bound "
        "for y, s1, s2 | ms of kernel, plain, F.conv2d (conv alone)"
    )
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0,
               "ops": 0.0, "bound_by": {}}
        for cin, cout, res, n_entry, n_pro in layer_shapes():
            x = torch.randn(BATCH, res, res, cin, device=device, generator=gen).to(dtype)
            weight = torch.randn(cout, cin, 3, 3, device=device, generator=gen) / (3 * cin**0.5)
            bias = 0.1 * torch.randn(cout, device=device, generator=gen)
            ab = torch.stack([
                torch.rand(cin, device=device, generator=gen) + 0.5,
                0.3 * torch.randn(cin, device=device, generator=gen),
            ])
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
            w_dt, b_dt = weight.to(dtype), bias.to(dtype)
            lib_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_dt, b_dt, padding=1))
            b_ms, b_by = bound_ms(BATCH, res, cin, cout, dtype)
            for prologue, count in ((False, n_entry), (True, n_pro)):
                if count == 0:
                    continue
                a = ab if prologue else None
                with torch.no_grad():
                    got = convchain.fused_conv_layer(x, weight, bias, a)
                    ref = convchain.reference_layer(x, weight, bias, a)
                    torch.cuda.synchronize()
                    errs = convchain.errors(got, ref)
                    k_ms = cuda_ms(lambda: convchain.fused_conv_layer(x, weight, bias, a))
                    p_ms = cuda_ms(lambda: convchain.reference_layer(x, weight, bias, a))
                ok = all(err <= lim for err, _, lim in errs.values())
                print(
                    f"  {str(dtype)[6:]:8s} {cin:4d}->{cout:4d} @{res:3d} prologue={int(prologue)} x{count}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                    + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"convchain_fwd disagrees with its plain version: {errs}")
                tot["ms"] += count * k_ms
                tot["plain_ms"] += count * p_ms
                tot["library_ms"] += count * lib_ms
                tot["bound_ms"] += count * b_ms
                tot["ops"] += count * 2.0 * BATCH * res * res * 9 * cin * cout
                tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0.0) + count * b_ms
                tot["max_abs_err"] = max(tot["max_abs_err"], errs["y"][0])
        totals[dtype] = tot
        print(
            f"  {dtype}: one forward's {sum(e + p for *_, e, p in layer_shapes())} layers at batch {BATCH}: kernel {tot['ms']:.3f} ms "
            f"({tot['ops'] / tot['ms'] / 1e9:.2f} TFLOP/s), plain {tot['plain_ms']:.3f} ms, "
            f"F.conv2d {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms"
        )
    return totals


def check_bwd(device, gen):
    """Phase 3b: the convchain backward kernels against reference_layer_bwd
    at every layer shape, with the prologue on and off; returns per-dtype
    totals over one backward of the model (each shape weighted by how often
    the model runs it)."""
    from pssr2_tpu_torch.ops import convchain

    totals = {}
    print(
        f"phase kernels: convchain_bwd (2 launches) vs plain (batch {BATCH}): max abs error (relative) "
        "<= bound for dx, dW, dbias, d(a, b) | ms of kernel, plain, conv2d_input + conv2d_weight"
    )
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0,
               "ops": 0.0, "bound_by": {}}
        for cin, cout, res, n_entry, n_pro in layer_shapes():
            x = torch.randn(BATCH, res, res, cin, device=device, generator=gen).to(dtype)
            weight = torch.randn(cout, cin, 3, 3, device=device, generator=gen) / (3 * cin**0.5)
            bias = 0.1 * torch.randn(cout, device=device, generator=gen)
            ab = torch.stack([
                torch.rand(cin, device=device, generator=gen) + 0.5,
                0.3 * torch.randn(cin, device=device, generator=gen),
            ])
            gy = torch.randn(BATCH, res, res, cout, device=device, generator=gen).to(dtype)
            gs1 = 0.01 * torch.randn(cout, device=device, generator=gen)
            gs2 = 0.01 * torch.randn(cout, device=device, generator=gen)
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # channels-last memory
            w_dt = weight.to(dtype)

            def library():
                torch.nn.grad.conv2d_input(x_nchw.shape, w_dt, g_nchw, padding=1)
                torch.nn.grad.conv2d_weight(x_nchw, w_dt.shape, g_nchw, padding=1)

            lib_ms = cuda_ms(library)
            for prologue, count in ((False, n_entry), (True, n_pro)):
                a = ab if prologue else None
                b_ms, b_by = bwd_bound_ms(BATCH, res, cin, cout, dtype, prologue)
                with torch.no_grad():
                    y, _, _ = convchain.fused_conv_layer(x, weight, bias, a)
                    args = (x, weight, y, gy, gs1, gs2, a)
                    got = convchain._launch_bwd(*args)
                    ref = convchain.reference_layer_bwd(*args)
                    torch.cuda.synchronize()
                    errs = convchain.bwd_errors(got, ref)
                    k_ms = cuda_ms(lambda: convchain._launch_bwd(*args))
                    p_ms = cuda_ms(lambda: convchain.reference_layer_bwd(*args))
                ok = all(err <= lim for err, _, lim in errs.values())
                print(
                    f"  {str(dtype)[6:]:8s} {cin:4d}->{cout:4d} @{res:3d} prologue={int(prologue)} x{count}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                    + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"convchain_bwd disagrees with its plain version: {errs}")
                tot["ms"] += count * k_ms
                tot["plain_ms"] += count * p_ms
                tot["library_ms"] += count * lib_ms
                tot["bound_ms"] += count * b_ms
                tot["ops"] += count * 2 * 2.0 * BATCH * res * res * 9 * cin * cout
                tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0.0) + count * b_ms
                tot["max_abs_err"] = max(tot["max_abs_err"], *(e for e, _, _ in errs.values()))
        totals[dtype] = tot
        print(
            f"  {dtype}: one backward's {sum(e + p for *_, e, p in layer_shapes())} layers at batch {BATCH}: "
            f"kernel {tot['ms']:.3f} ms ({tot['ops'] / tot['ms'] / 1e9:.2f} TFLOP/s), plain {tot['plain_ms']:.3f} ms, "
            f"conv2d_input + conv2d_weight {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms"
        )
    return totals


def check_ssim(device, gen):
    """Phase 3c: the SSIM forward and backward kernels against
    reference_parts (band-matrix blur, autograd) at the loss's shape;
    returns their numbers for the kernels line."""
    from pssr2_tpu_torch.ops import ssimfused
    from pssr2_tpu_torch.ops.ssim import _gaussian_window

    b, _, h, w = SSIM_SHAPE
    c1, c2, win, sigma = 0.01**2, 0.03**2, 11, 1.5
    y = torch.rand(SSIM_SHAPE, device=device, generator=gen)
    x = y + 0.05 * torch.randn(SSIM_SHAPE, device=device, generator=gen)
    xs, ys = x.view(b, h, w), y.view(b, h, w)
    g_s = torch.randn(b, device=device, generator=gen)
    g_cs = torch.randn(b, device=device, generator=gen)

    s, cs = ssimfused._launch_fwd(xs, ys, c1, c2, win, sigma)
    gx, gy = ssimfused._launch_bwd(xs, ys, g_s, g_cs, c1, c2, win, sigma)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    s_ref, cs_ref = ssimfused.reference_parts(xr, yr, c1, c2, win, sigma)
    cot = (g_s.view(b, 1), g_cs.view(b, 1))
    gx_ref, gy_ref = torch.autograd.grad((s_ref, cs_ref), (xr, yr), cot, retain_graph=True)
    torch.cuda.synchronize()
    tol = ssimfused.TOLERANCE
    errs = {
        "s": ((s - s_ref.view(b)).abs().max().item(), tol["s"]),
        "cs": ((cs - cs_ref.view(b)).abs().max().item(), tol["cs"]),
        "gx": ((gx - gx_ref.view(b, h, w)).abs().max().item(), tol["g"] * gx_ref.abs().max().item()),
        "gy": ((gy - gy_ref.view(b, h, w)).abs().max().item(), tol["g"] * gy_ref.abs().max().item()),
    }

    g = torch.from_numpy(_gaussian_window(win, sigma)).to(device)
    window = torch.outer(g, g).view(1, 1, win, win)
    moments = torch.cat([x, y, x * x, y * y, x * y])  # (5B, 1, H, W)
    maps = torch.randn(4 * b, 1, h - win + 1, w - win + 1, device=device, generator=gen)
    with torch.no_grad():
        k_fwd = cuda_ms(lambda: ssimfused._launch_fwd(xs, ys, c1, c2, win, sigma))
        p_fwd = cuda_ms(lambda: ssimfused.reference_parts(x, y, c1, c2, win, sigma))
        l_fwd = cuda_ms(lambda: F.conv2d(moments, window))
        k_bwd = cuda_ms(lambda: ssimfused._launch_bwd(xs, ys, g_s, g_cs, c1, c2, win, sigma))
        l_bwd = cuda_ms(lambda: F.conv_transpose2d(maps, window))
    p_bwd = cuda_ms(lambda: torch.autograd.grad((s_ref, cs_ref), (xr, yr), cot, retain_graph=True))
    out = {}
    for name, k_ms, p_ms, l_ms, bwd, keys in (
        ("ssim_fwd", k_fwd, p_fwd, l_fwd, False, ("s", "cs")),
        ("ssim_bwd", k_bwd, p_bwd, l_bwd, True, ("gx", "gy")),
    ):
        b_ms, b_by = ssim_bound_ms(b, h, w, bwd)
        ok = all(errs[k][0] <= errs[k][1] for k in keys)
        print(
            f"phase kernels: {name} vs plain at {SSIM_SHAPE} f32: "
            + " ".join(f"{k} {errs[k][0]:.3g} <= {errs[k][1]:.3g}" for k in keys)
            + f" | kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            + f"{'F.conv_transpose2d of the 4 maps' if bwd else 'F.conv2d of the 5 moment maps'} {l_ms:.4f} ms, "
            + f"bound {b_ms:.4f} ms ({b_by})" + ("" if ok else "  <-- DISAGREES")
        )
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version: {errs}")
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": max(errs[k][0] for k in keys)}
    return out


def write_tiles(root, seed):
    """TILES synthetic 512^2 uint8 TIFF tiles under ``root``."""
    from pssr2_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    hr_res = LR_RES * SCALE
    yy, xx = np.mgrid[0:hr_res, 0:hr_res]
    for i in range(TILES):
        f = rng.uniform(0.02, 0.2, 2)
        img = 120 + 90 * np.sin(xx * f[0] + i) * np.cos(yy * f[1]) + rng.normal(0, 10, (hr_res, hr_res))
        tiff.imwrite(root / f"tile_{i:02d}.tif", np.clip(img, 0, 255).astype(np.uint8))


def run_slice(device, seed, card, root, tmp):
    """Phase 4: predict_images at full width in f32 and bf16; returns the
    kernel launches of each run."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset, tiff
    from pssr2_tpu_torch.models import ResUNet
    from pssr2_tpu_torch.ops import convchain
    from pssr2_tpu_torch.predict import predict_images
    from pssr2_tpu_torch.weights import params_from_jax, seeded_jax_params

    state = params_from_jax(seeded_jax_params(HIDDEN, DEPTH, scale=SCALE, seed=seed))
    launches = {}
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    if dataset.is_lr or len(dataset) != TILES:
        raise RuntimeError(f"dataset: is_lr={dataset.is_lr}, {len(dataset)} items")
    batches = -(-TILES // BATCH)

    for dtype in (torch.float32, torch.bfloat16):
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
        out_dir = Path(tmp, f"preds_{str(dtype)[6:]}")
        np.random.seed(seed)
        torch.cuda.synchronize()
        convchain.launches = 0
        start = time.perf_counter()
        predict_images(model, dataset, device=device, batch_size=BATCH, out_dir=str(out_dir))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches[dtype] = convchain.launches
        want = sum(e + p for *_, e, p in layer_shapes()) * batches  # 36 per forward at full width
        print(
            f"phase serving {dtype}: {TILES} tiles {LR_RES}^2 -> {hr_res}^2 in {elapsed:.3f} s = "
            f"{TILES / elapsed:.2f} tiles/s on {card} (first run: includes cuDNN set-up and tile "
            f"loading); convchain_fwd launches {launches[dtype]} (want {want})"
        )
        if launches[dtype] != want:
            raise RuntimeError(f"convchain_fwd launched {launches[dtype]} times, want {want}")
        preds = sorted(out_dir.glob("*.tif"))
        if len(preds) != TILES:
            raise RuntimeError(f"{len(preds)} predictions written, want {TILES}")
        for p in preds:
            image = tiff.imread(p)
            if image.shape != (hr_res, hr_res) or image.dtype != np.uint8:
                raise RuntimeError(f"{p.name}: {image.shape} {image.dtype}")

        # raw outputs of two tiles: finite; f32 against the CPU
        np.random.seed(seed)
        lr = torch.from_numpy(np.stack([dataset[i][1] for i in range(2)]))
        with torch.inference_mode():
            out = model(lr.to(device)).cpu()
        if out.shape != (2, 1, hr_res, hr_res) or not torch.isfinite(out).all():
            raise RuntimeError(f"model output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
        if dtype == torch.float32:
            cpu_model = copy.deepcopy(model).to("cpu")
            with torch.inference_mode():
                ref = cpu_model(lr)
            err = (out - ref).abs().max().item()
            print(f"  f32 card vs CPU on 2 tiles: max abs err {err:.3g} (bound {CPU_TOL}), "
                  f"output range [{ref.min().item():.2f}, {ref.max().item():.2f}]")
            if not err <= CPU_TOL:
                raise RuntimeError(f"card output differs from the CPU by {err}")
    return launches


def _counts():
    from pssr2_tpu_torch.ops import convchain, ssimfused

    return (convchain.launches, convchain.bwd_launches, ssimfused.fwd_launches, ssimfused.bwd_launches)


def _reset_counts():
    from pssr2_tpu_torch.ops import convchain, ssimfused

    convchain.launches = convchain.bwd_launches = 0
    ssimfused.fwd_launches = ssimfused.bwd_launches = 0


def _train_parts(seed):
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data.pipeline import make_device_gen_pair
    from pssr2_tpu_torch.train import _build_paired_steps
    from pssr2_tpu_torch.util import SSIMLoss
    from pssr2_tpu_torch.weights import params_from_jax, seeded_jax_params

    state = params_from_jax(seeded_jax_params(HIDDEN, DEPTH, scale=SCALE, seed=seed))
    base = make_device_gen_pair(SCALE, Poisson())

    def gen_pair(generator, batch, augment):
        return base(generator, batch)

    return state, gen_pair, SSIMLoss(mix=0.8, ms=False), _build_paired_steps


def _model(state, dtype, device):
    from pssr2_tpu_torch.models import ResUNet

    model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, dtype=dtype, device=device)
    model.load_state_dict(state, strict=True)
    return model.train()


def run_train(device, seed, card, root):
    """Phase 5a: the training step at full width in bf16 and f32 over
    PatchLoader batches, with the launches of each step checked; returns
    the launches of each run as (fwd, bwd, ssim_fwd, ssim_bwd)."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.data.indexing import RandomIterIdx
    from pssr2_tpu_torch.data.pipeline import PatchLoader
    from pssr2_tpu_torch.optim import AdamW

    state, gen_pair, loss_fn, build = _train_parts(seed)
    step, _ = build(loss_fn, False, gen_pair)
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    n_layers = sum(e + p for *_, e, p in layer_shapes())
    per_step = (n_layers, 2 * n_layers, 1, 2)  # convchain fwd, bwd (2 launches a layer), SSIM fwd, bwd
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = _model(state, dtype, device)
        optimizer = AdamW(LR_RATE).init(model.parameters())
        loader = PatchLoader(dataset, RandomIterIdx(range(len(dataset)), rng=np.random.default_rng(seed)), BATCH)
        times, losses, k = [], [], 0
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(TRAIN_EPOCHS):
            for batch, n_valid in loader:
                hr_u8 = torch.from_numpy(batch).to(device)
                generator = torch.Generator(device=device).manual_seed(1000 * seed + k)
                before = _counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                loss, _, _ = step(model, optimizer, hr_u8, None, generator, LR_RATE, n_valid, False)
                losses.append(loss.item())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - start)
                delta = tuple(a - b for a, b in zip(_counts(), before))
                if delta != per_step or not np.isfinite(losses[-1]):
                    raise RuntimeError(f"step {k}: launches {delta} (want {per_step}), loss {losses[-1]}")
                k += 1
        # one more step with the metrics: a second SSIM forward
        before = _counts()
        loss, (mse, ssim_val), _ = step(model, optimizer, hr_u8, None, generator, LR_RATE, n_valid, True)
        delta = tuple(a - b for a, b in zip(_counts(), before))
        want = (per_step[0], per_step[1], 2, 2)
        values = [loss.item(), mse.item(), ssim_val.item()]
        if delta != want or not np.isfinite(values).all():
            raise RuntimeError(f"metrics step: launches {delta} (want {want}), loss, mse, ssim {values}")
        launches[dtype] = _counts()
        steady = sum(times[1:]) / len(times[1:])
        print(
            f"phase training {dtype}: {k} steps + 1 with metrics at batch {BATCH} ({hr_res}^2 HR, "
            f"{LR_RES}^2 LR) on {card}: steady step {1e3 * steady:.2f} ms = {BATCH / steady:.2f} patches/s "
            f"(steps after the first: " + ", ".join(f"{1e3 * t:.2f}" for t in times[1:]) + f" ms; first "
            f"{1e3 * times[0]:.2f} ms); losses " + ", ".join(f"{v:.6f}" for v in losses)
            + f"; metrics step loss {values[0]:.6f} mse {values[1]:.6g} ssim {values[2]:.6f}; launches per step "
            f"{per_step} (convchain fwd, bwd, SSIM fwd, bwd), whole run {launches[dtype]}"
        )
    return launches


def _step_diff(a, b):
    """Differences of train-step run ``a`` from run ``b``, each (loss,
    grads, state after the step)."""
    (loss_a, grads_a, after_a), (loss_b, grads_b, after_b) = a, b
    grad, worst, num, den = 0.0, "", 0.0, 0.0
    for name, gb in grads_b.items():
        num += float((grads_a[name] - gb).double().square().sum())
        den += float(gb.double().square().sum())
        scale = gb.abs().max().item()
        if scale == 0.0:  # the ResBlock conv biases under train-mode BatchNorm
            if grads_a[name].any() or not re.fullmatch(r"(en|de)coder\.\d+\.conv\.\d+\.bias", name):
                raise RuntimeError(f"{name}: zero gradient in one run, {grads_a[name].abs().max()} in the other")
            continue
        err = (grads_a[name] - gb).abs().max().item() / scale
        if err > grad:
            grad, worst = err, name
    param, moved, n_elem, stat = 0.0, 0, 0, 0.0
    for name, ref in after_b.items():
        diff = (after_a[name] - ref).abs()
        if "running" in name:
            stat = max(stat, diff.max().item() / ref.abs().max().item())
        else:
            param = max(param, diff.max().item())
            moved += int((diff > LR_RATE / 2).sum())
            n_elem += ref.numel()
    return {"loss": abs(loss_a - loss_b), "grad": grad, "grads": (num / den) ** 0.5, "moved": moved / n_elem,
            "param": param, "stat": stat}, worst


def compare_cpu_step(device, seed, root):
    """Phase 5b: one f32 train step on 2 samples on the card against the
    same step on the CPU (plain versions), from the same weights and the
    same (hr, lr) pair, within STEP_TOL and SELF_FACTOR times the CPU's own
    change under a PERTURB perturbation of the weights."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.optim import AdamW

    state, gen_pair, loss_fn, build = _train_parts(seed)
    step, _ = build(loss_fn, False, None)
    dataset = ImageDataset(root, hr_res=LR_RES * SCALE, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    hr_u8 = torch.from_numpy(np.stack([dataset.hr_patch(i) for i in range(2)])).to(device)
    with torch.no_grad():
        hr, lr = gen_pair(torch.Generator(device=device).manual_seed(seed), hr_u8, True)
    noise = torch.Generator().manual_seed(seed + 1)
    perturbed = {k: v * (1 + PERTURB * torch.randn(v.shape, generator=noise)) if v.is_floating_point() else v
                 for k, v in state.items()}
    cpu = torch.device("cpu")
    runs, secs = [], []
    for dev, weights, pair in ((device, state, (hr, lr)), (cpu, state, (hr.cpu(), lr.cpu())),
                               (cpu, perturbed, (hr.cpu(), lr.cpu()))):
        model = _model(weights, None, dev)
        optimizer = AdamW(LR_RATE).init(model.parameters())
        start = time.perf_counter()
        loss, _, _ = step(model, optimizer, pair, None, None, LR_RATE, 2, False)
        runs.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {k: v.cpu() for k, v in model.state_dict().items()}))
        secs.append(time.perf_counter() - start)
    got, worst = _step_diff(runs[0], runs[1])
    own, _ = _step_diff(runs[2], runs[1])
    limits = dict(STEP_TOL, **{k: SELF_FACTOR * own[k] for k in ("grad", "grads", "moved")})
    print(
        f"phase training f32 card vs CPU, 1 step on 2 samples: loss {runs[0][0]:.7f} vs {runs[1][0]:.7f}; "
        + ", ".join(f"{k} {v:.3g} <= {limits[k]:.3g}" for k, v in got.items())
        + f" (largest gradient error in {worst}); the CPU against itself with weights perturbed by {PERTURB:g}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in own.items())
        + f"; card step {secs[0]:.2f} s, CPU steps {secs[1]:.1f} s, {secs[2]:.1f} s"
    )
    bad = {k: v for k, v in got.items() if not v <= limits[k]}
    if bad:
        raise RuntimeError(f"card train step differs from the CPU: {bad}")


def kernels_line(fwd, bwd, ssim, serving, training):
    """The per-kernel entries of the JSON line.  Launches are counted over
    the main paths: serving and training for the convchain forward,
    training for the others (both dtypes for the f32 SSIM)."""
    entries = []
    for name, totals, line, launches in (
        ("convchain_fwd", fwd, 185, {dt: serving[dt] + training[dt][0] for dt in fwd}),
        ("convchain_bwd", bwd, 277, {dt: training[dt][1] for dt in bwd}),
    ):
        for dtype, tot in totals.items():
            entries.append((f"{name}[{str(dtype)[6:]}]", "convchain" if name.endswith("fwd") else "convchain_bwd",
                            f"convchain.py:{line}", launches[dtype],
                            dict(tot, bound_by=max(tot["bound_by"], key=tot["bound_by"].get))))
    for name, line, i in (("ssim_fwd", 239, 2), ("ssim_bwd", 254, 3)):
        entries.append((name, "ssimfused", f"ssimfused.py:{line}", sum(c[i] for c in training.values()), ssim[name]))
    kernels = []
    for name, source, replaces, launches, tot in entries:
        if launches == 0:
            raise RuntimeError(f"{name} was launched no time on the main paths")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pssr2_tpu_torch/csrc/{source}.cu",
            "replaces": f"pssr2_tpu/ops/pallas/{replaces}",
            "launches": launches,
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"],
        })
    return kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from pssr2_tpu_torch.ops import cuda_build  # fails where the script stands alone

    device = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {card}, count {torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(smi)

    start = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    print(f"phase build: {', '.join(f'{n}.cu' for n in SOURCES)} in {time.perf_counter() - start:.2f} s")
    for name, (_, secs, log) in builds.items():
        print(f"  {name}.cu: nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())

    gen = torch.Generator(device=device).manual_seed(args.seed)
    fwd = check_kernels(device, gen)
    bwd = check_bwd(device, gen)
    ssim = check_ssim(device, gen)
    with tempfile.TemporaryDirectory(prefix="pssr2_smoke_") as tmp:
        root = Path(tmp, "hr")
        root.mkdir()
        write_tiles(root, args.seed)
        serving = run_slice(device, args.seed, card, root, tmp)
        training = run_train(device, args.seed, card, root)
        compare_cpu_step(device, args.seed, root)

    print(json.dumps({"kernels": kernels_line(fwd, bwd, ssim, serving, training)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
