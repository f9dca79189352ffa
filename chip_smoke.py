#!/usr/bin/env python3
"""Smoke run of pssr2_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--seed S]

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the CUDA kernel sources are compiled with nvcc, all at once
   (seconds, registers and spills printed); then the SASS of the libraries
   with tensor-core kernels, convchain, rdtail and swinblock
   (``cuobjdump``): each kernel's HGMMA (wgmma), HMMA (mma.sync) and FFMA
   count beside its registers, shared memory and local bytes, failing if
   cuobjdump is missing, a tensor-core kernel (a name with ``_tc_``) has no
   HGMMA, a tensor-core Swin-block kernel uses local memory, or an f32
   CUDA-core kernel (``_f32_`` or ``gemm_jobs`` in its name: the convchain
   and rdtail backwards and the rdtail forward on ``csrc/f32gemm.cuh``, and
   every launch of the Swin block's CUDA-core backward) has no FFMA, any
   HGMMA or HMMA, or local memory;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it, with times (CUDA events), its bound
   and a library yardstick: the convchain forward and backward at every
   distinct ResBlock layer shape of the full-width ResUNet x4 at batch 16,
   in f32 and bf16, with the prologue on and off; the SSIM kernels at the
   shapes of one MS-SSIM loss at batch 16 (level 0 at 512^2 with the divide
   by 255, the pool levels at 256^2, 128^2 and 64^2, the last level at
   32^2), the single-scale SSIM at 512^2 and at windows 7 and 15, and one
   bf16 ssim call, which takes the band-matrix path; the convchain shapes
   include the RDResUNet decoder's, and the f32 backward's dx and dW
   launches are timed apart (device time, ``torch.profiler``); the RDNet
   block tail forward and
   backward at the 21 dense blocks' shapes of the full-width RDResUNet x4
   at batch 16, in f32 and bf16 (every bf16 one on the tensor-core route,
   each shape's route and TFLOP/s printed; a torch.profiler trace of one
   f32 forward must show the port's kernels alone); the f32 CUDA-core
   backward kernels and the rdtail forward also at ragged shapes
   (``RAGGED_CONV``, ``RAGGED_TAILS``); the whole Swin block forward
   (eval and with DropPath keep-scales) and backward (DropPath and eval) at
   the default SwinIR's blocks at batch 16 ((16, 128, 128, 96), unshifted
   and shifted), in f32 (CUDA cores; a profiler trace of one backward must
   show the port's kernels alone) and bf16 (tensor cores; route, plan and
   TFLOP/s printed, and the tensor-core launches counted), and the CUDA-core
   backward at ragged blocks (``RAGGED_SWIN``, f32 and bf16, both shifts,
   eval and DropPath); the window attention at those windows (4,096 x 64 x 288) and at
   the SwinIR-L widths (C 240, 8 heads), masked and unmasked; the soft
   histogram forward and backward at the learned crappifier's (16, 16384)
   x 512 and at a ragged value count; the BatchNorm dual sums at one
   ResUNet training step's shapes, f32 and bf16; the int8 conv layer at
   every distinct int8 conv shape of the int8 ResUNet() and RDResUNet()
   decoder at batch 16, with the int8 and both glue epilogues, bit for bit;
4. serving: ``predict_images`` with the full-width ``ResUNet()`` x4 on 32
   synthetic 128^2 -> 512^2 tiles in f32 and bf16, twice (the first call
   with cuDNN set-up, the second warm), with the kernels' launch counts
   read around each call, and two f32 tiles held against the
   same model on the CPU (plain versions); then the same with the
   full-width ``RDResUNet()`` x4, one f32 tile held against the CPU; then
   the full-width ``SwinIR()`` x4 (16 whole-block launches a forward), one
   f32 tile held against the CPU, and a third call per dtype traced by
   ``torch.profiler`` (device busy and idle over the whole call); then a
   model of the SwinIR-L widths (embed 240, 8 heads, '3conv',
   'nearest+conv', 2 x 2 blocks) through the window-attention kernel, one
   call per dtype, one f32 tile held against the CPU; then the full-width
   ResUNet() and RDResUNet() quantized to int8 (calibrated on the 32 tiles)
   in f32 and bf16 glue, two calls each, every int8 conv through the
   q8chain kernel (and RDResUNet's float encoder through rdtail), launches
   checked, the distance from the float model printed, one f32-glue tile
   held against the same executor on the CPU;
5. training: the full-width ``ResUNet()`` in train mode, a few steps in
   bf16 and in f32 on 512^2 uint8 patches from ``PatchLoader`` at batch 16
   (device augment, downscale, Poisson noise; ``SSIMLoss(mix=0.8,
   ms=True)``; AdamW), with the launch counts checked per step and one more
   step per dtype traced by ``torch.profiler`` (device time by kernel
   group, busy share, top kernels), then one
   f32 step on 2 samples held against the same step on the CPU; then the
   same steps with the full-width ``RDResUNet()`` (one step per dtype
   traced) and ``SwinIR()`` (DropPath live, 16 whole-block forwards and 32 backward
   launches a step, bf16's counted apart on the tensor cores, and one more
   step per dtype traced);
6. train_paired: the full-width ResUNet in bf16 compute, batch 16, over
   the 32 tiles with validation, a ReduceLROnPlateau, weight checkpoints
   and a state directory, for 2 epochs, then resumed by a second call to
   3, with the epoch times and every kernel's launches checked; then the
   full-width RDResUNet and SwinIR in bf16 for 2 epochs in one call each,
   the same way;
7. train_crappifier: the full-width ResUNet(scale=1) as a learned
   crappifier (soft-histogram loss times the SSIM of the noise profiles)
   over the 32 tiles at batch 16, 2 epochs in bf16 and 1 in f32, with every
   kernel's launches checked (convchain, SSIM, BatchNorm sums, soft
   histogram), then one f32 step on 2 samples held against the CPU;
8. approximate_crappifier on the host (no kernel), a few objective calls.

Every ResUNet and RDResUNet training step also launches the chanstats
kernel: its train-mode BatchNorm sums.

The last two lines are a JSON line of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  This script imports nothing of
JAX and nothing of the JAX package.
"""

import argparse
import functools
import json
import re
import shutil
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
SOURCES = ("convchain", "convchain_bwd", "ssimfused", "rdtail", "swinblock", "gradhist", "chanstats", "q8chain")
# The f32 card output against the same model on the CPU, on the [0, 255]
# scale: only the order of f32 summation differs, through 45 layers
# (ResUNet) or 21 dense blocks and 16 decoder layers (RDResUNet).
CPU_TOL = 0.05
RD_EPS = 1e-6  # the RDNet LayerNorms' epsilon
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
# bf16 ssim (band path) against the f32 kernel on the same maps, unit scale:
# the five moments round to 8 bits (an ulp at 1 is 0.0039) before E[x^2] -
# E[x]^2; on the CPU the mean moved by 7e-4 at such maps.
BF16_SSIM_TOL = 0.02
# train_paired: epochs of the first call, then of the resumed second call,
# and the share of the TILES held out for validation (8 of 32: one partial
# validation batch, and 24 training patches, 2 steps an epoch)
TP_EPOCHS, TP_VAL_SPLIT = (2, 3), 0.25
# and RDResUNet's and SwinIR's: one call of 2 epochs (train_paired writes a
# weight checkpoint after each epoch but the last)
RD_TP_EPOCHS = (2,)
STEP_TOL = {"loss": 1e-4, "param": 2.001 * LR_RATE, "stat": 1e-3}
# The default SwinIR's blocks (embed 96, 6 heads of 16, 8 x 8 windows, MLP
# 192; 16 blocks, every second one shifted by 4 and masked), the LayerNorm
# epsilon, and the SwinIR-L widths served through the window attention
# (the authors' real-world large model, 2 x 2 blocks instead of 9 x 6)
SWIN_C, SWIN_HEADS, SWIN_WS, SWIN_HIDDEN, SWIN_BLOCKS, SWIN_EPS = 96, 6, 8, 192, 16, 1e-6
SWINL = dict(embed_dim=240, depths=[2, 2], num_heads=[8, 8], window_size=8, mlp_ratio=2, resi_connection="3conv",
             upsampler="nearest+conv")


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


def rd_shapes():
    """The full-width RDResUNet x4 at batch BATCH: [(cin, cout, res, n_entry,
    n_prologue)] of its decoder's ResBlock 3x3 layers in one forward, as
    :func:`layer_shapes`, and [(m, c, inter, g)] of its dense blocks' tails
    (rows, input, hidden and output channels), one per block."""
    from pssr2_tpu_torch.models import RDResUNet

    model = RDResUNet(device="meta")
    res, tails = LR_RES // model.ratios[-1], []
    for i, stage in enumerate(model.encoder.dense_stages):
        res //= 2 if model.encoder.ds_blocks[i] else 1
        for block in stage[-1].children():
            layers = block.layers.layers
            tails.append((BATCH * res * res, layers[0].in_channels, layers[2].out_channels, layers[4].out_channels))
    convs = {}
    for i, block in enumerate(model.decoder):
        cin, cout = block.conv[0].in_channels, block.conv[0].out_channels
        for key, count in (((cin, cout, res << i), (1, 0)), ((cout, cout, res << i), (0, block.n_layers - 1))):
            e, p = convs.get(key, (0, 0))
            convs[key] = (e + count[0], p + count[1])
    return [(*k, *v) for k, v in convs.items()], tails


def conv_shapes():
    """{(cin, cout, res): {model: (n_entry, n_prologue)}} over both models'
    ResBlock layers."""
    out = {}
    for name, shapes in (("ResUNet", layer_shapes()), ("RDResUNet", rd_shapes()[0])):
        for cin, cout, res, e, p in shapes:
            out.setdefault((cin, cout, res), {})[name] = (e, p)
    return out


def _new_totals():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0, "ops": 0.0,
            "bound_by": {}, "layers": 0}


def _add(tot, count, k_ms, p_ms, lib_ms, b_ms, b_by, ops, err):
    tot["ms"] += count * k_ms
    tot["plain_ms"] += count * p_ms
    tot["library_ms"] += count * lib_ms
    tot["bound_ms"] += count * b_ms
    tot["ops"] += count * ops
    tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0.0) + count * b_ms
    tot["max_abs_err"] = max(tot["max_abs_err"], err)
    tot["layers"] += count


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


# The libraries whose bf16 kernels run on the tensor cores; a kernel of
# theirs is a tensor-core one exactly when its name holds "_tc_"
TC_LIBS = ("convchain", "convchain_bwd", "rdtail", "swinblock")


def _kernel_label(mangled):
    """convchain_tc_fwd_kernel<2,128,1> from the mangled name."""
    m = re.search(r"\d((?:convchain|rdtail|swin|gemm_jobs)\w*?_kernel)(?:I(\w*?)E)?E", mangled)
    if not m:
        return mangled[:60]
    targs = m.group(2) or ""
    args = ["float"] if targs.startswith("f") else ["bf16"] if "bfloat16" in targs else []
    args += re.findall(r"L[ib](\d+)E", targs + "E")
    return f"{m.group(1)}<{','.join(args)}>" if m.group(2) is not None else m.group(1)


def _f32_core(name):
    """Whether a kernel is one of the f32 CUDA-core kernels: on
    csrc/f32gemm.cuh, or the Swin block backward's attention and
    LayerNorm launches."""
    return "_f32_" in name or "gemm_jobs" in name


def check_sass(builds):
    """Phase 2b: each kernel of TC_LIBS with its count of HGMMA (wgmma),
    HMMA (mma.sync) and FFMA instructions in the SASS, its registers, shared
    memory (static) and local (spill) bytes (``cuobjdump -sass`` and
    ``-res-usage``).  Fails if cuobjdump is missing, a library has no
    tensor-core kernel, a tensor-core kernel has no HGMMA, a tensor-core
    Swin-block kernel uses local memory, or an f32 CUDA-core kernel
    (:func:`_f32_core`) has no FFMA, a tensor-core instruction of any kind
    (no TF32 crept in) or local memory."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the SASS of the tensor-core kernels cannot be checked")
    print("phase sass: convchain, rdtail and swinblock kernels, tensor-core and FFMA instructions (cuobjdump -sass) "
          "| REG, static SHARED, LOCAL (cuobjdump -res-usage)")
    for lib in TC_LIBS:
        path = str(builds[lib][0])
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300, check=True).stdout
        res = subprocess.run([tool, "-res-usage", path], capture_output=True, text=True, timeout=300,
                             check=True).stdout
        usage = {m.group(1): m.groups()[1:] for m in re.finditer(
            r"Function (\S+?):?\s*\n\s*REG:(\d+) STACK:\d+ SHARED:(\d+) LOCAL:(\d+)", res)}
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                counts[current] = [0, 0, 0]
            elif current is not None:
                counts[current][0] += len(re.findall(r"\bHGMMA\b", line))
                counts[current][1] += len(re.findall(r"\bHMMA\b", line))
                counts[current][2] += len(re.findall(r"\bFFMA\b", line))
        tc = [k for k in counts if "_tc_" in k]
        if not tc:
            raise RuntimeError(f"{lib}: no tensor-core kernel in the SASS")
        for name, (hgmma, hmma, ffma) in sorted(counts.items(), key=lambda kv: _kernel_label(kv[0])):
            reg, shared, local = usage.get(name, ("?", "?", "?"))
            bad = "_tc_" in name and hgmma == 0
            spills = ("_tc_" in name and "swin" in name or _f32_core(name)) and local != "0"
            not_f32 = _f32_core(name) and (ffma == 0 or hgmma or hmma)
            print(f"  {lib}.cu {_kernel_label(name):36s} HGMMA {hgmma:4d} HMMA {hmma:4d} FFMA {ffma:5d} | REG {reg} "
                  f"SHARED {shared} LOCAL {local}" + ("  <-- NO HGMMA" if bad else "")
                  + ("  <-- LOCAL MEMORY" if spills else "") + ("  <-- NOT ON THE FMA UNITS" if not_f32 else ""))
            if bad:
                raise RuntimeError(f"{name}: a tensor-core kernel without HGMMA")
            if spills:
                raise RuntimeError(f"{name}: a kernel that must not spill has local memory ({local} bytes)")
            if not_f32:
                raise RuntimeError(f"{name}: an f32 CUDA-core kernel with FFMA {ffma}, HGMMA {hgmma}, HMMA {hmma}")


# Kernel-name fragments of the device-time groups that profile_device sums
KERNEL_GROUPS = (("swinblock fwd", ("swin_tc_fwd", "swin_fwd")), ("swinblock bwd rows (tensor cores)", ("swin_tc_rows",)),
                 ("swinblock bwd dW (tensor cores)", ("swin_tc_dw",)),
                 ("swinblock f32 bwd token products", ("swin_f32_tok",)),
                 ("swinblock f32 bwd MLP rows", ("swin_f32_mlp",)),
                 ("swinblock f32 bwd attention fwd", ("swin_f32_attn_fwd",)),
                 ("swinblock f32 bwd attention bwd", ("swin_f32_attn_bwd",)),
                 ("swinblock f32 bwd LayerNorms", ("swin_f32_ln",)), ("winattn", ("swin_winattn",)),
                 ("ssimfused", ("ssim_",)), ("convchain fwd", ("convchain_tc_fwd", "convchain_fwd")),
                 ("convchain bwd dx", ("convchain_tc_dx", "convchain_f32_dx")),
                 ("convchain bwd dW", ("convchain_tc_dw", "convchain_f32_dw")),
                 ("rdtail fwd (tensor cores)", ("rdtail_tc_fwd",)), ("rdtail f32 fwd fc1", ("rdtail_f32_fc1",)),
                 ("rdtail f32 fwd fc2", ("rdtail_f32_fc2",)),
                 ("rdtail bwd rows", ("rdtail_tc_rows", "rdtail_f32_rows")),
                 ("rdtail bwd GEMMs (tensor cores: dh, dW)", ("rdtail_tc_dh", "rdtail_tc_dw")),
                 ("f32 GEMM launch (rdtail dh, dW; swinblock dW)", ("gemm_jobs",)),
                 ("rdtail LayerNorms (f32 fwd and bwd rows, bwd)", ("rdtail_ln_bwd", "rdtail_f32_ln")),
                 ("chanstats", ("dual_sums",)),
                 ("cuDNN / cuBLAS", ("cudnn", "conv", "gemm", "xmma", "cutlass", "sm90", "sm80", "fft", "winograd",
                                     "flip_filter", "complex", "region_transform", "wgrad", "dgrad", "fprop")))


def profile_device(fn, label):
    """One call of ``fn`` under torch.profiler (CUDA activity): the device
    time of each kernel group and of the rest (PyTorch's elementwise,
    reduction and copy kernels), their sum against the host wall time of
    the call (the device's busy share; idle is the rest), the 4 largest
    kernels and the 3 largest of the rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    if not kernels:
        print(f"  profile {label}: the profiler recorded no device time (not measured)")
        return
    groups, rest = {}, {}
    for name, ms in kernels.items():
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name.lower() for k in keys)), "other PyTorch kernels")
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other PyTorch kernels":
            rest[name] = ms
    busy = sum(kernels.values())

    def largest(d, k):
        return ", ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in sorted(d.items(), key=lambda kv: -kv[1])[:k])

    print(f"  profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%); by group: "
          + ", ".join(f"{g} {ms:.2f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
          + f"; largest: {largest(kernels, 4)}; largest of the rest: {largest(rest, 3)}")


def device_split_ms(fn, groups, reps=5):
    """Device time of one call of ``fn`` by kernel group ({label: name
    fragments}), from torch.profiler over ``reps`` calls after a warm one;
    None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, seen = dict.fromkeys(groups, 0.0), False
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            seen = True
            label = next((g for g, keys in groups.items() if any(k in evt.key for k in keys)), None)
            if label is not None:
                out[label] += evt.self_device_time_total / 1e3 / reps
    return out if seen else None


# Kernel-name fragments of the port's own kernels, and of PyTorch's fill and
# copy kernels (a wrapper's torch.zeros and dtype conversions)
PORT_KERNELS = ("swin_", "rdtail_", "convchain_", "gemm_jobs", "ssim_", "dual_sums", "gradhist", "q8_")
GLUE_KERNELS = ("fillfunctor", "copy_kernel", "direct_copy")


def check_port_only(fn, label):
    """One call of ``fn`` under torch.profiler: fails unless every device
    kernel is one of the port's (PORT_KERNELS) or PyTorch's fill and copy
    kernels (GLUE_KERNELS): no cuBLAS, cuDNN or SDPA kernel.  Prints the
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {evt.key for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0}
    if not names:
        print(f"  trace {label}: the profiler recorded no device time (not checked)")
        return
    other = sorted(n for n in names if not any(k in n.lower() for k in PORT_KERNELS + GLUE_KERNELS))
    print(f"  trace {label}: {len(names)} kernels, none from a library" if not other else
          f"  trace {label}: LIBRARY KERNELS {other}")
    print("    " + "; ".join(sorted(n[:70] for n in names)))
    if other:
        raise RuntimeError(f"{label} ran kernels that are not the port's: {other}")


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


def ssim_bound_ms(b, h, w, backward, win=11, pool=False, l0=False):
    """Bound of an SSIM kernel (f32) on (b, h, w) maps with a ``win``-tap
    window.  Bytes: x, y read and the sums per image written (forward), or
    x, y and the cotangents read and gx, gy written (backward); the pooled
    maps written (forward) or their cotangents read (backward) with
    ``pool``.  Operations: the three products per pixel, the separable blur
    of five maps (horizontal over H x W', vertical over H' x W', 2 a tap)
    and about 19 of map arithmetic and sums per VALID pixel; the backward
    adds about 30 per VALID pixel for the four maps, their transposed blur
    (horizontal over H' x W, vertical over H x W) and 8 per pixel for gx
    and gy.  ``pool`` adds 7 per pooled pixel for each of x, y (forward) or
    2 per pixel for each of gx, gy (backward); ``l0`` adds the two divides
    per pixel, and the L1 term: 5 per pixel (forward), 6 (backward), plus
    the two divides of gx, gy."""
    hp, wp = h - win + 1, w - win + 1
    ops = 3 * h * w + 2 * 5 * win * (h * wp + hp * wp) + 19 * hp * wp
    if backward:
        ops += 11 * hp * wp + 2 * 4 * win * (hp * w + h * w) + 8 * h * w
    nbytes = 4 * b * h * w * (4 if backward else 2) + 4 * 2 * b
    if pool:
        ops += 4 * h * w if backward else 2 * 7 * (h // 2) * (w // 2)
        nbytes += 4 * b * 2 * (h // 2) * (w // 2)
    if l0:
        ops += 2 * h * w + (8 if backward else 5) * h * w
        nbytes += 4 * b
    return bound(nbytes, float(b * ops), torch.float32)


def _conv_inputs(device, gen, dtype, cin, cout, res):
    x = torch.randn(BATCH, res, res, cin, device=device, generator=gen).to(dtype)
    weight = torch.randn(cout, cin, 3, 3, device=device, generator=gen) / (3 * cin**0.5)
    bias = 0.1 * torch.randn(cout, device=device, generator=gen)
    ab = torch.stack([
        torch.rand(cin, device=device, generator=gen) + 0.5,
        0.3 * torch.randn(cin, device=device, generator=gen),
    ])
    return x, weight, bias, ab


def _print_totals(what, dtype, totals, library):
    for model, tot in totals.items():
        print(
            f"  {dtype}: one {what} of {model}'s {tot['layers']} ResBlock layers at batch {BATCH}: kernel "
            f"{tot['ms']:.3f} ms ({tot['ops'] / tot['ms'] / 1e9:.2f} TFLOP/s), plain {tot['plain_ms']:.3f} ms, "
            f"{library} {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms"
        )


def check_kernels(device, gen):
    """Phase 3a: the convchain forward kernel against reference_layer at
    every layer shape of both models; returns per-dtype, per-model totals
    over one forward."""
    from pssr2_tpu_torch.ops import convchain

    totals = {}
    print(
        f"phase kernels: convchain_fwd vs plain (batch {BATCH}): max abs error (relative) <= bound "
        "for y, s1, s2 | ms of kernel, plain, F.conv2d (conv alone) | layers a forward per model"
    )
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"ResUNet": _new_totals(), "RDResUNet": _new_totals()}
        for (cin, cout, res), per_model in conv_shapes().items():
            x, weight, bias, ab = _conv_inputs(device, gen, dtype, cin, cout, res)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as cuDNN takes it
            w_dt, b_dt = weight.to(dtype), bias.to(dtype)
            lib_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_dt, b_dt, padding=1))
            b_ms, b_by = bound_ms(BATCH, res, cin, cout, dtype)
            for prologue in (False, True):
                counts = {m: c[int(prologue)] for m, c in per_model.items()}
                if not any(counts.values()):
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
                    f"  {str(dtype)[6:]:8s} {cin:4d}->{cout:4d} @{res:3d} prologue={int(prologue)} {counts}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), kernel "
                    f"{2.0 * BATCH * res * res * 9 * cin * cout / k_ms / 1e9:.1f} TFLOP/s"
                    + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"convchain_fwd disagrees with its plain version: {errs}")
                for m, count in counts.items():
                    _add(tot[m], count, k_ms, p_ms, lib_ms, b_ms, b_by, 2.0 * BATCH * res * res * 9 * cin * cout,
                         errs["y"][0])
        totals[dtype] = tot
        _print_totals("forward", dtype, tot, "F.conv2d")
    return totals


def check_bwd(device, gen):
    """Phase 3b: the convchain backward kernels against reference_layer_bwd
    at every layer shape of both models, with the prologue on and off, fed
    the weight layout the autograd forward keeps for them
    (``convchain.bwd_weight``); the f32 dx and dW launches also timed apart
    (device time, torch.profiler); returns per-dtype, per-model totals over
    one backward (each shape weighted by how often the model runs it)."""
    from pssr2_tpu_torch.ops import convchain

    totals = {}
    print(
        f"phase kernels: convchain_bwd (2 launches) vs plain (batch {BATCH}): max abs error (relative) "
        "<= bound for dx, dW, dbias, d(a, b) | ms of kernel, plain, conv2d_input + conv2d_weight"
    )
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"ResUNet": _new_totals(), "RDResUNet": _new_totals()}
        split_tot = {"ResUNet": {"dx": 0.0, "dW": 0.0}, "RDResUNet": {"dx": 0.0, "dW": 0.0}}
        for (cin, cout, res), per_model in conv_shapes().items():
            x, weight, bias, ab = _conv_inputs(device, gen, dtype, cin, cout, res)
            gy = torch.randn(BATCH, res, res, cout, device=device, generator=gen).to(dtype)
            gs1 = 0.01 * torch.randn(cout, device=device, generator=gen)
            gs2 = 0.01 * torch.randn(cout, device=device, generator=gen)
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # channels-last memory
            w_dt = weight.to(dtype)
            wkb = convchain.bwd_weight(weight, dtype)  # made by the forward, kept for the backward

            def library():
                torch.nn.grad.conv2d_input(x_nchw.shape, w_dt, g_nchw, padding=1)
                torch.nn.grad.conv2d_weight(x_nchw, w_dt.shape, g_nchw, padding=1)

            lib_ms = cuda_ms(library)
            for prologue in (False, True):
                counts = {m: c[int(prologue)] for m, c in per_model.items()}
                a = ab if prologue else None
                b_ms, b_by = bwd_bound_ms(BATCH, res, cin, cout, dtype, prologue)
                split = None
                with torch.no_grad():
                    y, _, _ = convchain.fused_conv_layer(x, weight, bias, a)
                    args = (x, weight, y, gy, gs1, gs2, a)
                    got = convchain._launch_bwd(*args, wkb)
                    ref = convchain.reference_layer_bwd(*args)
                    torch.cuda.synchronize()
                    errs = convchain.bwd_errors(got, ref)
                    k_ms = cuda_ms(lambda: convchain._launch_bwd(*args, wkb))
                    p_ms = cuda_ms(lambda: convchain.reference_layer_bwd(*args))
                    if dtype == torch.float32 and any(counts.values()):
                        split = device_split_ms(lambda: convchain._launch_bwd(*args, wkb),
                                                {"dx": ("convchain_f32_dx",), "dW": ("convchain_f32_dw",)})
                ok = all(err <= lim for err, _, lim in errs.values())
                print(
                    f"  {str(dtype)[6:]:8s} {cin:4d}->{cout:4d} @{res:3d} prologue={int(prologue)} {counts}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {k_ms:.4f} {p_ms:.4f} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), kernel "
                    f"{4.0 * BATCH * res * res * 9 * cin * cout / k_ms / 1e9:.1f} TFLOP/s"
                    + ("" if split is None else f"; device dx {split['dx']:.4f} ms, dW {split['dW']:.4f} ms")
                    + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"convchain_bwd disagrees with its plain version: {errs}")
                for m, count in counts.items():
                    _add(tot[m], count, k_ms, p_ms, lib_ms, b_ms, b_by,
                         2 * 2.0 * BATCH * res * res * 9 * cin * cout, max(e for e, _, _ in errs.values()))
                    if split is not None:
                        split_tot[m]["dx"] += count * split["dx"]
                        split_tot[m]["dW"] += count * split["dW"]
        totals[dtype] = tot
        _print_totals("backward", dtype, tot, "conv2d_input + conv2d_weight")
        if dtype == torch.float32:
            for m, sp in split_tot.items():
                print(f"  {dtype}: one backward of {m}'s {tot[m]['layers']} ResBlock layers, device time: dx "
                      f"{sp['dx']:.3f} ms, dW {sp['dW']:.3f} ms" if sp["dx"] else
                      f"  {dtype}: {m}'s dx / dW device split: not measured (the profiler recorded no device time)")
    return totals


# Ragged shapes of the f32 CUDA-core backward kernels' tiles: convchain
# (N, H, W, Cin, Cout) with one and three input channels, 96 outputs, 8 x 8
# and 13 x 13 images; RDNet tails (M, C, inter, G) with M off the 128-row
# tile and widths off the column tiles, two with no width a multiple of 8
# (the bf16 CUDA-core route)
RAGGED_CONV = [(2, 8, 8, 1, 96), (2, 13, 13, 3, 96), (2, 13, 13, 1, 96), (2, 8, 8, 3, 96)]
RAGGED_TAILS = [(4097, 232, 928, 104), (300, 40, 160, 24), (4097, 229, 925, 101), (300, 37, 157, 21)]
# Swin blocks (B, H, W, C, heads, ws, hidden) of the CUDA-core backward, off
# the tensor-core route in bf16 too: M off the 128-row tiles, C and hidden
# off 16, heads of 12, 10 and 30 channels, windows of 8 x 8, 5 x 5, 6 x 6
RAGGED_SWIN = [(3, 40, 40, 72, 6, 8, 150), (2, 20, 20, 40, 4, 5, 100), (1, 24, 24, 120, 4, 6, 200)]


def check_ragged(device, gen):
    """Phase 3c: the f32 CUDA-core backward kernels against their plain
    versions at RAGGED_CONV (prologue on and off) and RAGGED_TAILS (f32, and
    bf16 where the route is the CUDA cores'; the rdtail forward there too),
    under the unchanged tolerances."""
    from pssr2_tpu_torch.ops import convchain, rdtail

    print("phase kernels: f32 CUDA-core backward kernels vs plain at ragged shapes: max abs error <= bound")
    for n, h, w, cin, cout in RAGGED_CONV:
        x = torch.randn(n, h, w, cin, device=device, generator=gen)
        weight = torch.randn(cout, cin, 3, 3, device=device, generator=gen) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, device=device, generator=gen)
        ab = torch.stack([torch.rand(cin, device=device, generator=gen) + 0.5,
                          0.3 * torch.randn(cin, device=device, generator=gen)])
        gy = torch.randn(n, h, w, cout, device=device, generator=gen)
        gs1, gs2 = (0.01 * torch.randn(cout, device=device, generator=gen) for _ in range(2))
        for a in (None, ab):
            with torch.no_grad():
                y, _, _ = convchain.fused_conv_layer(x, weight, bias, a)
                args = (x, weight, y, gy, gs1, gs2, a)
                errs = convchain.bwd_errors(convchain._launch_bwd(*args), convchain.reference_layer_bwd(*args))
            torch.cuda.synchronize()
            ok = all(e <= lim for e, _, lim in errs.values())
            print(f"  convchain_bwd float32 {(n, h, w, cin, cout)} prologue={int(a is not None)}: "
                  + " ".join(f"{k} {e:.3g} <= {b:.3g}" for k, (e, _, b) in errs.items()) + ("" if ok else "  <-- DISAGREES"))
            if not ok:
                raise RuntimeError(f"convchain_bwd disagrees at {(n, h, w, cin, cout)}: {errs}")
    for m, c, inter, g in RAGGED_TAILS:
        for dtype in (torch.float32, torch.bfloat16):
            route = rdtail.route(c, inter, g, dtype)
            if route != "cuda_core":
                continue
            x = torch.randn(m, c, device=device, generator=gen).to(dtype)
            params = (1.0 + 0.1 * torch.randn(c, device=device, generator=gen),
                      0.1 * torch.randn(c, device=device, generator=gen),
                      torch.randn(c, inter, device=device, generator=gen) / c**0.5,
                      0.1 * torch.randn(inter, device=device, generator=gen),
                      torch.randn(inter, g, device=device, generator=gen) / inter**0.5,
                      0.1 * torch.randn(g, device=device, generator=gen))
            gout = torch.randn(m, g, device=device, generator=gen).to(dtype)
            with torch.no_grad():
                err_f = rdtail.errors(rdtail._launch_fwd(x, params, RD_EPS), rdtail.reference_tail(x, *params, eps=RD_EPS))
                errs = rdtail.bwd_errors(rdtail._launch_bwd(x, params, gout, RD_EPS),
                                         rdtail.reference_tail_bwd(x, *params, gout, eps=RD_EPS))
            torch.cuda.synchronize()
            print(f"  rdtail fwd {str(dtype)[6:]} {(m, c, inter, g)} {route}: out {err_f[0]:.3g} <= {err_f[2]:.3g}"
                  + ("" if err_f[0] <= err_f[2] else "  <-- DISAGREES"))
            if not err_f[0] <= err_f[2]:
                raise RuntimeError(f"rdtail fwd disagrees at {(m, c, inter, g)} {dtype}: {err_f}")
            ok = all(e <= lim for e, _, lim in errs.values())
            print(f"  rdtail bwd {str(dtype)[6:]} {(m, c, inter, g)} {route}: "
                  + " ".join(f"{k} {e:.3g} <= {b:.3g}" for k, (e, _, b) in errs.items()) + ("" if ok else "  <-- DISAGREES"))
            if not ok:
                raise RuntimeError(f"rdtail bwd disagrees at {(m, c, inter, g)} {dtype}: {errs}")


def tail_bound_ms(m, c, inter, g, dtype, backward):
    """Bound of the RDNet block tail on (m, c) rows.  Bytes: x and the
    output (forward), or x and the cotangent read and dx written (backward),
    in the dtype; the parameters read in the dtype; their gradients written
    in f32 (backward).  Operations: fc1 and fc2, 2 m inter (c + g)
    (forward); the backward recomputes fc1 and takes dz, dh, dW1 and dW2:
    2 m inter (3 c + 2 g)."""
    item = torch.empty((), dtype=dtype).element_size()
    params = c * inter + inter * g + 2 * c + inter + g
    if backward:
        nbytes = item * (m * (2 * c + g) + params) + 4 * params
        ops = 2.0 * m * inter * (3 * c + 2 * g)
    else:
        nbytes = item * (m * (c + g) + params)
        ops = 2.0 * m * inter * (c + g)
    return (*bound(nbytes, ops, dtype), ops)


def check_rdtail(device, gen):
    """Phase 3d: the RDNet tail kernels against reference_tail and
    reference_tail_bwd at each dense block's shape of the full-width
    RDResUNet at batch 16, in f32 and bf16, with times, bounds and the
    unfused library chain (F.layer_norm, F.linear, F.gelu, F.linear; and
    its autograd backward) as the yardstick.  Returns per-dtype totals over
    one forward and one backward of the model's 21 tails."""
    from pssr2_tpu_torch.ops import rdtail

    print(
        f"phase kernels: rdtail forward (tensor cores {rdtail.FWD_LAUNCHES['tc']} launch, CUDA cores "
        f"{rdtail.FWD_LAUNCHES['cuda_core']}) and backward (tensor cores {rdtail.BWD_LAUNCHES['tc']} launches, "
        f"CUDA cores {rdtail.BWD_LAUNCHES['cuda_core']}) vs plain at the dense blocks' shapes (batch {BATCH}): "
        "route, max abs error (relative) <= bound | ms of kernel, plain, library; bound; kernel TFLOP/s"
    )
    totals, tails = {}, rd_shapes()[1]
    first = tails[0]
    for dtype in (torch.float32, torch.bfloat16):
        tot = {"fwd": _new_totals(), "bwd": _new_totals()}
        for m, c, inter, g in tails:
            route = rdtail.route(c, inter, g, dtype)
            if route != ("tc" if dtype == torch.bfloat16 else "cuda_core"):
                raise RuntimeError(f"rdtail {dtype} at {(m, c, inter, g)} takes the {route} route")
            x = torch.randn(m, c, device=device, generator=gen).to(dtype)
            params = (
                1.0 + 0.1 * torch.randn(c, device=device, generator=gen),
                0.1 * torch.randn(c, device=device, generator=gen),
                torch.randn(c, inter, device=device, generator=gen) / c**0.5,
                0.1 * torch.randn(inter, device=device, generator=gen),
                torch.randn(inter, g, device=device, generator=gen) / inter**0.5,
                0.1 * torch.randn(g, device=device, generator=gen),
            )
            gout = torch.randn(m, g, device=device, generator=gen).to(dtype)
            lib_params = [p.to(dtype) for p in (params[0], params[1], params[2].t().contiguous(), params[3],
                                                params[4].t().contiguous(), params[5])]

            def library(xl, pl):
                h = F.layer_norm(xl, (c,), pl[0], pl[1], RD_EPS)
                return F.linear(F.gelu(F.linear(h, pl[2], pl[3])), pl[4], pl[5])

            with torch.no_grad():
                if route == "cuda_core" and (m, c, inter, g) == first:
                    check_port_only(lambda: rdtail._launch_fwd(x, params, RD_EPS), f"rdtail f32 forward {(m, c, inter, g)}")
                counts = (rdtail.tc_launches, rdtail.tc_bwd_launches)
                got = rdtail._launch_fwd(x, params, RD_EPS)
                ref = rdtail.reference_tail(x, *params, eps=RD_EPS)
                got_b = rdtail._launch_bwd(x, params, gout, RD_EPS)
                tc = (rdtail.tc_launches - counts[0], rdtail.tc_bwd_launches - counts[1])
                if tc != ((1, rdtail.BWD_LAUNCHES["tc"]) if route == "tc" else (0, 0)):
                    raise RuntimeError(f"rdtail at {(m, c, inter, g)}: {tc} tensor-core launches on the {route} route")
                ref_b = rdtail.reference_tail_bwd(x, *params, gout, eps=RD_EPS)
                torch.cuda.synchronize()
                err_f = rdtail.errors(got, ref)
                errs_b = rdtail.bwd_errors(got_b, ref_b)
                del got, ref, got_b, ref_b
                times_f = (cuda_ms(lambda: rdtail._launch_fwd(x, params, RD_EPS)),
                           cuda_ms(lambda: rdtail.reference_tail(x, *params, eps=RD_EPS)),
                           cuda_ms(lambda: library(x, lib_params)))
                times_b = [cuda_ms(lambda: rdtail._launch_bwd(x, params, gout, RD_EPS)),
                           cuda_ms(lambda: rdtail.reference_tail_bwd(x, *params, gout, eps=RD_EPS))]
            xl = x.detach().requires_grad_()
            pl = [p.detach().requires_grad_() for p in lib_params]
            out = library(xl, pl)
            times_b.append(cuda_ms(lambda: torch.autograd.grad(out, [xl, *pl], gout, retain_graph=True)))
            del out
            ok_f = err_f[0] <= err_f[2]
            ok_b = all(e <= lim for e, _, lim in errs_b.values())
            for kind, ok, times, errs in (("fwd", ok_f, times_f, {"out": err_f}), ("bwd", ok_b, times_b, errs_b)):
                b_ms, b_by, ops = tail_bound_ms(m, c, inter, g, dtype, kind == "bwd")
                print(
                    f"  {str(dtype)[6:]:8s} {kind} M {m:5d} C {c:3d} inter {inter:4d} G {g:3d} {route:9s}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {times[0]:.4f} {times[1]:.4f} {times[2]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"{ops / times[0] / 1e9:.2f} TFLOP/s" + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"rdtail {kind} disagrees with its plain version at {(m, c, inter, g)}: {errs}")
                _add(tot[kind], 1, *times, b_ms, b_by, ops, max(e for e, _, _ in errs.values()))
        totals[dtype] = tot
        for kind, t in tot.items():
            print(
                f"  {dtype}: rdtail {kind} over one {'forward' if kind == 'fwd' else 'backward'}'s {t['layers']} "
                f"blocks: kernel {t['ms']:.3f} ms ({t['ops'] / t['ms'] / 1e9:.2f} TFLOP/s), plain "
                f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms"
            )
    return totals



def swin_bound_ms(b, h, w, c, heads, ws, hidden, dtype, backward):
    """Bound of one whole Swin block on (b, h, w, c).  Bytes: x and the
    output (forward), or x and the cotangent read and dx written (backward),
    in the dtype; the parameters read in the dtype and the bias map in f32;
    their gradients written in f32 (backward).  Operations per token: the
    products 2 C 3C (qkv) + 2 n C (scores) + 2 n C (p v) + 2 C^2 (proj) +
    4 C hidden (MLP) forward; the backward has only x, so it recomputes the
    forward and takes every product twice more (each input's and each
    weight's gradient; dq, dk, dv and dp): 3 times the forward."""
    item = torch.empty((), dtype=dtype).element_size()
    m, n = b * h * w, ws * ws
    params = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    ops = float(m) * (8 * c * c + 4 * n * c + 4 * c * hidden)
    if backward:
        nbytes = item * (3 * m * c + params) + 4 * (heads * n * n + params + heads * n * n)
        ops *= 3
    else:
        nbytes = item * (2 * m * c + params) + 4 * heads * n * n
    return (*bound(nbytes, ops, dtype), ops)


def winattn_bound_ms(b, h, w, c, heads, ws, dtype):
    """Bound of the window attention on a (b, h, w, 3c) image: qkv read and
    the output written in the dtype, the bias map in f32; the scores and
    p v, 4 n C operations a token."""
    item = torch.empty((), dtype=dtype).element_size()
    n = ws * ws
    return (*bound(item * 4 * b * h * w * c + 4 * heads * n * n, 4.0 * b * h * w * n * c, dtype),
            4.0 * b * h * w * n * c)


def _swin_library_mask(bias, mask, dtype):
    """SDPA's additive float mask: the bias map (1, heads, n, n), plus the
    shift mask per window (nW, heads, n, n), in the dtype."""
    out = bias[None] if mask is None else bias[None] + mask[:, None]
    return out.to(dtype)


def swin_library(x, lp, heads, ws, shift, attn_mask):
    """The block as one chain of library calls (the yardstick): roll, window
    partition, F.layer_norm, F.linear, F.scaled_dot_product_attention with
    the float bias and mask, F.linear, F.layer_norm, F.linear, F.gelu,
    F.linear; ``lp`` the parameters in the dtype, the linears as (out, in),
    the scale folded into W_qkv."""
    from pssr2_tpu_torch.ops import winattn

    b, h, w, c = x.shape
    n, d = ws * ws, c // heads
    xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    qkv = F.linear(F.layer_norm(xr, (c,), lp[0], lp[1], SWIN_EPS), lp[2], lp[3])
    qkv = winattn.windows(qkv, ws).view(b, -1, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=attn_mask, scale=1.0)
    o = winattn.unwindows(o.permute(0, 1, 3, 2, 4).reshape(-1, n, c), ws, b, h, w)
    y = xr + F.linear(o, lp[4], lp[5])
    out = y + F.linear(F.gelu(F.linear(F.layer_norm(y, (c,), lp[6], lp[7], SWIN_EPS), lp[8], lp[9])), lp[10], lp[11])
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def check_swin(device, gen):
    """Phase 3e: the whole Swin block (row 10) forward, without and with
    DropPath keep-scales, and its backward launches (with the keep-scales,
    and in eval) against reference_block and reference_block_bwd at the
    default SwinIR's blocks at batch 16, unshifted and shifted, in f32 and
    bf16 (each dtype's route printed and its tensor-core launches counted:
    bf16 runs on the tensor cores, f32 on the CUDA cores, whose backward
    trace must hold the port's kernels alone), with times, TFLOP/s, bounds
    and the library chain (and its autograd backward); the CUDA-core
    backward at RAGGED_SWIN; then the window attention (row 11) at those
    windows and at the SwinIR-L widths, masked and unmasked, against its
    plain version and SDPA.  Returns per-dtype totals: the block over one
    SwinIR() forward or backward (8 unshifted and 8 shifted blocks, the
    backward with keep-scales as training runs it), the window attention
    over one forward of the SwinIR-L-width model (2 + 2 blocks)."""
    from pssr2_tpu_torch.ops import swinblock, winattn

    c, heads, ws, hidden = SWIN_C, SWIN_HEADS, SWIN_WS, SWIN_HIDDEN
    n, scale = ws * ws, (c // heads) ** -0.5
    shape = (BATCH, LR_RES, LR_RES, c)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"phase kernels: swinblock forward (1 launch) and backward (tensor cores "
          f"{swinblock.BWD_LAUNCHES['tc']} launches, CUDA cores {swinblock.BWD_LAUNCHES['cuda_core']}) vs plain at "
          f"{shape}, {heads} heads, window {ws}, MLP {hidden}, on {smi}: max abs error (relative) <= bound | ms of "
          "kernel, plain, library; bound; kernel TFLOP/s")
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        route = swinblock.route(c, hidden, heads, ws, dtype)
        if route != ("tc" if dtype == torch.bfloat16 else "cuda_core"):
            raise RuntimeError(f"swinblock {dtype} at the default SwinIR's blocks takes the {route} route")
        tc = route == "tc"
        if tc:
            plans = {k: swinblock.tc_plan(BATCH * (LR_RES // ws) ** 2, c, hidden, k == "bwd") for k in ("fwd", "bwd")}
            print(f"  {str(dtype)[6:]}: route {route}; (windows a block, weight stages, grid, shared bytes) forward "
                  f"{plans['fwd']}, backward rows {plans['bwd']}")
        else:
            print(f"  {str(dtype)[6:]}: route {route}")
        tot = {"fwd": _new_totals(), "bwd": _new_totals(), "winattn": _new_totals()}
        x = torch.randn(*shape, device=device, generator=gen).to(dtype)
        gout = torch.randn(*shape, device=device, generator=gen).to(dtype)
        mk = lambda *sz, sc=0.1: sc * torch.randn(*sz, device=device, generator=gen)
        params = swinblock._fold_scale(
            (1.0 + mk(c), mk(c), mk(c, 3 * c, sc=c**-0.5), mk(3 * c), mk(c, c, sc=c**-0.5), mk(c), 1.0 + mk(c), mk(c),
             mk(c, hidden, sc=c**-0.5), mk(hidden), mk(hidden, c, sc=hidden**-0.5), mk(c), mk(heads, n, n, sc=0.5)),
            scale)
        keep = (torch.rand(BATCH, device=device, generator=gen) < 0.9).float() / 0.9
        scales = (keep, keep.flip(0))
        lib_p = [p.to(dtype) for p in params[:12]]
        for i in (2, 4, 8, 10):
            lib_p[i] = lib_p[i].t().contiguous()
        for shift in (0, ws // 2):
            mask = winattn._mask_tensor((LR_RES, LR_RES, ws, shift) if shift else None, device)
            attn_mask = _swin_library_mask(params[12], mask, dtype)
            for kind, sc in (("fwd", None), ("fwd+scales", scales), ("bwd", scales), ("bwd eval", None)):
                args = (x, params, heads, ws, shift, SWIN_EPS, sc)
                kw = dict(heads=heads, ws=ws, shift=shift, eps=SWIN_EPS, scales=sc)
                with torch.no_grad():
                    counts = (swinblock.tc_launches, swinblock.tc_bwd_launches)
                    if kind == "bwd eval":
                        got = swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc)
                        ref = swinblock.reference_block_bwd(x, params, gout, **kw)
                        torch.cuda.synchronize()
                        errs = swinblock.bwd_errors(got, ref)
                        del got, ref
                        k_ms = cuda_ms(lambda: swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc))
                        p_ms = l_ms = float("nan")
                    elif kind == "bwd":
                        got = swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc)
                        moved = (swinblock.tc_launches - counts[0], swinblock.tc_bwd_launches - counts[1])
                        if moved != (0, swinblock.BWD_LAUNCHES["tc"] if tc else 0):
                            raise RuntimeError(f"swinblock bwd on the {route} route: tensor-core launches {moved}")
                        ref = swinblock.reference_block_bwd(x, params, gout, **kw)
                        torch.cuda.synchronize()
                        errs = swinblock.bwd_errors(got, ref)
                        del got, ref
                        k_ms = cuda_ms(lambda: swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc))
                        p_ms = cuda_ms(lambda: swinblock.reference_block_bwd(x, params, gout, **kw), reps=3)
                    else:
                        got = swinblock._launch_fwd(*args)
                        moved = (swinblock.tc_launches - counts[0], swinblock.tc_bwd_launches - counts[1])
                        if moved != (int(tc), 0):
                            raise RuntimeError(f"swinblock fwd on the {route} route: tensor-core launches {moved}")
                        ref = swinblock.reference_block(x, params, **kw)
                        torch.cuda.synchronize()
                        errs = {"out": swinblock.errors(got, ref)}
                        del got, ref
                        k_ms = cuda_ms(lambda: swinblock._launch_fwd(*args))
                        p_ms = cuda_ms(lambda: swinblock.reference_block(x, params, **kw), reps=3)
                        l_ms = cuda_ms(lambda: swin_library(x, lib_p, heads, ws, shift, attn_mask))
                if kind == "bwd":
                    if shift:
                        profile_device(lambda: swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc),
                                       f"swinblock backward, {str(dtype)[6:]}, shifted block")
                        if not tc:
                            with torch.no_grad():
                                check_port_only(
                                    lambda: swinblock._launch_bwd(x, params, gout, heads, ws, shift, SWIN_EPS, sc),
                                    "swinblock f32 backward, shifted block")
                    xl = x.detach().requires_grad_()
                    pl = [p.detach().requires_grad_() for p in lib_p]
                    out = swin_library(xl, pl, heads, ws, shift, attn_mask)
                    l_ms = cuda_ms(lambda: torch.autograd.grad(out, [xl, *pl], gout, retain_graph=True), reps=3)
                    del out
                ok = all(e <= lim for e, _, lim in errs.values())
                b_ms, b_by, ops = swin_bound_ms(*shape, heads, ws, hidden, dtype, kind.startswith("bwd"))
                print(
                    f"  {str(dtype)[6:]:8s} {route:9s} {kind:10s} shift {shift}: "
                    + " ".join(f"{k} {e:.3g} (rel {r:.2g}) <= {b:.3g}" for k, (e, r, b) in errs.items())
                    + f" | {k_ms:.4f} {p_ms:.4f} {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"{ops / k_ms / 1e9:.2f} TFLOP/s" + ("" if ok else "  <-- DISAGREES")
                )
                if not ok:
                    raise RuntimeError(f"swinblock {kind} disagrees with its plain version (shift {shift}): {errs}")
                if kind in ("fwd", "bwd"):
                    _add(tot[kind], SWIN_BLOCKS // 2, k_ms, p_ms, l_ms, b_ms, b_by, ops,
                         max(e for e, _, _ in errs.values()))
        del x, gout

        # the CUDA-core backward at ragged blocks
        for rb, rh, rw, rc, rheads, rws, rhid in RAGGED_SWIN:
            if swinblock.route(rc, rhid, rheads, rws, dtype) != "cuda_core":
                raise RuntimeError(f"ragged Swin block {(rc, rhid, rheads, rws)} {dtype} is not on the CUDA cores")
            rn = rws * rws
            rx = torch.randn(rb, rh, rw, rc, device=device, generator=gen).to(dtype)
            rg = torch.randn(rb, rh, rw, rc, device=device, generator=gen).to(dtype)
            rp = (1.0 + mk(rc), mk(rc), mk(rc, 3 * rc, sc=rc**-0.5), mk(3 * rc), mk(rc, rc, sc=rc**-0.5), mk(rc),
                  1.0 + mk(rc), mk(rc), mk(rc, rhid, sc=rc**-0.5), mk(rhid), mk(rhid, rc, sc=rhid**-0.5), mk(rc),
                  mk(rheads, rn, rn, sc=0.5))
            rkeep = (torch.rand(rb, device=device, generator=gen) < 0.5).float() / 0.5
            for shift in (0, rws // 2):
                for sc in (None, (rkeep, rkeep.flip(0))):
                    with torch.no_grad():
                        got = swinblock._launch_bwd(rx, rp, rg, rheads, rws, shift, SWIN_EPS, sc)
                        ref = swinblock.reference_block_bwd(rx, rp, rg, heads=rheads, ws=rws, shift=shift,
                                                            eps=SWIN_EPS, scales=sc)
                        torch.cuda.synchronize()
                        errs = swinblock.bwd_errors(got, ref)
                        del got, ref
                    ok = all(e <= lim for e, _, lim in errs.values())
                    # the three largest errors against their bounds (a zero gradient has a zero bound)
                    worst = sorted(errs.items(), key=lambda kv: -(kv[1][0] / kv[1][2] if kv[1][2] else kv[1][0] * 1e30))
                    print(f"  {str(dtype)[6:]:8s} cuda_core bwd ragged {(rb, rh, rw, rc, rheads, rws, rhid)} shift "
                          f"{shift} {'droppath' if sc else 'eval'}: worst "
                          + " ".join(f"{k} {e:.3g} <= {b:.3g}" for k, (e, _, b) in worst[:3])
                          + ("" if ok else "  <-- DISAGREES"))
                    if not ok:
                        raise RuntimeError(f"swinblock bwd disagrees at ragged {(rc, rhid, rheads, rws)} shift {shift}: "
                                           f"{errs}")

        # the window attention: the default SwinIR's windows, then the SwinIR-L widths (its main path)
        for wc, wheads, count in ((c, heads, 0), (SWINL["embed_dim"], SWINL["num_heads"][0], sum(SWINL["depths"]) // 2)):
            qkv = torch.randn(BATCH, LR_RES, LR_RES, 3 * wc, device=device, generator=gen).to(dtype)
            bias = 0.5 * torch.randn(wheads, n, n, device=device, generator=gen)
            wscale = (wc // wheads) ** -0.5
            for shift in (0, ws // 2):
                spec = (LR_RES, LR_RES, ws, shift) if shift else None
                mask = winattn._mask_tensor(spec, device)
                with torch.no_grad():
                    got = winattn._launch(qkv, bias, mask, wscale, wheads, ws, ws)
                    ref = winattn.reference_window_attention_2d(qkv, bias, mask, wscale, wheads, ws)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs().max().item()
                    lim = winattn.TOLERANCE[dtype] * ref.float().abs().max().item()
                    del got, ref
                    k_ms = cuda_ms(lambda: winattn._launch(qkv, bias, mask, wscale, wheads, ws, ws))
                    p_ms = cuda_ms(lambda: winattn.reference_window_attention_2d(qkv, bias, mask, wscale, wheads, ws),
                                   reps=3)
                    q, k, v = (t.contiguous() for t in winattn.split_qkv(winattn.windows(qkv, ws), wheads))
                    lib_mask = _swin_library_mask(bias, mask, dtype)
                    if mask is not None:
                        q, k, v = (t.view(BATCH, -1, *t.shape[1:]) for t in (q, k, v))
                    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=wscale))
                    del q, k, v
                b_ms, b_by, ops = winattn_bound_ms(BATCH, LR_RES, LR_RES, wc, wheads, ws, dtype)
                ok = err <= lim
                print(f"  {str(dtype)[6:]:8s} winattn C {wc} heads {wheads} shift {shift}: out {err:.3g} <= {lim:.3g} "
                      f"| {k_ms:.4f} {p_ms:.4f} {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                      f"{ops / k_ms / 1e9:.2f} TFLOP/s" + ("" if ok else "  <-- DISAGREES"))
                if not ok:
                    raise RuntimeError(f"winattn disagrees with its plain version (C {wc}, shift {shift}): {err} > {lim}")
                if count:
                    _add(tot["winattn"], count, k_ms, p_ms, l_ms, b_ms, b_by, ops, err)
            del qkv
        totals[dtype] = tot
        for kind, t in tot.items():
            what = "the SwinIR-L-width forward's 4 blocks" if kind == "winattn" else \
                f"one SwinIR() {'forward' if kind == 'fwd' else 'backward'}'s {t['layers']} blocks"
            label = f"swinblock {kind} ({route})" if kind != "winattn" else kind
            print(f"  {dtype}: {label} over {what}: kernel {t['ms']:.3f} ms ({t['ops'] / t['ms'] / 1e9:.2f} TFLOP/s), plain {t['plain_ms']:.3f} ms, library "
                  f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms; {smi}")
    return totals

def _ssim_case(device, gen, kind, h, win=11, divisor=1.0):
    """One SSIM kernel pair (forward, backward) against its plain version
    on (BATCH, 1, h, h) f32 maps: errors, and times of the kernel, the
    plain version and a library yardstick.  ``kind``: "ssim" (row 5),
    "pool" (row 4) or "l0" (row 3, with ``divisor``)."""
    from pssr2_tpu_torch.ops import ssimfused
    from pssr2_tpu_torch.ops.ssim import _gaussian_window

    b, c1, c2, sigma = BATCH, 0.01**2, 0.03**2, 1.5
    shape = (b, 1, h, h)
    y = divisor * torch.rand(shape, device=device, generator=gen)
    x = y + 0.05 * divisor * torch.randn(shape, device=device, generator=gen)
    xs, ys = x.view(b, h, h), y.view(b, h, h)
    pool, l0 = kind != "ssim", kind == "l0"
    cot = {"s": torch.randn(b, device=device, generator=gen), "cs": torch.randn(b, device=device, generator=gen)}
    if l0:
        cot["l1"] = torch.randn(b, device=device, generator=gen)
    if pool:
        for k in ("xp", "yp"):
            cot[k] = torch.randn(b, h // 2, h // 2, device=device, generator=gen)
    fwd_args = (xs, ys, c1, c2, win, sigma, divisor, l0, pool)
    bwd_args = (xs, ys, cot["s"], cot["cs"], c1, c2, win, sigma, divisor, cot.get("l1"), cot.get("xp"), cot.get("yp"))
    s, cs, l1, xp, yp = ssimfused._launch_fwd(*fwd_args)
    gx, gy = ssimfused._launch_bwd(*bwd_args)

    plain = {"ssim": ssimfused.reference_parts, "pool": ssimfused.reference_parts_pool,
             "l0": ssimfused.reference_level0}[kind]
    extra = (divisor,) if l0 else ()
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    refs = plain(xr, yr, c1, c2, win, sigma, *extra)
    keys = ["s", "cs"] + (["l1"] if l0 else []) + (["xp", "yp"] if pool else [])
    cots = [cot[k].view(refs[i].shape) for i, k in enumerate(keys)]
    gx_ref, gy_ref = torch.autograd.grad(refs, (xr, yr), cots, retain_graph=True)
    torch.cuda.synchronize()
    got = {"s": s, "cs": cs, "l1": l1, "xp": xp, "yp": yp}
    tol = ssimfused.TOLERANCE
    errs = {}
    for i, k in enumerate(keys):
        ref = refs[i].detach().reshape(got[k].shape)
        lim = tol["pool"] * ref.abs().max().item() if k in ("xp", "yp") else tol[k]
        errs[k] = ((got[k] - ref).abs().max().item(), lim)
    for k, g, ref in (("gx", gx, gx_ref), ("gy", gy, gy_ref)):
        ref = ref.view(b, h, h)
        errs[k] = ((g - ref).abs().max().item(), tol["g"] * ref.abs().max().item())

    # yardsticks: one cuDNN call per part of the function (the port never calls them)
    g1 = torch.from_numpy(_gaussian_window(win, sigma)).to(device)
    window = torch.outer(g1, g1).view(1, 1, win, win)
    xd, yd = (x / divisor, y / divisor) if l0 else (x, y)
    moments = torch.cat([xd, yd, xd * xd, yd * yd, xd * yd])  # (5B, 1, H, W)
    maps = torch.randn(4 * b, 1, h - win + 1, h - win + 1, device=device, generator=gen)
    pair, absdiff = torch.cat([xd, yd]), (xd - yd).abs()

    def library_fwd():
        F.conv2d(moments, window)
        if l0:
            F.conv2d(absdiff, window, padding=win // 2)
        if pool:
            F.avg_pool2d(pair, 2)

    with torch.no_grad():
        k_fwd = cuda_ms(lambda: ssimfused._launch_fwd(*fwd_args))
        p_fwd = cuda_ms(lambda: plain(x, y, c1, c2, win, sigma, *extra))
        l_fwd = cuda_ms(library_fwd)
        k_bwd = cuda_ms(lambda: ssimfused._launch_bwd(*bwd_args))
        l_bwd = cuda_ms(lambda: F.conv_transpose2d(maps, window))
    p_bwd = cuda_ms(lambda: torch.autograd.grad(refs, (xr, yr), cots, retain_graph=True))
    out = {}
    for bwd, k_ms, p_ms, l_ms, names in ((False, k_fwd, p_fwd, l_fwd, keys), (True, k_bwd, p_bwd, l_bwd, ["gx", "gy"])):
        b_ms, b_by = ssim_bound_ms(b, h, h, bwd, win, pool, l0)
        ok = all(errs[k][0] <= errs[k][1] for k in names)
        out["bwd" if bwd else "fwd"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                        "bound_by": b_by, "max_abs_err": max(errs[k][0] for k in names)}
        print(
            f"  {kind}_{'bwd' if bwd else 'fwd'} {shape} win {win}" + (f" /{divisor:g}" if l0 else "") + ": "
            + " ".join(f"{k} {errs[k][0]:.3g} <= {errs[k][1]:.3g}" for k in names)
            + f" | kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + ("" if ok else "  <-- DISAGREES")
        )
        if not ok:
            raise RuntimeError(f"{kind} SSIM kernel disagrees with its plain version at {shape}: {errs}")
    return out


def _sum_cases(cases):
    """Totals over several shapes of one kernel (the MS-SSIM pool levels)."""
    tot = {k: sum(c[k] for c in cases) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {}
    for c in cases:
        by[c["bound_by"]] = by.get(c["bound_by"], 0.0) + c["bound_ms"]
    return dict(tot, bound_by=max(by, key=by.get), max_abs_err=max(c["max_abs_err"] for c in cases))


def check_ssim(device, gen):
    """Phase 3c: the SSIM kernels against their plain versions at the
    shapes of one MS-SSIM loss at batch 16 (level 0 at 512^2, the pool
    levels at 256^2, 128^2 and 64^2, the last level at 32^2) and of the
    metrics' single-scale SSIM at 512^2, with times, bounds and library
    yardsticks (library: cuDNN's conv2d of the five moment maps, plus the
    L1 map's SAME conv2d for level 0 and avg_pool2d of x and y for the
    pooling kernels; backward: conv_transpose2d of the four maps); row 5 at
    windows 7 and 15 too, and one bf16 ssim call on the band path.
    Returns the numbers for the kernels line."""
    from pssr2_tpu_torch.ops import ssimfused
    from pssr2_tpu_torch.ops.ssim import ssim

    res = LR_RES * SCALE
    print("phase kernels: SSIM kernels (forward 1 launch, backward 2) vs plain at batch 16, f32: "
          "max abs error <= bound | ms of kernel, plain, library; bound")
    l0 = _ssim_case(device, gen, "l0", res, divisor=255.0)
    pools = [_ssim_case(device, gen, "pool", res >> i) for i in (1, 2, 3)]
    single = _ssim_case(device, gen, "ssim", res)
    _ssim_case(device, gen, "ssim", res >> 4)
    for win in (7, 15):
        _ssim_case(device, gen, "ssim", res, win=win)

    y = torch.rand(SSIM_SHAPE, device=device, generator=gen)
    x = y + 0.05 * torch.randn(SSIM_SHAPE, device=device, generator=gen)
    before = _counts()
    s16 = ssim(x.bfloat16(), y.bfloat16(), data_range=1.0).float().item()
    launched = tuple(a - b for a, b in zip(_counts(), before))
    s32 = ssim(x, y, data_range=1.0).item()
    ok = abs(s16 - s32) <= BF16_SSIM_TOL and not any(launched)
    print(f"  bf16 ssim on the band path at {SSIM_SHAPE}: {s16:.6f} vs f32 kernel {s32:.6f}, "
          f"|diff| {abs(s16 - s32):.3g} <= {BF16_SSIM_TOL}; kernel launches during it {launched}"
          + ("" if ok else "  <-- DISAGREES"))
    if not ok:
        raise RuntimeError(f"bf16 ssim: {s16} vs {s32}, launches {launched}")
    return {
        "ssim_l0_fwd": l0["fwd"], "ssim_l0_bwd": l0["bwd"],
        "ssim_pool_fwd": _sum_cases([p["fwd"] for p in pools]), "ssim_pool_bwd": _sum_cases([p["bwd"] for p in pools]),
        "ssim_fwd": single["fwd"], "ssim_bwd": single["bwd"],
    }


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


MODELS = ("ResUNet", "RDResUNet", "SwinIR")


@functools.cache
def _state(kind, seed):
    """The seeded weights of the full-width model ``kind`` (CPU tensors)."""
    from pssr2_tpu_torch.weights import (params_from_jax, seeded_jax_params, seeded_rdresunet_params,
                                         seeded_swinir_params)

    if kind == "ResUNet":
        return params_from_jax(seeded_jax_params(HIDDEN, DEPTH, scale=SCALE, seed=seed))
    if kind == "RDResUNet":
        return params_from_jax(seeded_rdresunet_params(scale=SCALE, seed=seed))
    extra = SWINL if kind == "SwinIR-L" else {}
    return params_from_jax(seeded_swinir_params(image_size=LR_RES, scale=SCALE, **extra, seed=seed))


def _model(state, dtype, device, kind="ResUNet", train=True):
    """The full-width model ``kind`` with ``state`` loaded, in train mode
    unless ``train`` is False."""
    from pssr2_tpu_torch.models import RDResUNet, ResUNet, SwinIR

    if kind == "ResUNet":
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, dtype=dtype, device=device)
    elif kind == "RDResUNet":
        model = RDResUNet(scale=SCALE, dtype=dtype, device=device)
    else:
        model = SwinIR(image_size=LR_RES, scale=SCALE, **(SWINL if kind == "SwinIR-L" else {}), dtype=dtype,
                       device=device)
    model.load_state_dict(state, strict=True)
    return model.train() if train else model.eval()


def run_slice(device, seed, card, root, tmp, kind, calls=("first", "second")):
    """Phase 4: predict_images with the full-width model ``kind`` in f32 and
    bf16, one call per entry of ``calls`` ("traced": under profile_device,
    whose print splits the call's wall time into device busy and idle), its
    launches checked exactly;
    the raw output of CPU_TILES[kind] f32 tiles held against the same model
    on the CPU.  Returns the launches of each run, in the order of
    COUNTERS."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset, tiff
    from pssr2_tpu_torch.predict import predict_images

    state = _state(kind, seed)
    launches = {}
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    if dataset.is_lr or len(dataset) != TILES:
        raise RuntimeError(f"dataset: is_lr={dataset.is_lr}, {len(dataset)} items")
    batches = -(-TILES // BATCH)
    n_cpu = CPU_TILES[kind]

    for dtype in (torch.float32, torch.bfloat16):
        # per forward: the model's convchain, rdtail, swinblock or winattn forwards, nothing else
        per_fwd = tuple(n if c in ("convchain_fwd", "rdtail_fwd", "rdtail_tc_fwd", "swinblock_fwd", "swinblock_tc_fwd",
                                   "winattn") else 0
                        for c, n in zip(COUNTERS, _per_step(train=False, kind=kind, dtype=dtype)))
        want = tuple(batches * n for n in per_fwd)
        model = _model(state, dtype, device, kind, train=False)
        out_dir = Path(tmp, f"preds_{kind}_{str(dtype)[6:]}")
        launches[dtype] = (0,) * len(COUNTERS)
        for call in calls:  # the first with cuDNN set-up, the second warm, "traced" under torch.profiler
            np.random.seed(seed)
            torch.cuda.synchronize()
            _reset_counts()
            start = time.perf_counter()

            def serve():
                predict_images(model, dataset, device=device, batch_size=BATCH, out_dir=str(out_dir))

            if call == "traced":
                profile_device(serve, f"serving {kind} {dtype} (the whole call: tile loading and writing included)")
            else:
                serve()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            counts = _counts()
            launches[dtype] = tuple(a + b for a, b in zip(launches[dtype], counts))
            print(
                f"phase serving {kind} {dtype}, {call} call: {TILES} tiles {LR_RES}^2 -> {hr_res}^2 in "
                f"{elapsed:.3f} s = {TILES / elapsed:.2f} tiles/s on {card} (tile loading and writing "
                f"included); launches {counts} (want {want}, {', '.join(COUNTERS)})"
            )
            if counts != want:
                raise RuntimeError(f"{kind} serving launched {counts}, want {want}")
        preds = sorted(out_dir.glob("*.tif"))
        if len(preds) != TILES:
            raise RuntimeError(f"{len(preds)} predictions written, want {TILES}")
        for p in preds:
            image = tiff.imread(p)
            if image.shape != (hr_res, hr_res) or image.dtype != np.uint8:
                raise RuntimeError(f"{p.name}: {image.shape} {image.dtype}")

        # raw outputs of the first tiles: finite; f32 against the CPU
        np.random.seed(seed)
        lr = torch.from_numpy(np.stack([dataset[i][1] for i in range(n_cpu)]))
        with torch.inference_mode():
            out = model(lr.to(device)).cpu()
        if out.shape != (n_cpu, 1, hr_res, hr_res) or not torch.isfinite(out).all():
            raise RuntimeError(f"model output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
        if dtype == torch.float32:
            del model
            cpu_model = _model(state, None, "cpu", kind, train=False)
            start = time.perf_counter()
            with torch.inference_mode():
                ref = cpu_model(lr)
            err = (out - ref).abs().max().item()
            print(f"  f32 card vs CPU on {n_cpu} tile(s): max abs err {err:.3g} (bound {CPU_TOL}), "
                  f"output range [{ref.min().item():.2f}, {ref.max().item():.2f}], std {ref.std().item():.2f}; "
                  f"CPU forward {time.perf_counter() - start:.1f} s")
            if not err <= CPU_TOL:
                raise RuntimeError(f"card output differs from the CPU by {err}")
    return launches


# the launch counters, in the order of _counts()
COUNTERS = ("convchain_fwd", "convchain_bwd", "ssim_fwd", "ssim_bwd", "ssim_pool_fwd", "ssim_pool_bwd",
            "ssim_l0_fwd", "ssim_l0_bwd", "rdtail_fwd", "rdtail_bwd", "rdtail_tc_fwd", "rdtail_tc_bwd",
            "swinblock_fwd", "swinblock_bwd", "swinblock_tc_fwd", "swinblock_tc_bwd", "winattn", "chanstats",
            "gradhist_fwd", "gradhist_bwd", "q8conv")
# f32 tiles of the serving phase held against the CPU, per model
CPU_TILES = {"ResUNet": 2, "RDResUNet": 1, "SwinIR": 1, "SwinIR-L": 1}


def _counts():
    from pssr2_tpu_torch.ops import chanstats, convchain, gradhist, q8chain, rdtail, ssimfused, swinblock, winattn

    return (convchain.launches, convchain.bwd_launches, ssimfused.fwd_launches, ssimfused.bwd_launches,
            ssimfused.pool_fwd_launches, ssimfused.pool_bwd_launches, ssimfused.l0_fwd_launches,
            ssimfused.l0_bwd_launches, rdtail.launches, rdtail.bwd_launches, rdtail.tc_launches,
            rdtail.tc_bwd_launches, swinblock.launches, swinblock.bwd_launches, swinblock.tc_launches,
            swinblock.tc_bwd_launches, winattn.launches, chanstats.launches, gradhist.launches, gradhist.bwd_launches,
            q8chain.launches)


def _reset_counts():
    from pssr2_tpu_torch.ops import chanstats, convchain, gradhist, q8chain, rdtail, ssimfused, swinblock, winattn

    convchain.launches = convchain.bwd_launches = 0
    ssimfused.fwd_launches = ssimfused.bwd_launches = 0
    ssimfused.pool_fwd_launches = ssimfused.pool_bwd_launches = 0
    ssimfused.l0_fwd_launches = ssimfused.l0_bwd_launches = 0
    rdtail.launches = rdtail.bwd_launches = rdtail.tc_launches = rdtail.tc_bwd_launches = 0
    swinblock.launches = swinblock.bwd_launches = swinblock.tc_launches = swinblock.tc_bwd_launches = 0
    winattn.launches = 0
    chanstats.launches = gradhist.launches = gradhist.bwd_launches = q8chain.launches = 0


@functools.cache
def _per_step(train=True, metrics=False, kind="ResUNet", dtype=torch.bfloat16):
    """Launches of one step of the full-width model in ``dtype`` with the
    MS-SSIM loss: its convchain forwards (ResUNet 36, RDResUNet 16) and 2
    backward launches a layer; RDResUNet's 21 rdtail tails, each with the
    forward and backward launches of their route (bf16: all on the tensor
    cores, 1 and 4; f32: the CUDA cores, 3 and 4, rdtail.FWD_LAUNCHES and
    BWD_LAUNCHES); SwinIR's 16 swinblock forwards and the backward launches
    of their route each (bf16: 2 on the tensor cores; f32: 13,
    swinblock.BWD_LAUNCHES), or the SwinIR-L widths' 4 winattn forwards
    (served only); the
    loss's level 0, three pool levels and last level, forward (1 launch
    each) and backward (2 each); the metrics add a single-scale SSIM
    forward.  A training step of ResUNet or RDResUNet adds the chanstats
    launches of its train-mode BatchNorms: the input norm's forward and
    backward, and one a ResBlock (the last layer's affine backward).  A
    validation step runs the forwards only, in eval mode."""
    n = dict.fromkeys(COUNTERS, 0)
    if kind == "ResUNet":
        n["convchain_fwd"] = sum(e + p for *_, e, p in layer_shapes())
        blocks = 2 * len(HIDDEN) - 1
    elif kind == "RDResUNet":
        from pssr2_tpu_torch.ops.rdtail import FWD_LAUNCHES

        convs, tails = rd_shapes()
        n["convchain_fwd"] = sum(e + p for *_, e, p in convs)
        n["rdtail_fwd"] = len(tails) * FWD_LAUNCHES["tc" if dtype == torch.bfloat16 else "cuda_core"]
        n["rdtail_tc_fwd"] = len(tails) if dtype == torch.bfloat16 else 0
        blocks = _rd_decoder_blocks()
    elif kind == "SwinIR":
        n["swinblock_fwd"], blocks = SWIN_BLOCKS, None
        n["swinblock_tc_fwd"] = SWIN_BLOCKS if _swin_route(dtype) == "tc" else 0
    else:
        n["winattn"], blocks = sum(SWINL["depths"]), None
    n.update(ssim_fwd=1 + int(metrics), ssim_pool_fwd=3, ssim_l0_fwd=1)
    if train:
        from pssr2_tpu_torch.ops import swinblock
        from pssr2_tpu_torch.ops.rdtail import BWD_LAUNCHES

        tails = len(rd_shapes()[1]) if kind == "RDResUNet" else 0
        per_tail = BWD_LAUNCHES["tc" if dtype == torch.bfloat16 else "cuda_core"]
        n.update(convchain_bwd=2 * n["convchain_fwd"], ssim_bwd=2, ssim_pool_bwd=6, ssim_l0_bwd=2,
                 rdtail_bwd=per_tail * tails, rdtail_tc_bwd=BWD_LAUNCHES["tc"] * n["rdtail_tc_fwd"],
                 swinblock_bwd=swinblock.BWD_LAUNCHES[_swin_route(dtype)] * n["swinblock_fwd"],
                 swinblock_tc_bwd=swinblock.BWD_LAUNCHES["tc"] * n["swinblock_tc_fwd"],
                 chanstats=0 if blocks is None else 2 + blocks)
    return tuple(n[c] for c in COUNTERS)


def _swin_route(dtype):
    """The route of the default SwinIR's blocks in ``dtype``."""
    from pssr2_tpu_torch.ops import swinblock

    return swinblock.route(SWIN_C, SWIN_HIDDEN, SWIN_HEADS, SWIN_WS, dtype)


@functools.cache
def _rd_decoder_blocks():
    from pssr2_tpu_torch.models import RDResUNet

    return len(RDResUNet(device="meta").decoder)


def _train_parts(seed, kind="ResUNet"):
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data.pipeline import make_device_gen_pair
    from pssr2_tpu_torch.train import _build_paired_steps
    from pssr2_tpu_torch.util import SSIMLoss

    base = make_device_gen_pair(SCALE, Poisson())

    def gen_pair(generator, batch, augment):
        return base(generator, batch)

    return _state(kind, seed), gen_pair, SSIMLoss(mix=0.8, ms=True), _build_paired_steps


def run_train(device, seed, card, root, kind):
    """Phase 5a: the training step of the full-width model ``kind`` in bf16
    and f32 over PatchLoader batches, with the launches of each step
    checked; returns the launches of each run, in the order of COUNTERS."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.data.indexing import RandomIterIdx
    from pssr2_tpu_torch.data.pipeline import PatchLoader
    from pssr2_tpu_torch.optim import AdamW

    state, gen_pair, loss_fn, build = _train_parts(seed, kind)
    step, _ = build(loss_fn, False, gen_pair)
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_step = _per_step(kind=kind, dtype=dtype)
        model = _model(state, dtype, device, kind)
        optimizer = AdamW(LR_RATE).init(model.parameters())
        loader = PatchLoader(dataset, RandomIterIdx(range(len(dataset)), rng=np.random.default_rng(seed)), BATCH)
        times, losses, k = [], [], 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        # one more step, traced
        before = _counts()
        profile_device(lambda: step(model, optimizer, hr_u8, None, generator, LR_RATE, n_valid, False),
                       f"one {kind} training step, {str(dtype)[6:]}")
        delta = tuple(a - b for a, b in zip(_counts(), before))
        if delta != per_step:
            raise RuntimeError(f"traced step: launches {delta} (want {per_step})")
        k += 1
        # one more step with the metrics: a second SSIM forward
        before = _counts()
        loss, (mse, ssim_val), _ = step(model, optimizer, hr_u8, None, generator, LR_RATE, n_valid, True)
        delta = tuple(a - b for a, b in zip(_counts(), before))
        want = _per_step(metrics=True, kind=kind, dtype=dtype)
        values = [loss.item(), mse.item(), ssim_val.item()]
        if delta != want or not np.isfinite(values).all():
            raise RuntimeError(f"metrics step: launches {delta} (want {want}), loss, mse, ssim {values}")
        launches[dtype] = _counts()
        steady = sum(times[1:]) / len(times[1:])
        print(
            f"phase training {kind} {dtype}: {k} steps + 1 with metrics at batch {BATCH} ({hr_res}^2 HR, "
            f"{LR_RES}^2 LR) on {card}: steady step {1e3 * steady:.2f} ms = {BATCH / steady:.2f} patches/s "
            f"(steps after the first: " + ", ".join(f"{1e3 * t:.2f}" for t in times[1:]) + f" ms; first "
            f"{1e3 * times[0]:.2f} ms); losses " + ", ".join(f"{v:.6f}" for v in losses)
            + f"; metrics step loss {values[0]:.6f} mse {values[1]:.6g} ssim {values[2]:.6f}; launches per step "
            f"{per_step} ({', '.join(COUNTERS)}), whole run {launches[dtype]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        )
        del model, optimizer
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


def run_train_paired(device, seed, card, root, tmp, kind, epochs_seq):
    """Phase 6: ``train_paired`` with the full-width model ``kind`` in bf16
    compute, batch 16, over the TILES 512^2 tiles (Poisson noise,
    augmentation and validation on the device pipeline), with a
    ReduceLROnPlateau, weight checkpoints and a state directory: one call
    per entry of ``epochs_seq``, each to that many epochs; every call after
    the first must resume from the saved state and run the rest.  Returns
    the launches of all calls, in the order of COUNTERS."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.optim import AdamW, ReduceLROnPlateau
    from pssr2_tpu_torch.train import train_paired
    from pssr2_tpu_torch.util import SSIMLoss

    state = _state(kind, seed)
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, crappifier=Poisson(), val_split=TP_VAL_SPLIT)
    n_train, n_val = len(dataset) - len(dataset.val_idx), len(dataset.val_idx)
    state_dir, ckpt_dir = Path(tmp, f"{kind}_train_state"), Path(tmp, f"{kind}_checkpoints")

    class EpochClock(ReduceLROnPlateau):
        """The scheduler train_paired steps at each epoch's end, stamping it."""

        stamps = []

        def step(self, metric):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            super().step(metric)

    steps = []  # a locals callback: (epoch, n_valid) of each training step

    torch.cuda.synchronize()
    _reset_counts()
    results, printed = [], []
    for epochs in epochs_seq:
        model = _model(state, torch.bfloat16, device, kind)
        optim = AdamW(LR_RATE)
        start = time.perf_counter()
        EpochClock.stamps = [start]
        printed.append(_capture_stdout(lambda: results.append(train_paired(
            model, dataset, BATCH, SSIMLoss(mix=0.8, ms=True), optim, epochs, scheduler=EpochClock(optim),
            checkpoint_dir=str(ckpt_dir), state_dir=str(state_dir), seed=seed,
            callbacks=[lambda local: steps.append((local["epoch"], local["n_valid"]))],
        ))))
        epoch_s = np.diff(EpochClock.stamps)
        print(
            f"phase train_paired {kind} bf16 (epochs={epochs}) on {card}: {n_train} training and {n_val} "
            f"validation patches an epoch at batch {BATCH}; epoch times " + ", ".join(f"{t:.3f}" for t in epoch_s)
            + " s (training, validation, checkpoints; the first with cuDNN set-up) = "
            + ", ".join(f"{n_train / t:.2f}" for t in epoch_s)
            + f" training patches/s; call {time.perf_counter() - start:.2f} s with set-up; "
            f"train losses {results[-1][0]}, val losses {results[-1][1]}"
        )
        del model, optim
    counts = _counts()
    last = epochs_seq[-1]
    resumes = [f"Resuming training from epoch {e}" for e in epochs_seq[:-1]]
    resumed = all(any(r in line for line in lines) for r, lines in zip(resumes, printed[1:]))
    runs = [len(val) for _, val in results]
    finite = all(np.isfinite(v) for run in results for part in run for v in part)
    n_batches, n_val_batches = -(-n_train // BATCH), -(-n_val // BATCH)
    n_metrics = len({i for i in range(n_batches) if i % 50 == 0 or i == n_batches - 1})  # log_frequency 50
    per_epoch = [_per_step(metrics=True, kind=kind)] * n_metrics + [_per_step(kind=kind)] * (n_batches - n_metrics) \
        + [_per_step(train=False, kind=kind)] * n_val_batches
    want = tuple(last * sum(c) for c in zip(*per_epoch))
    want_steps = [(e, min(BATCH, n_train - BATCH * i)) for e in range(last) for i in range(n_batches)]
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    states = sorted(p.name for p in state_dir.iterdir())
    want_states = sorted({f"epoch_{max(last - 1, 1)}.pt", f"epoch_{last}.pt"})
    print(
        f"  later calls printed {resumes}: {resumed}; epochs run {runs}; (epoch, n_valid) of the steps {steps}; "
        f"state files {states} ({', '.join(f'{(state_dir / n).stat().st_size / 1e9:.2f}' for n in states)} GB); "
        f"weight checkpoints {ckpts}; launches {counts} (want {want}, {', '.join(COUNTERS)})"
    )
    if not resumed or runs != [b - a for a, b in zip((0, *epochs_seq), epochs_seq)] or not finite \
            or counts != want or steps != want_steps or states != want_states or not ckpts:
        raise RuntimeError(f"train_paired {kind}: results {results}, launches {counts} (want {want}), steps {steps}, "
                           f"states {states}, checkpoints {ckpts}, printed {[p[:3] for p in printed]}")
    return counts


def _capture_stdout(fn):
    """Run ``fn`` with its standard output echoed and kept; -> the lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    text = buf.getvalue()
    print("    | " + text.rstrip("\n").replace("\n", "\n    | "))
    return text.splitlines()


# ---- the learned crappifier, the BatchNorm sums and int8 serving (rows 12, 6 and 13) ----

# The learned crappifier's soft histograms: a batch of BATCH noise profiles
# of LR_RES^2 values each, GRADHIST_BINS bins, sharpness GRADHIST_SIGMA;
# and one ragged value count
GRADHIST_BINS, GRADHIST_SIGMA, GRADHIST_RAGGED_N = 512, 5.0, 1000
# H100 SXM: 132 SMs, 16 special-function results a clock on each (the CUDA
# programming guide's throughput table for compute capability 9.0); a
# sigmoid needs at least one (0.5 + 0.5 tanh(z / 2))
SMS, SFU_PER_CLOCK = 132, 16
# int8 serving: the f32-glue card output against the same executor on the
# CPU, relative L2 over the tile ([0, 255] scale).  The int8 layers agree
# bit for bit; the float parts (the RDNet encoder, the reconstruction's last
# conv) sum in another order, and a difference at the f32 rounding level can
# move an int8 value to the other side of a rounding boundary.  JAX's own
# bound between two int8 engines of one model (its chained and per-conv
# paths) is 5e-3.
Q8_CPU_TOL = 5e-3
# train_crappifier: epochs in bf16, then in f32; the share of the tiles
# held out for validation
CRAP_EPOCHS, CRAP_VAL_SPLIT = {torch.bfloat16: 2, torch.float32: 1}, 0.25


def _max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    return 1e6 * float(out)


def check_gradhist(device, gen):
    """Phase 3f: the soft-histogram kernels (row 12) against their plain
    versions at the learned crappifier's shape (BATCH profiles of LR_RES^2
    values, 512 bins) and at a ragged value count, with times and the bound:
    the larger of the sigmoids at the special-function rate (one result
    each, at the card's largest SM clock) and the bytes.  No PyTorch call
    computes a soft histogram: no library time.  Returns the numbers of the
    crappifier's shape, per launch."""
    from pssr2_tpu_torch.ops import gradhist

    sfu_rate = SMS * SFU_PER_CLOCK * _max_sm_clock_hz()
    centers = gradhist.bin_centers(GRADHIST_BINS).to(device)
    print(f"phase kernels: gradhist forward and backward (1 launch each) vs plain, {GRADHIST_BINS} bins, sigma "
          f"{GRADHIST_SIGMA:g}: max abs error (largest error / bound) | ms of kernel, plain; bound (special "
          f"functions at {sfu_rate / 1e12:.3f} T/s or bytes)")
    out = {}
    for n in (LR_RES * LR_RES, GRADHIST_RAGGED_N):
        values = 30 * torch.randn(BATCH, n, device=device, generator=gen)
        g = torch.randn(BATCH, GRADHIST_BINS, device=device, generator=gen)
        with torch.no_grad():
            hist = gradhist._launch_fwd(values, centers, GRADHIST_SIGMA)
            dv = gradhist._launch_bwd(values, centers, GRADHIST_SIGMA, g)
            ref = gradhist.gradhist_plain(values, centers, GRADHIST_SIGMA)
            ref_dv = gradhist.gradhist_bwd_plain(values, centers, GRADHIST_SIGMA, g)
            torch.cuda.synchronize()
            errs = {"fwd": gradhist.errors(hist, ref, n), "bwd": gradhist.bwd_errors(dv, ref_dv, g, GRADHIST_SIGMA)}
            del hist, dv, ref, ref_dv
            times = {
                "fwd": (cuda_ms(lambda: gradhist._launch_fwd(values, centers, GRADHIST_SIGMA)),
                        cuda_ms(lambda: gradhist.gradhist_plain(values, centers, GRADHIST_SIGMA), reps=3)),
                "bwd": (cuda_ms(lambda: gradhist._launch_bwd(values, centers, GRADHIST_SIGMA, g)),
                        cuda_ms(lambda: gradhist.gradhist_bwd_plain(values, centers, GRADHIST_SIGMA, g), reps=3)),
            }
        sigmoids = float(BATCH * n * GRADHIST_BINS)
        for kind in ("fwd", "bwd"):
            nbytes = 4 * (BATCH * n + GRADHIST_BINS + BATCH * GRADHIST_BINS) + (4 * BATCH * n if kind == "bwd" else 0)
            t_ops, t_bytes = sigmoids / sfu_rate, nbytes / PEAK_BYTES
            b_ms, b_by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"
            (err, ratio), (k_ms, p_ms) = errs[kind], times[kind]
            ok = ratio <= 1
            print(f"  gradhist_{kind} ({BATCH}, {n}) x {GRADHIST_BINS}: {err:.3g} ({ratio:.3g} of its bound) | "
                  f"{k_ms:.4f} {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); {sigmoids / k_ms / 1e9:.1f} G sigmoids/s"
                  + ("" if ok else "  <-- DISAGREES"))
            if not ok:
                raise RuntimeError(f"gradhist {kind} disagrees with its plain version at N {n}: {err} ({ratio})")
            if n == LR_RES * LR_RES:
                out[f"gradhist_{kind}"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                                           "bound_by": b_by, "max_abs_err": err}
        del values, g
    return out


def chanstats_shapes():
    """{(rows, C): launches in one training step} of the dual sums of the
    full-width ResUNet at batch 16: the input BatchNorm's forward (x, x) and
    backward (gy, x) at (BATCH * LR_RES^2, 1), and each ResBlock's last
    affine backward (gy, h) at its width."""
    shapes = {(BATCH * LR_RES * LR_RES, 1): 2}
    for cin, cout, res, e, p in layer_shapes():
        if e:  # one ResBlock (its entry layer)
            key = (BATCH * res * res, cout)
            shapes[key] = shapes.get(key, 0) + e
    return shapes


def check_chanstats(device, gen):
    """Phase 3g: the dual-sums kernel (row 6) against its plain version at
    the shapes of one ResUNet training step, in f32 and bf16, with times,
    the bound (the bytes of x and y read once) and ``torch.var_mean`` over
    the rows as the yardstick (another function: the mean and variance of
    x, the statistics the sums of (x, x) give).  Returns per-dtype totals
    over one training step's launches."""
    from pssr2_tpu_torch.ops import chanstats

    print("phase kernels: chanstats dual sums (1 launch) vs plain at one ResUNet training step's shapes: max abs "
          "error (largest error / bound) | ms of kernel, plain, torch.var_mean; bound (bytes)")
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = _new_totals()
        for (rows, c), count in chanstats_shapes().items():
            x = (torch.randn(rows, c, device=device, generator=gen) + 0.3).to(dtype)
            y = torch.randn(rows, c, device=device, generator=gen).to(dtype)
            with torch.no_grad():
                err, ratio = chanstats.errors(chanstats._launch(x, y), x, y)
                k_ms = cuda_ms(lambda: chanstats._launch(x, y))
                p_ms = cuda_ms(lambda: chanstats.dual_sums_plain(x, y))
                l_ms = cuda_ms(lambda: torch.var_mean(x, dim=0))
            b_ms, b_by = bound(2 * x.element_size() * rows * c + 4 * 2 * c, 2.0 * rows * c, dtype)
            ok = ratio <= 1
            print(f"  {str(dtype)[6:]:8s} ({rows}, {c}) x{count}: {err:.3g} ({ratio:.3g}) | {k_ms:.4f} {p_ms:.4f} "
                  f"{l_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})" + ("" if ok else "  <-- DISAGREES"))
            if not ok:
                raise RuntimeError(f"chanstats disagrees with its plain version at ({rows}, {c}) {dtype}: {err}")
            _add(tot, count, k_ms, p_ms, l_ms, b_ms, b_by, 2.0 * rows * c, err)
        totals[dtype] = tot
        print(f"  {dtype}: chanstats over one ResUNet training step's {tot['layers']} launches: kernel "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, var_mean {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms")
    return totals


def _int8_convs(kind):
    """{(cin, cout, k, res, mid): {model: count}} of the int8 convs of one
    forward of the quantized full-width ``kind`` at batch BATCH (the
    ResBlocks' 3x3 layers, chained where the port chains them, and 1x1
    residuals; the reconstruction's pre-conv); ``mid``: the layer emits int8
    (mid-chain), else the glue dtype."""
    from pssr2_tpu_torch.models import RDResUNet, ResUNet
    from pssr2_tpu_torch.quant import chain_split

    if kind == "ResUNet":
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, device="meta")
        n = len(model.encoder)
        blocks = [(b, LR_RES >> i) for i, b in enumerate(model.encoder)]
        blocks += [(b, LR_RES >> (n - 2 - i)) for i, b in enumerate(model.decoder)]
    else:
        model = RDResUNet(scale=SCALE, device="meta")
        res = LR_RES // model.ratios[-1] // 2 ** sum(model.encoder.ds_blocks)
        blocks = [(b, res << i) for i, b in enumerate(model.decoder)]
    out = {}

    def add(key):
        out[key] = out.get(key, 0) + 1

    for blk, res in blocks:
        convs = [blk.conv[3 * i] for i in range(blk.n_layers)]
        split = chain_split([cv.weight.shape for cv in convs])
        for i, cv in enumerate(convs):
            add((cv.in_channels, cv.out_channels, 3, res, split <= i < len(convs) - 1))
        add((blk.respass.in_channels, blk.respass.out_channels, 1, res, False))
    pre = model.reconstruction.pre
    add((pre.in_channels, pre.out_channels, 3, LR_RES, False))
    return out


def check_q8(device, gen):
    """Phase 3h: the int8 conv-layer kernel (row 13) against its plain
    version (the conv in float64, exact, and the same epilogue) at every
    distinct int8 conv shape of the int8 ResUNet() and RDResUNet() decoder
    at batch 16: mid-chain layers with the int8 epilogue, the others with the
    f32 and the bf16 glue epilogue, all bit for bit.  Yardsticks, each
    another function: bf16 F.conv2d at the same shape, and torch._int_mm on
    the unfolded operands (rows x K*K*Cin padded to 8, by Cout; the unfold
    not timed).  The bound: 2 N H W K^2 Cin Cout operations at 1,979 TOP/s
    int8 against x, y and the weights.  Returns per-glue-dtype totals over
    one forward of the int8 ResUNet()."""
    from pssr2_tpu_torch.ops import q8chain

    shapes = {}
    for kind in ("ResUNet", "RDResUNet"):
        for key, count in _int8_convs(kind).items():
            shapes.setdefault(key, {})[kind] = count
    print(f"phase kernels: q8chain int8 conv layer (1 launch) vs plain at batch {BATCH}: int8 / glue outputs bit for "
          "bit | ms of kernel, plain, bf16 F.conv2d, torch._int_mm; bound (int8 at 1,979 TOP/s, bytes)")
    totals = {dt: _new_totals() for dt in (torch.float32, torch.bfloat16)}
    for (cin, cout, k, res, mid), per_model in sorted(shapes.items()):
        x8 = torch.randint(-127, 128, (BATCH, res, res, cin), device=device, generator=gen, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (cout, cin, k, k), device=device, generator=gen, dtype=torch.int8)
        affine = torch.stack([torch.rand(cout, device=device, generator=gen) * 1e-4,
                              torch.randn(cout, device=device, generator=gen)])
        wk = q8chain.kernel_weight(w8)
        ops = 2.0 * BATCH * res * res * k * k * cin * cout
        with torch.no_grad():
            xb, wb = x8.permute(0, 3, 1, 2).to(torch.bfloat16), w8.to(torch.bfloat16)
            conv_ms = cuda_ms(lambda: F.conv2d(xb, wb, padding=k // 2))
            del xb, wb
            kdim = -(-k * k * cin // 8) * 8
            a = torch.randint(-127, 128, (BATCH * res * res, kdim), device=device, generator=gen, dtype=torch.int8)
            b = torch.randint(-127, 128, (cout, kdim), device=device, generator=gen, dtype=torch.int8).t()
            mm_ms = cuda_ms(lambda: torch._int_mm(a, b))
            del a, b
            for out_dtype in ((None,) if mid else (torch.float32, torch.bfloat16)):
                last = out_dtype is not None
                y_dtype = out_dtype or torch.bfloat16
                got = q8chain._launch(x8, w8, affine, out_dtype or torch.int8, wk)
                ref = q8chain.reference_q8_layer(x8, w8, affine, last=last, out_dtype=y_dtype)
                torch.cuda.synchronize()
                same = torch.equal(got, ref)
                err = (got.float() - ref.float()).abs().max().item()
                del got, ref
                k_ms = cuda_ms(lambda: q8chain._launch(x8, w8, affine, out_dtype or torch.int8, wk))
                p_ms = cuda_ms(lambda: q8chain.reference_q8_layer(x8, w8, affine, last=last, out_dtype=y_dtype), reps=2)
                out_item = 1 if out_dtype is None else torch.empty((), dtype=out_dtype).element_size()
                nbytes = BATCH * res * res * (cin + out_item * cout) + k * k * cin * cout + 8 * cout
                t_ops, t_bytes = ops / 1979e12, nbytes / PEAK_BYTES
                b_ms, b_by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"
                epi = "int8" if out_dtype is None else str(out_dtype)[6:]
                print(f"  {cin:4d}->{cout:4d} {k}x{k} @{res:3d} -> {epi:8s} {per_model}: equal {same} (max abs "
                      f"{err:.3g}) | {k_ms:.4f} {p_ms:.4f} {conv_ms:.4f} {mm_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
                      f"{ops / k_ms / 1e9:.2f} TOP/s" + ("" if same else "  <-- DISAGREES"))
                if not same:
                    raise RuntimeError(f"q8chain disagrees with its plain version at {(cin, cout, k, res, epi)}: {err}")
                count = per_model.get("ResUNet", 0)
                for glue in ((torch.float32, torch.bfloat16) if out_dtype is None else (out_dtype,)):
                    _add(totals[glue], count, k_ms, p_ms, conv_ms, b_ms, b_by, ops, err)
        del x8, w8, wk
    for glue, tot in totals.items():
        print(f"  {glue} glue: q8chain over one int8 ResUNet() forward's {tot['layers']} convs: kernel {tot['ms']:.3f} "
              f"ms ({tot['ops'] / tot['ms'] / 1e9:.2f} TOP/s), plain {tot['plain_ms']:.3f} ms, bf16 F.conv2d "
              f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    return totals


def run_q8_serving(device, seed, card, root, tmp, kind):
    """Phase 4b: predict_images with the full-width ``kind`` quantized to
    int8 (``quantize_resunet`` / ``quantize_rdresunet``, calibrated by
    ``calibrate_from_dataset`` on the TILES tiles), f32 and bf16 glue, two
    calls each, with tiles/s and the q8chain (and RDResUNet's rdtail)
    launches checked exactly; the relative L2 distance of the int8 output
    from the float model's on the card; one f32-glue tile held against the
    same executor on the CPU.  Returns the launches of each dtype's run."""
    import copy

    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.predict import predict_images
    from pssr2_tpu_torch.quant import calibrate_from_dataset, quantize_rdresunet, quantize_resunet

    state = _state(kind, seed)
    hr_res = LR_RES * SCALE
    dataset = ImageDataset(root, hr_res=hr_res, lr_scale=SCALE, val_split=1, crappifier=Poisson())
    np.random.seed(seed)
    calib = calibrate_from_dataset(dataset, n_batches=TILES // BATCH, batch_size=BATCH)
    quantize = quantize_resunet if kind == "ResUNet" else quantize_rdresunet
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        # the int8 convs, and RDResUNet's float encoder in the glue dtype
        per_fwd = dict.fromkeys(COUNTERS, 0)
        per_fwd["q8conv"] = sum(_int8_convs(kind).values())
        if kind == "RDResUNet":
            from pssr2_tpu_torch.ops.rdtail import FWD_LAUNCHES

            tails = len(rd_shapes()[1])
            per_fwd["rdtail_fwd"] = tails * FWD_LAUNCHES["tc" if dtype == torch.bfloat16 else "cuda_core"]
            per_fwd["rdtail_tc_fwd"] = tails if dtype == torch.bfloat16 else 0
        want = tuple(-(-TILES // BATCH) * per_fwd[c] for c in COUNTERS)
        model = _model(state, dtype, device, kind, train=False)
        start = time.perf_counter()
        q = quantize(model, calib)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - start
        out_dir = Path(tmp, f"preds_int8_{kind}_{str(dtype)[6:]}")
        launches[dtype] = (0,) * len(COUNTERS)
        for call in ("first", "second"):
            np.random.seed(seed)
            torch.cuda.synchronize()
            _reset_counts()
            start = time.perf_counter()
            predict_images(q, dataset, device=device, batch_size=BATCH, out_dir=str(out_dir))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            counts = _counts()
            launches[dtype] = tuple(a + b for a, b in zip(launches[dtype], counts))
            print(f"phase serving int8 {kind} {dtype} glue, {call} call: {TILES} tiles in {elapsed:.3f} s = "
                  f"{TILES / elapsed:.2f} tiles/s on {card} (quantized in {q_s:.2f} s, calibration included); "
                  f"launches {counts} (want {want})")
            if counts != want:
                raise RuntimeError(f"int8 {kind} serving launched {counts}, want {want}")
        if len(list(out_dir.glob("*.tif"))) != TILES:
            raise RuntimeError(f"int8 {kind}: predictions missing in {out_dir}")
        lr = torch.from_numpy(calib[0][:1])
        with torch.inference_mode():
            out = q(lr.to(device)).cpu()
            fp = model(lr.to(device)).cpu()
        if out.shape != (1, 1, hr_res, hr_res) or not torch.isfinite(out).all():
            raise RuntimeError(f"int8 {kind} output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
        dist = ((out - fp).norm() / fp.norm()).item()
        line = f"  int8 {kind} {dtype} glue: relative L2 from the float model on the card {dist:.4g}"
        if dtype == torch.float32:
            del model
            q_cpu = copy.deepcopy(q).cpu()
            start = time.perf_counter()
            with torch.inference_mode():
                ref = q_cpu(lr)
            err = ((out - ref).norm() / ref.norm()).item()
            line += (f"; card vs CPU on 1 tile: relative L2 {err:.3g} (bound {Q8_CPU_TOL}), max abs "
                     f"{(out - ref).abs().max().item():.3g}; CPU forward {time.perf_counter() - start:.1f} s")
            del q_cpu
            if not err <= Q8_CPU_TOL:
                print(line)
                raise RuntimeError(f"int8 {kind}: card output differs from the CPU by {err}")
        print(line)
        del q
    return launches


def _crap_per_step(train=True):
    """Launches of one train_crappifier step of the full-width ResUNet(scale=1):
    its convchain forwards and backwards and train-mode BatchNorm sums (as a
    ResUNet training step), the single-scale SSIM of the profiles (forward 1,
    backward 2), two soft histograms and one histogram backward (the target
    profile needs no gradient).  A validation step: the forwards only."""
    n = dict(zip(COUNTERS, _per_step(train=train)))
    n.update(ssim_pool_fwd=0, ssim_pool_bwd=0, ssim_l0_fwd=0, ssim_l0_bwd=0, gradhist_fwd=2,
             gradhist_bwd=1 if train else 0)
    return tuple(n[c] for c in COUNTERS)


def run_train_crappifier(device, seed, card, root, tmp):
    """Phase 7: ``train_crappifier`` with the full-width ResUNet(scale=1)
    (random weights from ``weights.seeded_jax_params(scale=1, seed)``) at
    batch 16 over the TILES tiles (host loader, Poisson noise, validation
    split CRAP_VAL_SPLIT): CRAP_EPOCHS[dtype] epochs in bf16 and in f32
    compute, the launches checked exactly, step and epoch times; then one
    f32 step on 2 samples held against the same step on the CPU by
    compare_cpu_step's rule.  Returns the launches of each dtype's run."""
    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.models import ResUNet
    from pssr2_tpu_torch.optim import AdamW, ReduceLROnPlateau
    from pssr2_tpu_torch.train import train_crappifier
    from pssr2_tpu_torch.weights import params_from_jax, seeded_jax_params

    state = params_from_jax(seeded_jax_params(HIDDEN, DEPTH, scale=1, seed=seed))
    dataset = ImageDataset(root, hr_res=LR_RES * SCALE, lr_scale=SCALE, crappifier=Poisson(),
                           val_split=CRAP_VAL_SPLIT)
    n_train, n_val = len(dataset) - len(dataset.val_idx), len(dataset.val_idx)
    n_batches, n_val_batches = -(-n_train // BATCH), -(-n_val // BATCH)

    class EpochClock(ReduceLROnPlateau):
        stamps = []

        def step(self, metric):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            super().step(metric)

    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        epochs = CRAP_EPOCHS[dtype]
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=1, dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
        optim = AdamW(LR_RATE)
        steps = []

        def stamp(local):
            torch.cuda.synchronize()
            steps.append((local["epoch"], local["batch_idx"], time.perf_counter(), local["loss"].item()))

        np.random.seed(seed)
        torch.cuda.synchronize()
        _reset_counts()
        start = time.perf_counter()
        EpochClock.stamps = [start]
        results = []
        _capture_stdout(lambda: results.append(train_crappifier(
            model, dataset, BATCH, optim, epochs, device=device, scheduler=EpochClock(optim), callbacks=[stamp],
            checkpoint_dir=str(Path(tmp, f"crap_ckpt_{str(dtype)[6:]}")))))
        counts = _counts()
        launches[dtype] = counts
        per_epoch = [_crap_per_step()] * n_batches + [_crap_per_step(train=False)] * n_val_batches
        want = tuple(epochs * sum(c) for c in zip(*per_epoch))
        step_ms = [1e3 * (b[2] - a[2]) for a, b in zip(steps, steps[1:]) if a[0] == b[0]]
        epoch_s = np.diff(EpochClock.stamps)
        train_losses, val_losses = results[0]
        finite = all(np.isfinite(v) for v in train_losses + val_losses)
        print(f"phase train_crappifier ResUNet(scale=1) {dtype} ({epochs} epochs) on {card}: {n_train} training and "
              f"{n_val} validation tiles an epoch at batch {BATCH} ({LR_RES}^2 noise profiles); step-to-step times "
              + ", ".join(f"{t:.2f}" for t in step_ms) + " ms (host loading included); epoch times "
              + ", ".join(f"{t:.3f}" for t in epoch_s) + f" s; train losses {train_losses}, val losses {val_losses}; "
              f"launches {counts} (want {want}, {', '.join(COUNTERS)})")
        if counts != want or not finite or len(val_losses) != epochs:
            raise RuntimeError(f"train_crappifier {dtype}: launches {counts} (want {want}), losses {results}")
        del model, optim

    # one f32 step on 2 samples, card vs CPU, by compare_cpu_step's rule
    from pssr2_tpu_torch.ops.gradhist import make_gradhist
    from pssr2_tpu_torch.train import _build_crappifier_steps
    from pssr2_tpu_torch.util import SSIMLoss

    step, _ = _build_crappifier_steps(make_gradhist(), SSIMLoss(ms=False), False, 3)
    np.random.seed(seed)
    items = [dataset[i] for i in range(2)]
    hr = torch.from_numpy(np.stack([it[0] for it in items]))
    lr = torch.from_numpy(np.stack([it[1] for it in items]))
    noise = torch.Generator().manual_seed(seed + 1)
    perturbed = {k: v * (1 + PERTURB * torch.randn(v.shape, generator=noise)) if v.is_floating_point() else v
                 for k, v in state.items()}
    runs, secs = [], []
    for dev, weights in ((device, state), (torch.device("cpu"), state), (torch.device("cpu"), perturbed)):
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=1, device=dev)
        model.load_state_dict(weights, strict=True)
        model.train()
        optimizer = AdamW(LR_RATE).init(model.parameters())
        start = time.perf_counter()
        loss, _ = step(model, optimizer, hr.to(dev), lr.to(dev), LR_RATE, 2, SCALE)
        runs.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {k: v.cpu() for k, v in model.state_dict().items()}))
        secs.append(time.perf_counter() - start)
        del model, optimizer
    got, worst = _step_diff(runs[0], runs[1])
    own, _ = _step_diff(runs[2], runs[1])
    got["loss"] /= abs(runs[1][0])  # relative: the loss's scale is that of the histograms
    own["loss"] /= abs(runs[1][0])
    limits = dict(STEP_TOL, **{k: SELF_FACTOR * own[k] for k in ("grad", "grads", "moved")})
    print(f"phase train_crappifier f32 card vs CPU, 1 step on 2 samples: loss {runs[0][0]:.7g} vs {runs[1][0]:.7g}; "
          + ", ".join(f"{k} {v:.3g} <= {limits[k]:.3g}" for k, v in got.items())
          + f" (largest gradient error in {worst}; loss relative); the CPU against itself with weights perturbed by "
          f"{PERTURB:g}: " + ", ".join(f"{k} {v:.3g}" for k, v in own.items())
          + f"; card step {secs[0]:.2f} s, CPU steps {secs[1]:.1f} s, {secs[2]:.1f} s")
    bad = {k: v for k, v in got.items() if not v <= limits[k]}
    if bad:
        raise RuntimeError(f"card crappifier step differs from the CPU: {bad}")
    return launches


def run_approximate_crappifier(seed, root):
    """Phase 8: ``approximate_crappifier(Poisson, [Real(0.5, 2)], ...)`` on the
    host (no kernel): a few objective calls on two tiles, to show the entry
    point runs on this machine."""
    import random

    from pssr2_tpu_torch import Poisson
    from pssr2_tpu_torch.bayes import Real
    from pssr2_tpu_torch.data import ImageDataset
    from pssr2_tpu_torch.train import approximate_crappifier

    np.random.seed(seed)
    random.seed(seed)
    dataset = ImageDataset(root, hr_res=LR_RES * SCALE, lr_scale=SCALE, crappifier=Poisson(intensity=1.2),
                           rotation=False, val_split=CRAP_VAL_SPLIT)
    start = time.perf_counter()
    res = approximate_crappifier(Poisson, [Real(0.5, 2)], dataset, max_images=2,
                                 opt_kwargs={"n_calls": 5, "n_initial_points": 3, "random_state": seed})
    secs = time.perf_counter() - start
    print(f"phase approximate_crappifier (host): Poisson intensity fit {res.x} (data made with 1.2), objective "
          f"{res.fun:.4g}, {len(res.func_vals)} calls in {secs:.2f} s")
    if not (0.5 <= res.x[0] <= 2 and np.isfinite(res.func_vals).all()):
        raise RuntimeError(f"approximate_crappifier: {res}")


def kernels_line(fwd, bwd, ssim, rd, swin, gh, cs, q8, launches):
    """The per-kernel entries of the JSON line.  ``launches[dtype]`` holds
    the counts of every main path in that dtype (serving, the training
    steps and train_paired of every model, int8 serving by glue dtype,
    train_crappifier), in the order of COUNTERS; the f32 SSIM kernels and the
    soft histograms count the runs of both dtypes.  The convchain times are
    those of one ResUNet forward or backward (36 layers), the rdtail times
    those of one RDResUNet forward or backward (21 tails), the swinblock
    times those of one SwinIR() forward or backward (16 blocks), the
    winattn times those of one forward of the SwinIR-L-width model (4
    blocks), the gradhist times those of one launch at (16, 16384) x 512,
    the chanstats times those of one ResUNet training step (11 launches),
    the q8chain times those of one int8 ResUNet() forward (46 convs)."""
    def total(name, dtype=None):
        i = COUNTERS.index(name)
        return sum(c[i] for dt, c in launches.items() if dtype in (None, dt))

    entries = []
    for name, totals, line in (("convchain_fwd", fwd, 185), ("convchain_bwd", bwd, 277)):
        for dtype, per_model in totals.items():
            tot = per_model["ResUNet"]
            entries.append((f"{name}[{str(dtype)[6:]}]", "convchain" if name == "convchain_fwd" else "convchain_bwd",
                            f"convchain.py:{line}", total(name, dtype),
                            dict(tot, bound_by=max(tot["bound_by"], key=tot["bound_by"].get))))
    for name, line in (("ssim_fwd", 239), ("ssim_bwd", 254), ("ssim_pool_fwd", 292), ("ssim_pool_bwd", 314),
                       ("ssim_l0_fwd", 354), ("ssim_l0_bwd", 380)):
        entries.append((name, "ssimfused", f"ssimfused.py:{line}", total(name), ssim[name]))
    for kind, line in (("fwd", 109), ("bwd", 117)):
        for dtype, tots in rd.items():
            tot = tots[kind]
            entries.append((f"rdtail_{kind}[{str(dtype)[6:]}]", "rdtail", f"rdtail.py:{line}",
                            total(f"rdtail_{kind}", dtype),
                            dict(tot, bound_by=max(tot["bound_by"], key=tot["bound_by"].get))))
    for name, kind, replaces in (("swinblock_fwd", "fwd", "swinblock.py:329"), ("swinblock_bwd", "bwd", "swinblock.py:561"),
                                 ("winattn", "winattn", "winattn.py:121")):
        for dtype, tots in swin.items():
            tot = tots[kind]
            entries.append((f"{name}[{str(dtype)[6:]}]", "swinblock", replaces, total(name, dtype),
                            dict(tot, bound_by=max(tot["bound_by"], key=tot["bound_by"].get))))
    for name, line in (("gradhist_fwd", 33), ("gradhist_bwd", 53)):
        entries.append((name, "gradhist", f"gradhist.py:{line}", total(name), gh[name]))
    for name, source, replaces, totals in (("chanstats", "chanstats", "chanstats.py:45", cs),
                                           ("q8conv", "q8chain", "q8chain.py:82", q8)):
        for dtype, tot in totals.items():
            entries.append((f"{name}[{str(dtype)[6:]}]", source, replaces, total(name, dtype),
                            dict(tot, bound_by=max(tot["bound_by"], key=tot["bound_by"].get))))
    kernels = []
    for name, source, replaces, n, tot in entries:
        if n == 0:
            raise RuntimeError(f"{name} was launched no time on the main paths")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pssr2_tpu_torch/csrc/{source}.cu",
            "replaces": f"pssr2_tpu/ops/pallas/{replaces}",
            "launches": n,
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
    check_sass(builds)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    fwd = check_kernels(device, gen)
    bwd = check_bwd(device, gen)
    ssim = check_ssim(device, gen)
    rd = check_rdtail(device, gen)
    check_ragged(device, gen)
    swin = check_swin(device, gen)
    gh = check_gradhist(device, gen)
    cs = check_chanstats(device, gen)
    q8 = check_q8(device, gen)
    launches = {dtype: (0,) * len(COUNTERS) for dtype in (torch.float32, torch.bfloat16)}

    def add(dtype, counts):
        launches[dtype] = tuple(a + b for a, b in zip(launches[dtype], counts))

    with tempfile.TemporaryDirectory(prefix="pssr2_smoke_") as tmp:
        root = Path(tmp, "hr")
        root.mkdir()
        write_tiles(root, args.seed)
        for kind in MODELS:
            calls = ("first", "second", "traced") if kind == "SwinIR" else ("first", "second")
            for dtype, counts in run_slice(device, args.seed, card, root, tmp, kind, calls).items():
                add(dtype, counts)
        for dtype, counts in run_slice(device, args.seed, card, root, tmp, "SwinIR-L", calls=("first",)).items():
            add(dtype, counts)
        for kind in ("ResUNet", "RDResUNet"):
            for dtype, counts in run_q8_serving(device, args.seed, card, root, tmp, kind).items():
                add(dtype, counts)
        for kind in MODELS:
            for dtype, counts in run_train(device, args.seed, card, root, kind).items():
                add(dtype, counts)
        compare_cpu_step(device, args.seed, root)
        add(torch.bfloat16, run_train_paired(device, args.seed, card, root, tmp, "ResUNet", TP_EPOCHS))
        for kind in ("RDResUNet", "SwinIR"):
            add(torch.bfloat16, run_train_paired(device, args.seed, card, root, tmp, kind, RD_TP_EPOCHS))
        for dtype, counts in run_train_crappifier(device, args.seed, card, root, tmp).items():
            add(dtype, counts)
        run_approximate_crappifier(args.seed, root)

    print(json.dumps({"kernels": kernels_line(fwd, bwd, ssim, rd, swin, gh, cs, q8, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
