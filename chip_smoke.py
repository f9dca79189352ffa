#!/usr/bin/env python3
"""Smoke run of pssr2_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--seed S]

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the CUDA kernels are compiled with nvcc (seconds, registers and
   spills printed);
3. kernels: each kernel against its plain PyTorch version on the card, at
   every distinct layer shape of the full-width ResUNet x4 at batch 16, in
   f32 and bf16, with the prologue on and off, with times (CUDA events);
4. slice: ``predict_images`` with the full-width ``ResUNet()`` x4 on 32
   synthetic 128^2 -> 512^2 tiles in f32 and bf16, with the kernels'
   launch counts read around each run, and two f32 tiles held against the
   same model on the CPU (plain versions).

The last two lines are a JSON line of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  This script imports nothing of
JAX and nothing of the JAX package.
"""

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, f32 on
# the CUDA cores, and the HBM3 rate.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

HIDDEN, DEPTH, SCALE, LR_RES, BATCH, TILES = [64, 128, 256, 512, 1024], 3, 4, 128, 16, 32
# The f32 card output against the same model on the CPU, on the [0, 255]
# scale: only the order of f32 summation differs, through 45 layers.
CPU_TOL = 0.05


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


def bound_ms(n, res, cin, cout, dtype):
    """Least time for one layer: each input read once and each output
    written once over the memory rate, against the operations over the
    peak rate of the dtype.  -> (ms, "bytes" | "operations")."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (n * res * res * (cin + cout) + 9 * cin * cout + cout) + 4 * (2 * cin + 2 * cout)
    ops = 2.0 * n * res * res * 9 * cin * cout
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def check_kernels(device, gen):
    """Phase 3: the convchain kernel against reference_layer at every layer
    shape; returns per-dtype totals over one forward."""
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
                ok = all(err <= bound for err, _, bound in errs.values())
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


def run_slice(device, seed, card):
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
    with tempfile.TemporaryDirectory(prefix="pssr2_smoke_") as tmp:
        root = Path(tmp, "hr")
        root.mkdir()
        rng = np.random.default_rng(seed)
        hr_res = LR_RES * SCALE
        yy, xx = np.mgrid[0:hr_res, 0:hr_res]
        for i in range(TILES):
            f = rng.uniform(0.02, 0.2, 2)
            img = 120 + 90 * np.sin(xx * f[0] + i) * np.cos(yy * f[1]) + rng.normal(0, 10, (hr_res, hr_res))
            tiff.imwrite(root / f"tile_{i:02d}.tif", np.clip(img, 0, 255).astype(np.uint8))
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
                f"phase slice {dtype}: {TILES} tiles {LR_RES}^2 -> {hr_res}^2 in {elapsed:.3f} s = "
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

    _, secs, log = cuda_build.build("convchain")
    print(f"phase build: convchain.cu in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    gen = torch.Generator(device=device).manual_seed(args.seed)
    totals = check_kernels(device, gen)
    launches = run_slice(device, args.seed, card)

    kernels = []
    for dtype, tot in totals.items():
        kernels.append({
            "name": f"convchain_fwd[{str(dtype)[6:]}]",
            "route": "cuda",
            "source": "pssr2_tpu_torch/csrc/convchain.cu",
            "replaces": "pssr2_tpu/ops/pallas/convchain.py:185",
            "launches": launches[dtype],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": max(tot["bound_by"], key=tot["bound_by"].get),
            "library_ms": tot["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
