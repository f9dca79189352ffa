"""The tilings of the f32 CUDA-core kernels, on the CPU.

``ops/rdtail.py:f32_plan`` and ``f32_fwd_plan`` tile the RDNet tail's
CUDA-core backward and forward (``csrc/rdtail.cu`` on
``csrc/f32gemm.cuh``), ``ops/swinblock.py:f32_plan`` the Swin block's
CUDA-core backward (``csrc/swinblock.cu``), and ``ops/convchain.py``'s
``f32_dx_plan`` / ``f32_dw_plan`` the convchain f32 backward
(``csrc/convchain_bwd.cu``).  For every RDNet tail and every convchain
layer of the full-width models at batch 16 (``chip_smoke.rd_shapes`` and
``conv_shapes``), the default SwinIR's blocks at batch 16 and 1, and for
ragged shapes, each launch's blocks fit the H100's 232,448 bytes of shared
memory and the 65,535 limit on grid.y and grid.z, and they cover every
row, window, pixel and channel of their outputs exactly once, except the
K shares that atomics sum; the launch counts are the modules'
FWD_LAUNCHES and BWD_LAUNCHES.  The block arithmetic here is the kernels'
own, mirrored.
"""

import numpy as np
import pytest

import chip_smoke
from pssr2_tpu_torch.ops import convchain, rdtail, swinblock

SMEM_LIMIT = 232448
GRID_YZ = 65535
GRID_X = 2**31 - 1

RD_TAILS = chip_smoke.rd_shapes()[1]
# (M, C, inter, G): M off the 128-row tile, C, inter and G off the 128 and
# 64 column tiles, and sizes that are no multiple of 8 (the CUDA-core
# route's bf16 shapes), the largest C and G the kernels take
RD_RAGGED = [(4097, 232, 928, 104), (300, 40, 160, 24), (4097, 40, 160, 24), (300, 232, 928, 104),
             (100, 37, 75, 13), (64, rdtail.MAX_C, 160, rdtail.MAX_G)]
CONV_LAYERS = [(chip_smoke.BATCH, res, res, cin, cout) for cin, cout, res in chip_smoke.conv_shapes()]
# (N, H, W, Cin, Cout): one and three input channels, 96 outputs, images of
# 8 and 13 pixels (a ragged sub-tile)
CONV_RAGGED = [(2, 8, 8, 1, 96), (2, 13, 13, 3, 96), (2, 13, 13, 1, 96), (2, 8, 8, 3, 96)]


def _partition(ranges, end):
    """Whether the sorted distinct ``ranges`` tile [0, end) with no gap and
    no overlap, none empty."""
    ranges = sorted(set(ranges))
    return (ranges[0][0] == 0 and ranges[-1][1] == end and all(a < b for a, b in ranges)
            and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])))


@pytest.mark.parametrize("shape", RD_TAILS + RD_RAGGED,
                         ids=[f"tail{i}-" + "x".join(map(str, s)) for i, s in enumerate(RD_TAILS)]
                         + ["ragged-" + "x".join(map(str, s)) for s in RD_RAGGED])
def test_rdtail_f32_plan_fits_and_covers(shape):
    """The rows launch's grid covers every row and I column once; the GEMM
    launch's blocks cover dh (M x C), dW1 (C x I) and dW2 (I x G) tile by
    tile once, each tile's K in whole F32_BK shares that partition it;
    the row kernels cover every row; four launches."""
    m, c, inter, g = shape
    plan = rdtail.f32_plan(*shape)
    bn, (gx, gy) = plan["rows"]
    assert bn in (64, 128) and rdtail.f32_rows_smem(bn) <= SMEM_LIMIT
    assert gy <= GRID_YZ and gx <= GRID_X
    assert (gx - 1) * rdtail.F32_BM < m <= gx * rdtail.F32_BM and (gy - 1) * bn < inter <= gy * bn
    assert (plan["ln_blocks"] - 1) * rdtail.F32_LN_ROWS < m <= plan["ln_blocks"] * rdtail.F32_LN_ROWS

    jobs = plan["jobs"]
    assert rdtail.f32_jobs_smem() <= SMEM_LIMIT
    blocks = rdtail.f32_jobs_blocks(plan)
    assert len(blocks) <= GRID_X
    dims = {"dh": (m, c, inter), "dw1": (c, inter, m), "dw2": (inter, g, m)}
    assert [job[0] for job in jobs] == list(dims)
    for name, _, _, _, bn, kps, splits, _, _ in jobs:
        assert bn in (64, 128) and kps % rdtail.F32_BK == 0 and (splits - 1) * kps < dims[name][2] <= splits * kps
    for name, (mm, nn, k) in dims.items():
        tiles = {}
        for b_name, rows, cols, ks in blocks:
            if b_name == name:
                tiles.setdefault((rows, cols), []).append(ks)
        row_ranges = {rows for rows, _ in tiles}
        col_ranges = {cols for _, cols in tiles}
        assert _partition(row_ranges, mm) and _partition(col_ranges, nn), name
        assert len(tiles) == len(row_ranges) * len(col_ranges), name
        for ks in tiles.values():
            assert len(ks) == len(set(ks)) and _partition(ks, k), name
            assert all(k0 % rdtail.F32_BK == 0 for k0, _ in ks)
    assert len(plan["launches"]) == rdtail.BWD_LAUNCHES["cuda_core"] == 4


@pytest.mark.parametrize("shape", CONV_LAYERS + CONV_RAGGED,
                         ids=["layer-" + "x".join(map(str, s)) for s in CONV_LAYERS]
                         + ["ragged-" + "x".join(map(str, s)) for s in CONV_RAGGED])
def test_convchain_f32_plan_fits_and_covers(shape):
    """dx: two sub-tiles a block cover every pixel once, the Cin tiles every
    input channel once; dW: the (Cin, Cout) tiles cover every channel pair
    once and each tile's splits partition the sub-tiles (every pixel once);
    two launches."""
    n, h, w, cin, cout = shape
    n_sub = convchain.sub_tiles(n, h, w)
    covered = np.zeros((n, h, w), dtype=np.int64)
    for t in range(n_sub):
        img, h0, w0 = convchain.sub_tile_origin(t, n, h, w)
        covered[img, h0:h0 + convchain.TILE, w0:w0 + convchain.TILE] += 1
    assert (covered == 1).all()

    bn, (gx, gy) = convchain.f32_dx_plan(n, h, w, cin)
    assert bn in (16, 32, 64, 128) and convchain.f32_dx_smem(bn) <= SMEM_LIMIT
    assert gy <= GRID_YZ and gx <= GRID_X
    subs = sorted(t for bx in range(gx) for t in (2 * bx, 2 * bx + 1) if t < n_sub)
    assert subs == list(range(n_sub)) and 2 * gx - 1 <= n_sub <= 2 * gx
    assert (gy - 1) * bn < cin <= gy * bn

    gx, gy, splits = convchain.f32_dw_plan(n, h, w, cin, cout)
    assert convchain.f32_dw_smem() <= SMEM_LIMIT and gy <= GRID_YZ and splits <= GRID_YZ and gx <= GRID_X
    assert (gx - 1) * convchain.F32_DW_CI < cin <= gx * convchain.F32_DW_CI
    assert (gy - 1) * convchain.F32_DW_CO < cout <= gy * convchain.F32_DW_CO
    shares = [list(range(z, n_sub, splits)) for z in range(splits)]
    assert all(shares) and sorted(t for share in shares for t in share) == list(range(n_sub))
    assert convchain.BWD_LAUNCHES == 2


def _check_jobs(jobs, blocks, dims, bk):
    """Each job's blocks cover its output tile by tile once, each tile's K
    in whole ``bk`` shares that partition it."""
    assert [job[0] for job in jobs] == list(dims)
    for name, _, _, _, bn, kps, splits, _, _ in jobs:
        assert bn in (64, 128) and kps % bk == 0 and (splits - 1) * kps < dims[name][2] <= splits * kps
    for name, (mm, nn, k) in dims.items():
        tiles = {}
        for b_name, rows, cols, ks in blocks:
            if b_name == name:
                tiles.setdefault((rows, cols), []).append(ks)
        row_ranges = {rows for rows, _ in tiles}
        col_ranges = {cols for _, cols in tiles}
        assert _partition(row_ranges, mm) and _partition(col_ranges, nn), name
        assert len(tiles) == len(row_ranges) * len(col_ranges), name
        for ks in tiles.values():
            assert len(ks) == len(set(ks)) and _partition(ks, k), name
            assert all(k0 % bk == 0 for k0, _ in ks)


def _grid_covers(grid, bn, m, n):
    """A (row tiles, column tiles) grid of F32_BM x bn blocks covers an m x
    n output once, within the grid limits."""
    gx, gy = grid
    return (gy <= GRID_YZ and gx <= GRID_X and (gx - 1) * rdtail.F32_BM < m <= gx * rdtail.F32_BM
            and (gy - 1) * bn < n <= gy * bn)


@pytest.mark.parametrize("shape", RD_TAILS + RD_RAGGED,
                         ids=[f"tail{i}-" + "x".join(map(str, s)) for i, s in enumerate(RD_TAILS)]
                         + ["ragged-" + "x".join(map(str, s)) for s in RD_RAGGED])
def test_rdtail_f32_fwd_plan_fits_and_covers(shape):
    """fc1's grid covers every row and I column once; fc2's blocks cover
    every row and G column once a share, and the shares partition I in
    whole F32_BK steps; the LayerNorm covers every row; three launches."""
    m, c, inter, g = shape
    plan = rdtail.f32_fwd_plan(*shape)
    bn, grid = plan["fc1"]
    assert bn in (64, 128) and rdtail.f32_jobs_smem() <= SMEM_LIMIT and _grid_covers(grid, bn, m, inter)
    bn, kps, splits, (gx, gy) = plan["fc2"]
    tiles_m = -(-m // rdtail.F32_BM)
    assert bn in (64, 128) and kps % rdtail.F32_BK == 0 and gx == tiles_m * splits
    assert _grid_covers((tiles_m, gy), bn, m, g) and gx <= GRID_X
    shares = [(z * kps, min(inter, z * kps + kps)) for z in range(splits)]
    assert _partition(shares, inter)
    assert (plan["ln_blocks"] - 1) * rdtail.F32_LN_ROWS < m <= plan["ln_blocks"] * rdtail.F32_LN_ROWS
    assert len(plan["launches"]) == rdtail.FWD_LAUNCHES["cuda_core"] == 3


# (B, H, W, C, heads, ws, hidden): the default SwinIR's blocks at batch 16
# and 1; then M off the 128-row tile, C and hidden off 16, windows of 4 x 4,
# 5 x 5 and 6 x 6, heads of 10-30 channels, the largest C and hidden
SWIN_BLOCKS = [(16, 128, 128, 96, 6, 8, 192), (1, 128, 128, 96, 6, 8, 192), (3, 40, 40, 72, 6, 8, 150),
               (2, 20, 20, 40, 4, 5, 100), (1, 24, 24, 120, 4, 6, 200), (1, 24, 16, 60, 4, 4, 120),
               (1, 16, 16, swinblock.MAX_C, 6, 8, swinblock.MAX_HIDDEN)]


@pytest.mark.parametrize("shape", SWIN_BLOCKS, ids=lambda s: "x".join(map(str, s)))
def test_swinblock_f32_plan_fits_and_covers(shape):
    """Every token product and the MLP rows cover their M x N output once;
    each attention kernel's blocks take every window of each head exactly
    once and fit the card's shared memory; the weight-gradient launch's
    blocks cover dWqkv, dWp, dW1 and dW2 tile by tile once, K = M in
    partitioning shares; thirteen launches."""
    b, h, w, c, heads, ws, hidden = shape
    m, nwin = b * h * w, b * h * w // (ws * ws)
    plan = swinblock.f32_plan(m, c, hidden, heads, ws)
    widths = {"qkv": 3 * c, "proj": c, "dh2": c, "datt": c, "dh1": c}
    assert set(plan["tok"]) == set(widths)
    for name, (bn, grid) in plan["tok"].items():
        assert bn in (64, 128) and swinblock.f32_tok_smem(bn) <= SMEM_LIMIT
        assert _grid_covers(grid, bn, m, widths[name]), name
    bn, grid = plan["mlp"]
    assert bn in (64, 128) and rdtail.f32_rows_smem(bn) <= SMEM_LIMIT and _grid_covers(grid, bn, m, hidden)
    dp, fwd_blocks, bwd_blocks = plan["attn"]
    assert dp in swinblock.ATTN_DP and c // heads <= dp and swinblock.f32_attn_smem(dp) <= SMEM_LIMIT
    for blocks in (fwd_blocks, bwd_blocks):
        assert 1 <= blocks <= min(nwin, GRID_X) and heads <= GRID_YZ
        taken = sorted(win for x in range(blocks) for win in range(x, nwin, blocks))
        assert taken == list(range(nwin))
    per_sm = swinblock.SM_SMEM // (swinblock.f32_attn_smem(dp) + 1024)
    assert bwd_blocks <= -(-min(swinblock.ATTN_BLOCKS["bwd"], per_sm) * swinblock.SMS // heads)
    dims = {"dwqkv": (c, 3 * c, m), "dwproj": (c, c, m), "dw1": (c, hidden, m), "dw2": (hidden, c, m)}
    blocks = rdtail.f32_jobs_blocks(plan)
    assert len(blocks) <= GRID_X and rdtail.f32_jobs_smem() <= SMEM_LIMIT
    _check_jobs(plan["jobs"], blocks, dims, rdtail.F32_BK)
    assert (plan["ln_blocks"] - 1) * rdtail.F32_LN_ROWS < m <= plan["ln_blocks"] * rdtail.F32_LN_ROWS
    assert len(plan["launches"]) == swinblock.BWD_LAUNCHES["cuda_core"] == 13
    tiling = list(swinblock.f32_tiling(plan))
    assert len(tiling) == 16 and tiling[6:8] == [fwd_blocks, bwd_blocks]
