"""PyTorch port: the plans of the scatter kernels K3 (MSDA dValue) and K6
(point-sampler dValue), and the plain versions they are held to.

Both kernels bin their corner adds by the pixel of a band of output rows in
shared memory, and sum each pixel once, when the band fits the plan's room;
otherwise they add straight into the output.  Here the
plans (tile sizes, band rule, shared-memory budget) are read from shapes at
the main path's sizes and at sizes that must take the direct adds; the
kernels run only on the card (``chip_smoke.py``,
``tools/torch_bench_scatter_variants.py``).  The plain versions are held to
``jax.vjp`` of the JAX package's functions on the inputs where the two
branches differ: unsorted, border and pixel-centre points for K6, local
(ring-init-like) sampling locations for K3.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.ops.point_sample as jps
from openvis_tpu.ops.msda import ms_deform_attn_xla
from openvis_tpu_torch.ops import msda_cuda, point_sample_cuda
from openvis_tpu_torch.ops.msda import ms_deform_attn_bwd_plain
from openvis_tpu_torch.ops.point_sample import sample_maps_dvalue_plain, sorted_uniform_points

CSRC = Path(msda_cuda.__file__).resolve().parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
TRAIN_LEVELS = [(15, 27), (30, 54), (60, 108)]
TRAIN_LEN = sum(h * w for h, w in TRAIN_LEVELS)
LOSS_CANDIDATES = (2, 40, 120, 216)


def _msda(b, levels, nh, ch, p, dtype=BF16, device="meta", lq=None):
    length = sum(h * w for h, w in levels)
    lq = length if lq is None else lq
    value = torch.empty(b, length, nh, ch, dtype=dtype, device=device)
    loc = torch.empty(b, lq, nh, len(levels), p, 2, device=device)
    grad = torch.empty(b, lq, nh * ch, dtype=dtype, device=device)
    return value, loc, grad


def _ring_locations(levels, b, nh, p, jitter=0.0, seed=0):
    """The encoder's samples at the ring-bias init: each query's reference
    point (its pixel centre) plus k = 1..p pixels along its head's direction,
    in every level; ``jitter`` pixels of Gaussian noise on top."""
    refs = []
    for h, w in levels:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([xx, yy], -1).reshape(-1, 2))
    ref = np.concatenate(refs)
    theta = np.arange(nh) * 2 * math.pi / nh
    d = np.stack([np.cos(theta), np.sin(theta)], -1)
    d /= np.abs(d).max(-1, keepdims=True)
    rng = np.random.RandomState(seed)
    loc = np.zeros((b, len(ref), nh, len(levels), p, 2), np.float32)
    for lvl, (h, w) in enumerate(levels):
        for k in range(p):
            step = (k + 1 + jitter * rng.randn(b, len(ref), nh, 2)) * d / np.array([w, h])
            loc[:, :, :, lvl, k] = ref[None, :, None] + step
    return loc.astype(np.float32)


# --- K3's plan ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_k3_plan_at_the_train_shape(dtype):
    value, loc, _ = _msda(2, TRAIN_LEVELS, 8, 32, 4, dtype)
    plan = msda_cuda.dvalue_plan(value, loc)
    assert (plan.vec, plan.lanes, plan.tile_queries) == (4, 8, msda_cuda.DV_TILE_QUERIES)
    # the sample table, the f32 gradient tile and the binned list
    assert plan.fixed_bytes == 64 * 4 * 24 + 64 * 32 * 4 + 64 * 4 * 16
    assert plan.smem_bytes <= msda_cuda.DV_SMEM_TARGET <= msda_cuda.MAX_SMEM
    assert plan.band_pixels == (msda_cuda.DV_MIN_BAND_BYTES - 4) // 8 <= 2 * 4 * 64 * 4
    assert plan.grid(2, TRAIN_LEN, 8) == (-(-TRAIN_LEN // 64), 8, 2)
    # a level-2 band of 7 rows (2 rows of reference points, 4 pixels of ring
    # offset, 1 corner row) is binned, and the 15-row band in level 2 of a
    # strip of level-0 queries; a whole random level 2 is not
    assert 15 * 108 <= plan.band_pixels < 60 * 108


@pytest.mark.parametrize("ch,dtype,vec,lanes", [
    (32, BF16, 4, 8), (32, F32, 4, 8), (20, BF16, 4, 8), (20, F32, 4, 8),
    (64, BF16, 4, 16), (3, F32, 1, 4), (1, F32, 1, 1), (300, BF16, 4, 32), (33, BF16, 1, 32),
])
def test_k3_plan_vector_width_follows_the_channels(ch, dtype, vec, lanes):
    value, loc, _ = _msda(1, [(6, 9), (3, 5)], 2, ch, 4, dtype, device="cpu", lq=7)
    plan = msda_cuda.dvalue_plan(value, loc)
    assert (plan.vec, plan.lanes) == (vec, lanes)
    assert plan.lanes * plan.vec >= min(ch, 32 * plan.vec)


@pytest.mark.parametrize("p,tq", [(4, 64), (100, 4), (1000, 1), (2400, 1)])
def test_k3_plan_tiles_shrink_to_keep_the_fixed_part_small(p, tq):
    value, loc, _ = _msda(1, [(6, 9)], 2, 32, p, F32)
    plan = msda_cuda.dvalue_plan(value, loc)
    assert plan.tile_queries == tq
    assert plan.smem_bytes <= msda_cuda.MAX_SMEM
    assert 4 * tq * p <= msda_cuda.DV_MAX_ENTRIES


def test_k3_plan_refuses_what_one_block_cannot_hold():
    value, loc, _ = _msda(1, [(6, 9)], 2, 32, 10_000, F32)
    with pytest.raises(ValueError, match="shared memory"):
        msda_cuda.dvalue_plan(value, loc)


@pytest.mark.parametrize("band_bytes,pixels", [(0, 0), (-5, 0), (1000, 124), (10 ** 9, None)])
def test_k3_plan_band_room_is_clamped(band_bytes, pixels):
    value, loc, _ = _msda(2, TRAIN_LEVELS, 8, 32, 4)
    plan = msda_cuda.dvalue_plan(value, loc, band_bytes)
    if pixels is None:
        assert plan.smem_bytes <= msda_cuda.MAX_SMEM < plan.smem_bytes + 16
    else:
        assert plan.band_pixels == pixels


def test_k3_band_share_random_locations_take_the_direct_adds():
    """Uniform locations make bands as tall as each level: the two small
    levels (405 and 1620 pixels) are binned whole, the 6480-pixel one is
    not, so about two thirds of the corner adds are binned; with no band
    room, none are."""
    rng = np.random.RandomState(0)
    value, _, _ = _msda(2, TRAIN_LEVELS, 8, 32, 4)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, TRAIN_LEN, 8, 3, 4, 2)).astype(np.float32))
    plan = msda_cuda.dvalue_plan(value, loc)
    assert 0.63 < msda_cuda.band_share(TRAIN_LEVELS, loc, plan) < 0.70
    nothing = msda_cuda.dvalue_plan(value, loc, band_bytes=0)
    assert msda_cuda.band_share(TRAIN_LEVELS, loc, nothing) == 0.0


def test_k3_band_share_ring_init_locations_take_the_band():
    value, _, _ = _msda(2, TRAIN_LEVELS, 8, 32, 4)
    loc = torch.from_numpy(_ring_locations(TRAIN_LEVELS, 2, 8, 4))
    plan = msda_cuda.dvalue_plan(value, loc)
    assert msda_cuda.band_share(TRAIN_LEVELS, loc, plan) > 0.95


def test_k3_band_rule_flips_at_the_band_room():
    """One tile whose corners span rows 2..4 of a 6x9 level: 27 pixels are
    binned with room for 27, added straight with room for 26."""
    value, _, _ = _msda(1, [(6, 9)], 1, 32, 1, F32, lq=4)
    loc = torch.zeros(1, 4, 1, 1, 1, 2)
    loc[..., 0] = torch.tensor([0.1, 0.3, 0.5, 0.9]).view(1, 4, 1, 1, 1)
    loc[..., 1] = torch.tensor([2.5, 3.2, 3.9, 2.6]).view(1, 4, 1, 1, 1) / 6
    fits = msda_cuda.dvalue_plan(value, loc, band_bytes=4 + 8 * 27)
    short = msda_cuda.dvalue_plan(value, loc, band_bytes=4 + 8 * 26)
    assert (fits.band_pixels, short.band_pixels) == (27, 26)
    assert msda_cuda.band_share([(6, 9)], loc, fits) == 1.0
    assert msda_cuda.band_share([(6, 9)], loc, short) == 0.0


# --- K6's plan ---------------------------------------------------------------

@pytest.mark.parametrize("p,tp", [(37632, 320), (12544, 128), (3136, 32), (10, 32)])
def test_k6_plan_tiles(p, tp):
    plan = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, p)
    assert plan.tile_points == tp and plan.tile_points % 32 == 0
    assert plan.row_chunk == point_sample_cuda.ROW_CHUNK
    assert plan.smem_bytes <= point_sample_cuda.SMEM_TARGET <= point_sample_cuda.MAX_SMEM
    assert plan.grid(2, 40, p) == (-(-p // tp), 5, 2)


def test_k6_plan_many_points_fill_the_target_with_their_table():
    plan = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, 10 ** 6)
    assert plan.tile_points == point_sample_cuda.MAX_TILE_POINTS
    assert plan.band_pixels == 0 and plan.smem_bytes <= point_sample_cuda.MAX_SMEM


def test_k6_plan_at_the_loss_candidates_bins_a_band_of_five_rows():
    """320 y-sorted points span ~1 of 120 rows: with the corners ~3 rows."""
    plan = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, 37632)
    assert 5 * 216 <= plan.band_pixels < 120 * 216


@pytest.mark.parametrize("rows,chunk", [(1, 1), (3, 3), (8, 8), (40, 8), (100, 8)])
def test_k6_plan_row_chunks(rows, chunk):
    assert point_sample_cuda.dvalue_plan((1, rows, 120, 216), 3136).row_chunk == chunk


def test_k6_band_share_sorted_points_take_the_band_unsorted_do_not():
    gen = torch.Generator().manual_seed(0)
    pts = sorted_uniform_points(gen, (2,), 37632)
    plan = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, 37632)
    assert point_sample_cuda.band_share(pts, LOSS_CANDIDATES, plan) == 1.0
    shuffled = pts[:, torch.randperm(37632, generator=gen)]
    assert point_sample_cuda.band_share(shuffled, LOSS_CANDIDATES, plan) == 0.0
    none = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, 37632, band_bytes=0)
    assert point_sample_cuda.band_share(pts, LOSS_CANDIDATES, none) == 0.0


@pytest.mark.parametrize("p,bins", [(37632, True), (12544, True), (3136, False)])
def test_k6_sparse_tiles_take_the_direct_adds(p, bins):
    """The plan bins a band of at most 2 pixels per corner add: the 3136
    random points' tiles (32 points, 128 adds over a band of ~3 x 216
    pixels) add straight to the output; forced room bins them."""
    pts = sorted_uniform_points(torch.Generator().manual_seed(1), (2,), p)
    plan = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, p)
    assert plan.band_pixels <= point_sample_cuda.BIN_PIXELS_PER_ADD * 4 * plan.tile_points
    assert (point_sample_cuda.band_share(pts, LOSS_CANDIDATES, plan) > 0.9) == bins
    forced = point_sample_cuda.dvalue_plan(LOSS_CANDIDATES, p, band_bytes=32 * 1024)
    assert point_sample_cuda.band_share(pts, LOSS_CANDIDATES, forced) == 1.0


def test_k6_band_rule_flips_at_the_band_room():
    """Points whose corners span rows 3..5 of 12x20 maps: 60 pixels are
    binned with room for 60, added straight with room for 59."""
    pts = torch.tensor([[[0.1, 3.5 / 12], [0.5, 4.2 / 12], [0.9, 4.9 / 12]]])
    shape = (1, 2, 12, 20)
    fits = point_sample_cuda.dvalue_plan(shape, 3, band_bytes=4 + 8 * 60)
    short = point_sample_cuda.dvalue_plan(shape, 3, band_bytes=4 + 8 * 59)
    assert (fits.band_pixels, short.band_pixels) == (60, 59)
    assert point_sample_cuda.band_share(pts, shape, fits) == 1.0
    assert point_sample_cuda.band_share(pts, shape, short) == 0.0


# --- the C sources and the wrappers -------------------------------------------

def test_python_constants_match_the_sources():
    ps = (CSRC / "point_sample.cu").read_text()
    assert int(re.search(r"kMaxTilePoints = (\d+);", ps).group(1)) == (
        point_sample_cuda.MAX_TILE_POINTS)
    assert int(re.search(r"kTableBytes = (\d+);", ps).group(1)) == point_sample_cuda.TABLE_BYTES
    assert int(re.search(r"kListBytes = (\d+);", ps).group(1)) == point_sample_cuda.LIST_BYTES
    assert int(re.search(r"kMaxRowChunk = (\d+);", ps).group(1)) == point_sample_cuda.ROW_CHUNK
    assert eval(re.search(r"kMaxSmem = ([\d -]+);", ps).group(1)) == point_sample_cuda.MAX_SMEM
    bwd = (CSRC / "msda_bwd.cu").read_text()
    assert int(re.search(r"kDvTableBytes = (\d+);", bwd).group(1)) == msda_cuda.DV_TABLE_BYTES
    assert int(re.search(r"kDvListBytes = (\d+);", bwd).group(1)) == msda_cuda.DV_LIST_BYTES
    assert eval(re.search(r"kDvMaxEntries = ([\d <]+);", bwd).group(1)) == msda_cuda.DV_MAX_ENTRIES
    assert eval(re.search(r"kMaxSmem = ([\d -]+);", bwd).group(1)) == msda_cuda.MAX_SMEM
    common = (CSRC / "scatter_common.cuh").read_text()
    assert int(re.search(r"kThreads = (\d+);", common).group(1)) == point_sample_cuda.THREADS
    for source in ("point_sample.cu", "msda_bwd.cu"):
        assert '#include "scatter_common.cuh"' in (CSRC / source).read_text()
    # the level table reaches K3 through the constant bank, not the stack
    params = re.search(r"void __launch_bounds__\(kThreads\) msda_dvalue_kernel\((.*?)\) \{", bwd, re.S)
    assert params.group(1).rstrip().endswith("const __grid_constant__ Levels lv")


def test_the_scatter_wrappers_reject_cpu_tensors():
    coords = torch.rand(1, 5, 2)
    grad = torch.randn(1, 2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_dvalue_cuda(coords, grad, (1, 2, 4, 4), F32)
    value, loc, g = _msda(1, [(3, 4)], 2, 8, 2, F32, device="cpu", lq=3)
    attn = torch.rand(1, 3, 2, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_dvalue_cuda(value, [(3, 4)], loc.uniform_(), attn, g)


# --- the plain versions against the JAX package ---------------------------------

def _k6_points(kind, rng, h, w, p):
    e = rng.exponential(size=p + 1)
    s = np.cumsum(e)
    pts = np.stack([rng.rand(p), s[:-1] / s[-1]], -1)
    if kind == "unsorted":
        pts = pts[rng.permutation(p)]
    elif kind == "border_centres":
        n = p // 3
        pts[:n, 0] = (rng.randint(-1, w, n) + 0.5) / w   # pixel centres, x from -1 to W-1
        pts[:n, 1] = (rng.randint(-1, h, n) + 0.5) / h
        pts[n:2 * n, 0] = np.where(rng.rand(n) < 0.5, -0.5 / w, (w - 0.5) / w)  # the borders
    return pts.astype(np.float32)


@pytest.mark.parametrize("kind", ["unsorted", "border_centres"])
def test_plain_k6_matches_jax_vjp(kind):
    """f32 on both sides; each output element sums at most four products
    per point in another order: 1e-5 relative plus 1e-6."""
    rng = np.random.RandomState(1)
    b, r, h, w, p = 2, 5, 12, 20, 400
    maps = rng.randn(b, r, h, w).astype(np.float32)
    g = rng.randn(b, r, p).astype(np.float32)
    coords = np.stack([_k6_points(kind, rng, h, w, p) for _ in range(b)])
    got = sample_maps_dvalue_plain(torch.from_numpy(maps), torch.from_numpy(coords),
                                   torch.from_numpy(g)).numpy()
    for i in range(b):
        fn = lambda m: jps.point_sample_shared(m, jnp.asarray(coords[i]))
        _, vjp = jax.vjp(fn, jnp.asarray(maps[i]))
        ref = np.asarray(vjp(jnp.asarray(g[i]))[0])
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_plain_k3_on_local_locations_matches_jax_vjp(jitter):
    """The encoder's ring-init samples (``jitter`` 0: exactly the ring) and
    samples moved off it, f32: within 1e-5 of the largest element."""
    levels = [(6, 9), (3, 5), (2, 2)]
    b, nh, ch, p = 2, 4, 8, 4
    length = sum(h * w for h, w in levels)
    rng = np.random.RandomState(2)
    value = rng.randn(b, length, nh, ch).astype(np.float32)
    loc = _ring_locations(levels, b, nh, p, jitter, seed=3)
    attn = rng.rand(b, length, nh, len(levels), p).astype(np.float32)
    g = rng.randn(b, length, nh * ch).astype(np.float32)
    got = ms_deform_attn_bwd_plain(torch.from_numpy(value), levels, torch.from_numpy(loc),
                                   torch.from_numpy(attn), torch.from_numpy(g),
                                   dcoords=False)[0].numpy()
    _, vjp = jax.vjp(lambda v: ms_deform_attn_xla(v, levels, jnp.asarray(loc), jnp.asarray(attn)),
                     jnp.asarray(value))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
