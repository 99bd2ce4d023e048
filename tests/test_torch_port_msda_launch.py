"""PyTorch port: which instantiation of the MSDA kernels K1 (forward) and K2
(dCoord) ``msda_cuda.launch_plan`` selects, and the grid it computes.

The kernels themselves run only on the card (``chip_smoke.py``); here the
plan is read from the tensors' shapes, dtypes and data pointers, with meta
tensors standing in for shapes too large to allocate.
"""

import re
from pathlib import Path

import pytest
import torch

from openvis_tpu_torch.ops import cuda_build, msda_cuda
from openvis_tpu_torch.ops.msda_cuda import (
    GENERIC,
    MAIN,
    MAIN_SHAPE,
    THREADS,
    launch_plan,
)

CSRC = Path(msda_cuda.__file__).resolve().parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


def _tensors(b, levels, nh, ch, p, lq, dtype=BF16, adtype=None, device="meta"):
    length = sum(h * w for h, w in levels)
    value = torch.empty(b, length, nh, ch, dtype=dtype, device=device)
    loc = torch.empty(b, lq, nh, len(levels), p, 2, device=device)
    attn = torch.empty(b, lq, nh, len(levels), p, dtype=adtype or dtype, device=device)
    grad = torch.empty(b, lq, nh * ch, dtype=dtype, device=device)
    return value, loc, attn, grad


def _shifted(t):
    """A copy of ``t`` whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out


EVAL = [(12, 20), (24, 40), (48, 80)]
TRAIN = [(15, 27), (30, 54), (60, 108)]


@pytest.mark.parametrize("levels,b,dtype,adtype", [
    (EVAL, 10, BF16, BF16), (EVAL, 10, F32, F32), (TRAIN, 2, BF16, BF16),
    (TRAIN, 2, F32, F32), (TRAIN, 2, BF16, F32), (TRAIN, 2, F32, BF16),
])
def test_main_path_shapes_take_the_specialisation(levels, b, dtype, adtype):
    lq = sum(h * w for h, w in levels)
    value, loc, attn, grad = _tensors(b, levels, 8, 32, 4, lq, dtype, adtype)
    vec = 16 // value.element_size()
    for plan in (launch_plan(value, loc, attn), launch_plan(value, loc, attn, grad)):
        assert (plan.variant, plan.vec, plan.lanes) == (MAIN, vec, 32 // vec)


@pytest.mark.parametrize("case,k1,k2", [
    ("main_shape_aligned", MAIN, MAIN),
    ("one_level", GENERIC, GENERIC),
    ("two_points", GENERIC, GENERIC),
    ("channels_not_a_vector", GENERIC, GENERIC),
    ("value_misaligned", GENERIC, GENERIC),
    ("grad_misaligned", MAIN, GENERIC),
    ("loc_misaligned", GENERIC, GENERIC),
    ("attn_misaligned", GENERIC, GENERIC),
    ("offsets_beyond_int32", GENERIC, GENERIC),
])
def test_variant_follows_shape_and_alignment(case, k1, k2):
    shapes = {"one_level": ([(6, 9)], 32, 4), "two_points": ([(6, 9), (3, 5), (2, 2)], 32, 2),
              "channels_not_a_vector": ([(6, 9), (3, 5), (2, 2)], 20, 4)}
    levels, ch, p = shapes.get(case, ([(6, 9), (3, 5), (2, 2)], 32, 4))
    device = "cpu"
    if case == "offsets_beyond_int32":  # 2**31 value elements in one batch item
        levels, device = [(2 ** 13, 2 ** 10), (1, 1), (1, 1)], "meta"
    value, loc, attn, grad = _tensors(1, levels, 8 if device == "meta" else 2, ch, p, 5,
                                      device=device)
    if case == "value_misaligned":
        value = _shifted(value)
    elif case == "grad_misaligned":
        grad = _shifted(grad)
    elif case == "loc_misaligned":
        loc = _shifted(loc)
    elif case == "attn_misaligned":
        attn = _shifted(attn)
    assert launch_plan(value, loc, attn).variant == k1
    assert launch_plan(value, loc, attn, grad).variant == k2


@pytest.mark.parametrize("ch,dtype,vec,lanes", [
    (32, BF16, 8, 4), (32, F32, 4, 8), (16, F32, 1, 16), (256, BF16, 1, 32),
    (512, BF16, 1, 32), (3, F32, 1, 4), (33, BF16, 1, 32), (1, F32, 1, 1),
])
def test_grid_and_block(ch, dtype, vec, lanes):
    b, lq, nh = 3, 77, 5
    value, loc, attn, _ = _tensors(b, [(6, 9), (3, 5), (2, 2)], nh, ch, 4, lq, dtype)
    plan = launch_plan(value, loc, attn)
    assert (plan.vec, plan.lanes) == (vec, lanes)
    assert 1 << plan.lanes_log2 == plan.lanes and THREADS % plan.lanes == 0
    threads = b * lq * nh * plan.lanes  # one group of lanes per (b, q, head)
    assert plan.blocks == -(-threads // THREADS)
    assert (plan.blocks - 1) * THREADS < threads <= plan.blocks * THREADS


@pytest.mark.parametrize("dtype,adtype", [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)])
def test_every_shape_the_first_kernel_took_still_plans(dtype, adtype):
    """The first K1 took 1..8 levels, any points and channels, any alignment:
    each still validates and gets a plan the C side accepts."""
    for nl in range(1, 9):
        levels = [(3 + i, 2 + i) for i in range(nl)]
        for p in (1, 2, 4, 5):
            for ch in (1, 3, 8, 16, 32, 33, 64, 300):
                value, loc, attn, grad = _tensors(1, levels, 2, ch, p, 3, dtype, adtype)
                msda_cuda._validate(value, levels, loc, attn)
                msda_cuda._validate(value, levels, loc, attn, grad)
                for plan in (launch_plan(value, loc, attn), launch_plan(value, loc, attn, grad)):
                    if plan.variant == MAIN:
                        assert (nl, p, ch) == MAIN_SHAPE
                        assert plan.vec * value.element_size() == 16
                    else:
                        assert plan.variant == GENERIC and plan.vec == 1
                    assert plan.lanes <= 32 and plan.lanes * plan.vec >= min(ch, 32 * plan.vec)


def test_python_constants_match_the_sources():
    text = (CSRC / "msda_common.cuh").read_text()
    variants = re.search(r"kMain = (\d+), kGeneric = (\d+);", text)
    assert tuple(map(int, variants.groups())) == (MAIN, GENERIC)
    shape = re.search(r"kMainLevels = (\d+), kMainPoints = (\d+), kMainChannels = (\d+);", text)
    assert tuple(map(int, shape.groups())) == MAIN_SHAPE
    assert int(re.search(r"kThreads = (\d+);", text).group(1)) == THREADS
    assert int(re.search(r"kMaxLevels = (\d+);", text).group(1)) == msda_cuda._MAX_LEVELS
    for source in ("msda_fwd.cu", "msda_bwd.cu"):
        assert '#include "msda_common.cuh"' in (CSRC / source).read_text()


def test_an_edited_header_rebuilds_the_library(tmp_path, monkeypatch):
    """The kernels include ``msda_common.cuh``: editing it must change the
    library's name, or a stale build would be loaded."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("constexpr int kThreads = 256;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build.library_path("k")
    assert before == cuda_build.library_path("k")
    header.write_text("constexpr int kThreads = 128;\n")
    assert cuda_build.library_path("k") != before
