"""PyTorch port: the plans of K4 (batched Hungarian) and K5 (shared-point
sampler forward), the warp solver's argmin, and the step count that sets K4's
time.

The kernels run only on the card (``chip_smoke.py``,
``tools/torch_bench_k4_k5.py``).  Here the choices around them are held on
the CPU: which K4 instantiation a shape takes and the shared memory it asks
for; a numpy mirror of the warp solver's two-stage ``redux.sync`` argmin on
order-preserving keys, against ``torch.argmin`` (which ``hungarian_plain``
uses, so the kernel's assignment can be its element for element); the
Dijkstra steps ``hungarian_plain`` counts; and K5's grid, which must cover
every (b, row, point) once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvis_tpu_torch.ops import hungarian_cuda, point_sample_cuda
from openvis_tpu_torch.ops.hungarian import hungarian_plain
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

CSRC = Path(hungarian_cuda.__file__).resolve().parent.parent / "csrc"
INF = np.float32(1e15)  # the solver's sentinel for used columns


# --- K4's plan ---------------------------------------------------------------

@pytest.mark.parametrize("b,n,m", [(9, 100, 100), (20, 40, 100)])
def test_k4_plan_at_the_main_path_shapes(b, n, m):
    """Tracking (T-1 frames x 100 x 100) and the matcher (10 layers x 2
    frames x 40 targets x 100 queries): one warp per problem, a block each."""
    plan = hungarian_cuda.launch_plan(n, m)
    assert plan.variant == hungarian_cuda.WARP
    assert plan.threads == 32
    assert plan.smem_bytes == hungarian_cuda.warp_problem_bytes(n, m)
    assert 4 * n * m <= plan.smem_bytes <= 4 * n * m + 4 * 8


@pytest.mark.parametrize("m,variant", [(1, "warp"), (31, "warp"), (126, "warp"), (127, "warp"),
                                       (128, "block"), (200, "block"), (255, "block"),
                                       (400, "block")])
def test_k4_plan_instantiation_follows_the_columns(m, variant):
    """The warp solver holds M + 1 columns (the virtual one included) in 4
    registers a lane; wider problems take the block solver, one thread a
    column up to 256."""
    n = min(m, 5)
    plan = hungarian_cuda.launch_plan(n, m)
    want = {"warp": hungarian_cuda.WARP, "block": hungarian_cuda.BLOCK}[variant]
    assert plan.variant == want
    if variant == "block":
        assert plan.threads == min(256, -(-(m + 1) // 32) * 32)
        assert plan.smem_bytes == hungarian_cuda.block_smem_bytes(n, m)


@pytest.mark.parametrize("n,m", [(1, 1), (1, 100), (100, 100), (127, 127)])
def test_k4_plan_one_warp_a_problem(n, m):
    """A warp-solver block is one warp holding one problem's cost rows,
    16-byte aligned, and no more."""
    plan = hungarian_cuda.launch_plan(n, m)
    assert (plan.variant, plan.threads) == (hungarian_cuda.WARP, 32)
    assert plan.smem_bytes == hungarian_cuda.warp_problem_bytes(n, m)
    assert plan.smem_bytes % 16 == 0
    assert 4 * (n * m + 3) <= plan.smem_bytes <= 4 * (n * m + 6)


def test_k4_plan_widest_warp_problems_fit():
    for n in (1, 64, 127):
        plan = hungarian_cuda.launch_plan(n, 127)
        assert plan.variant == hungarian_cuda.WARP
        assert plan.smem_bytes <= hungarian_cuda.MAX_SMEM


def test_k4_plan_refuses_what_no_solver_takes():
    with pytest.raises(ValueError, match="rows <= cols"):
        hungarian_cuda.launch_plan(6, 5)
    with pytest.raises(ValueError, match="shared memory"):
        hungarian_cuda.launch_plan(240, 240)  # 236 KB of state in one block
    assert hungarian_cuda.launch_plan(200, 240).variant == hungarian_cuda.BLOCK


def test_k4_python_constants_match_the_source():
    text = (CSRC / "hungarian.cu").read_text()
    const = lambda name: eval(re.search(rf"constexpr \w+ {name} = ([\d x*+ -]+);", text).group(1))
    assert const("kWarpCols") == hungarian_cuda.WARP_COLS
    assert const("kBlockMaxThreads") == hungarian_cuda.BLOCK_MAX_THREADS
    assert const("kMaxSmem") == hungarian_cuda.MAX_SMEM
    assert const("kWarpSolver") == hungarian_cuda.WARP
    assert const("kBlockSolver") == hungarian_cuda.BLOCK
    assert "32 * kWarpCols" in re.search(r"kWarpMaxCols = ([^;]+);", text).group(1)


# --- the warp solver's argmin ------------------------------------------------

def order_key(x):
    """hungarian.cu::order_key on f32 values: -0.0 made +0.0, then negatives
    bit-flipped and positives given the sign bit, as uint32."""
    b = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def key_value(k):
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32).view(np.float32)


def redux_argmin(cand):
    """The kernel's argmin over cand (M,) f32: lane l owns the columns
    j = l + 32k and keeps the least key of them, lowest k first (strict <);
    the first redux takes the least key over the lanes, the second the least
    column among the lanes holding it.  -> (column, delta)."""
    m = len(cand)
    keys = order_key(cand)
    best = np.full(32, 0xFFFFFFFF, np.uint64)
    col = np.full(32, 0xFFFFFFFF, np.uint64)
    for lane in range(32):
        for j in range(lane, m, 32):
            if keys[j] < best[lane]:
                best[lane], col[lane] = keys[j], j
    kmin = best.min()
    j1 = np.where(best == kmin, col, 0xFFFFFFFF).min()
    return int(j1), key_value(np.uint32(kmin))


def _torch_argmin(cand):
    t = torch.from_numpy(np.asarray(cand, np.float32))
    j = int(torch.argmin(t))
    return j, t[j].item()


def _cands():
    rng = np.random.RandomState(0)
    out = {
        "ties_to_lowest_column": np.array([3, 1, 2, 1, 1, 5] * 20, np.float32),
        "minus_zero_then_zero": np.array([1.0, -0.0, 0.0, 2.0], np.float32),
        "zero_then_minus_zero": np.array([1.0, 0.0, -0.0, 2.0], np.float32),
        "negatives": np.array([0.5, -3.0, -1e-30, -3.0, 7.0], np.float32),
        "subnormals": np.array([1e-45, -1e-45, 0.0, 1e-40], np.float32),
        "one_free_column_among_used": np.array([INF] * 70 + [4.0] + [INF] * 29, np.float32),
        # a free column still at the sentinel ties with the used ones before
        # it: torch.argmin (and the plain loop) take the first
        "free_at_the_sentinel": np.array([INF, INF, INF], np.float32),
        "random_wide": rng.randn(127).astype(np.float32),
        "random_integer_ties": rng.randint(-2, 3, 100).astype(np.float32),
        "ties_across_lanes_and_registers": np.array([9.0] * 33 + [-1.0] + [9.0] * 40
                                                    + [-1.0] + [9.0] * 20, np.float32),
    }
    for r in range(8):
        x = rng.randint(0, 4, 100).astype(np.float32) - 1.5
        x[rng.rand(100) < 0.3] = INF
        out[f"random_with_used_{r}"] = x
    return out


@pytest.mark.parametrize("name", sorted(_cands()))
def test_redux_argmin_mirror_matches_torch_argmin(name):
    cand = _cands()[name]
    j, delta = redux_argmin(cand)
    tj, tdelta = _torch_argmin(cand)
    assert j == tj
    assert delta == tdelta  # -0.0 comes back as +0.0: equal, and adds alike


def test_order_key_preserves_the_order_of_floats():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(500), rng.randn(200) * 1e-40, rng.randn(200) * 1e30,
                        [0.0, -0.0, np.inf, -np.inf, 1e15, -1e15]]).astype(np.float32)
    a, b = np.meshgrid(x, x)
    assert ((order_key(a) < order_key(b)) == (a < b)).all()
    assert ((order_key(a) == order_key(b)) == (a == b)).all()
    back = key_value(order_key(x))
    assert (back.view(np.uint32) == (x + np.float32(0.0)).view(np.uint32)).all()


# --- the Dijkstra steps ------------------------------------------------------

def _emaxx_steps(cost):
    """An independent e-maxx loop, one column at a time in f32 numpy: the
    number of Dijkstra steps and the column of each row."""
    c = np.asarray(cost, np.float32)
    n, m = c.shape
    u = np.zeros(n, np.float32)
    v = np.zeros(m + 1, np.float32)
    p = np.full(m + 1, -1)
    steps = 0
    for i in range(n):
        p[m] = i
        minv = np.full(m, INF, np.float32)
        way = np.zeros(m, int)
        used = np.zeros(m + 1, bool)
        j0 = m
        while p[j0] >= 0:
            steps += 1
            used[j0] = True
            i0 = p[j0]
            j1, delta = -1, INF
            for j in range(m):
                if not used[j]:
                    cur = np.float32(np.float32(c[i0, j] - u[i0]) - v[j])
                    if cur < minv[j]:
                        minv[j], way[j] = cur, j0
                cand = INF if used[j] else minv[j]
                if j1 < 0 or cand < delta:
                    j1, delta = j, cand
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] = np.float32(u[p[j]] + delta)
                    v[j] = np.float32(v[j] - delta)
                elif j < m:
                    minv[j] = np.float32(minv[j] - delta)
            j0 = j1
        while j0 != m:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    cols = np.zeros(n, int)
    for j in range(m):
        if p[j] >= 0:
            cols[p[j]] = j
    return steps, cols


def test_plain_steps_one_by_one():
    cols, steps = hungarian_plain(torch.tensor([[2.5]]), return_steps=True)
    assert cols.tolist() == [0] and steps == 1


@pytest.mark.parametrize("n,m", [(1, 3), (7, 7), (12, 30)])
def test_plain_steps_zero_diagonal(n, m):
    """Each row's own column is its only zero: one step a row."""
    cost = np.ones((n, m), np.float32) * 3
    cost[np.arange(n), np.arange(n)] = 0
    cols, steps = hungarian_plain(torch.from_numpy(cost), return_steps=True)
    assert steps == n
    assert cols.tolist() == list(range(n))


@pytest.mark.parametrize("seed,n,m,ties", [(0, 6, 9, False), (1, 12, 12, False),
                                           (2, 10, 16, True), (3, 15, 20, True)])
def test_plain_steps_match_an_independent_count(seed, n, m, ties):
    rng = np.random.RandomState(seed)
    cost = (rng.randint(1, 4, (n, m)) if ties else rng.rand(n, m) * 5).astype(np.float32)
    cols, steps = hungarian_plain(torch.from_numpy(cost), return_steps=True)
    ref_steps, ref_cols = _emaxx_steps(cost)
    assert steps == ref_steps >= n
    assert cols.tolist() == ref_cols.tolist()
    assert hungarian_plain(torch.from_numpy(cost)).tolist() == cols.tolist()


# --- K5's plan ---------------------------------------------------------------

def _coverage(map_shape, n_points, plan):
    """How often the kernel's grid writes each (b, row, point): the grid is
    (point tiles, row chunks, b); thread t of tile x takes the points
    (x * FWD_THREADS + t) * vec .. + vec - 1 below P, chunk y the rows
    y * row_chunk .. + row_chunk - 1 below R."""
    b, r, _, _ = map_shape
    gx, gy, gz = plan.grid(b, r, n_points)
    assert gz == b
    pts = np.zeros(n_points, int)
    for x in range(gx):
        for t in range(point_sample_cuda.FWD_THREADS):
            p0 = (x * point_sample_cuda.FWD_THREADS + t) * plan.vec
            if p0 < n_points:
                pts[p0:p0 + plan.vec] += 1
    rows = np.zeros(r, int)
    for y in range(gy):
        r0 = y * plan.row_chunk
        rows[r0:r0 + min(plan.row_chunk, r - r0)] += 1
    return gx, gy, gz, pts, rows


@pytest.mark.parametrize("case,vec,chunk", [("matcher", 2, 8), ("loss_candidates", 2, 8),
                                            ("loss_random", 2, 2)])
def test_k5_plan_at_the_train_shapes(case, vec, chunk):
    b, r, h, w, p = {"matcher": (2, 100, 120, 216, 12544),
                     "loss_candidates": (2, 40, 120, 216, 37632),
                     "loss_random": (2, 40, 120, 216, 3136)}[case]
    plan = point_sample_cuda.fwd_plan((b, r, h, w), p)
    assert (plan.vec, plan.row_chunk) == (vec, chunk)
    gx, gy, gz, pts, rows = _coverage((b, r, h, w), p, plan)
    assert (pts == 1).all() and (rows == 1).all()
    assert gx * gy * gz >= point_sample_cuda.FWD_MIN_BLOCKS


@pytest.mark.parametrize("b,r,p,aligned", [(1, 13, 13, True), (3, 13, 258, True),
                                           (2, 21, 1000, False), (1, 1, 1, True),
                                           (4, 9, 255, True), (2, 100, 12546, True)])
def test_k5_grid_covers_ragged_rows_and_points_once(b, r, p, aligned):
    plan = point_sample_cuda.fwd_plan((b, r, 8, 8), p, aligned=aligned)
    assert plan.vec == (2 if p % 2 == 0 and aligned else 1)
    _, gy, gz, pts, rows = _coverage((b, r, 8, 8), p, plan)
    assert (pts == 1).all() and (rows == 1).all()
    assert gy <= point_sample_cuda.MAX_GRID_YZ and gz <= point_sample_cuda.MAX_GRID_YZ


def test_k5_plan_keeps_the_grid_within_its_limits():
    rows = 1_000_000  # more chunks of FWD_ROW_CHUNK rows than the grid's y holds
    assert -(-rows // point_sample_cuda.FWD_ROW_CHUNK) > point_sample_cuda.MAX_GRID_YZ
    plan = point_sample_cuda.fwd_plan((1, rows, 4, 4), 2)
    gx, gy, gz = plan.grid(1, rows, 2)
    assert gy <= point_sample_cuda.MAX_GRID_YZ
    assert gy * plan.row_chunk >= rows > (gy - 1) * plan.row_chunk
    with pytest.raises(ValueError, match="batch items"):
        point_sample_cuda.fwd_plan((70_000, 1, 4, 4), 2)


def test_k5_python_constants_match_the_source():
    text = (CSRC / "point_sample.cu").read_text()
    assert int(re.search(r"kFwdThreads = (\d+);", text).group(1)) == point_sample_cuda.FWD_THREADS
    assert int(re.search(r"kMaxGridYZ = (\d+);", text).group(1)) == point_sample_cuda.MAX_GRID_YZ
    # the wrapper passes vec 1 or 2, and the C side takes those two
    assert "(vec != 1 && vec != 2)" in text
