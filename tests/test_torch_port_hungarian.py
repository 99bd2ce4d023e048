"""PyTorch port: Hungarian plain version against scipy and the JAX package,
and the CUDA wrapper's CPU behaviour.  Assignments are compared by total cost:
ties may resolve differently."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from openvis_tpu.ops.hungarian import batched_hungarian as jax_batched_hungarian
from openvis_tpu.ops.hungarian_pallas import batched_hungarian_pallas
from openvis_tpu_torch.ops import hungarian_cuda
from openvis_tpu_torch.ops.hungarian import batched_hungarian, hungarian_plain
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def _total(cost, cols):
    n = cost.shape[0]
    return cost.astype(np.float64)[np.arange(n), cols].sum()


def _optimum(cost):
    r, c = linear_sum_assignment(cost.astype(np.float64))
    return cost.astype(np.float64)[r, c].sum()


def _check(cost, cols):
    n = cost.shape[0]
    assert cols.shape == (n,)
    assert len(set(cols.tolist())) == n, "not an injective column map"
    np.testing.assert_allclose(_total(cost, cols), _optimum(cost), rtol=1e-6)


@pytest.mark.parametrize("b,n,m", [(3, 5, 10), (2, 40, 100), (2, 100, 100)])
def test_plain_matches_scipy(b, n, m):
    rng = np.random.RandomState(n + m)
    cost = (rng.rand(b, n, m) * 5).astype(np.float32)
    cols = batched_hungarian(torch.from_numpy(cost))
    assert cols.dtype == torch.int64
    for bi in range(b):
        _check(cost[bi], cols[bi].numpy())


def test_plain_with_ties_and_constant_rows():
    rng = np.random.RandomState(7)
    ties = rng.randint(0, 3, size=(12, 16)).astype(np.float32)
    _check(ties, hungarian_plain(torch.from_numpy(ties)).numpy())
    valid = rng.rand(6, 12).astype(np.float32)
    padded = np.concatenate([valid, np.zeros((3, 12), np.float32)])
    cols = hungarian_plain(torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(_total(valid, cols[:6]), _optimum(valid), rtol=1e-6)


def test_plain_matches_jax_batched_hungarian():
    """1 - cosine costs as in tracking, against the JAX XLA solver."""
    rng = np.random.RandomState(11)
    e = rng.randn(4, 2, 30, 16).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    cost = (1.0 - np.einsum("bqc,bkc->bqk", e[:, 0], e[:, 1])).astype(np.float32)
    ref = np.asarray(jax.jit(jax_batched_hungarian)(jnp.asarray(cost)))
    got = batched_hungarian(torch.from_numpy(cost)).numpy()
    for bi in range(cost.shape[0]):
        np.testing.assert_allclose(_total(cost[bi], got[bi]), _total(cost[bi], ref[bi]), rtol=1e-6)


def test_plain_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    cost = (rng.randn(2, 12, 20) * 5).astype(np.float32)
    ref = np.asarray(batched_hungarian_pallas(jnp.asarray(cost), interpret=True))
    got = batched_hungarian(torch.from_numpy(cost)).numpy()
    for bi in range(2):
        np.testing.assert_allclose(_total(cost[bi], got[bi]), _total(cost[bi], ref[bi]),
                                   rtol=1e-6, atol=1e-5)


def test_rejects_more_rows_than_columns():
    with pytest.raises(ValueError, match="rows <= cols"):
        hungarian_plain(torch.zeros(5, 4))


def test_cuda_wrapper_rejects_cpu_tensors_and_cpu_leaves_counter():
    cost = torch.rand(2, 6, 8)
    batched_hungarian(cost)
    with pytest.raises(ValueError, match="CUDA"):
        hungarian_cuda.batched_hungarian_cuda(cost)
    assert hungarian_cuda.launches == 0
