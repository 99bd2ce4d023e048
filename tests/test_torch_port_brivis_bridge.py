"""PyTorch port, BriVIS's Brownian-bridge loss against the JAX package on the
CPU (the negative log and the ratio forms) and the bf16 AMP loss within the
bf16 bound of JAX's.  Shapes, helpers and the model fixture:
``tests/test_torch_port_brivis.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvis_tpu.losses.brownian import brownian_bridge_loss as jax_brownian
from openvis_tpu_torch.losses.brownian import brownian_bridge_loss

from test_torch_port_san import AMP_LOSS_RTOL, _rel  # noqa: F401  (fixtures and helpers)
from test_torch_port_brivis import (  # noqa: F401  (fixtures and helpers)
    BROWNIAN_RTOL,
    _losses,
    brivis,
    tiny_clip,
)


@pytest.mark.parametrize("neg_log", [True, False], ids=["neg_log", "ratio"])
def test_brownian_bridge_loss_matches_jax(neg_log):
    rng = np.random.RandomState(6)
    b, t, q, c = 2, 6, 5, 16
    e = rng.randn(b, t, q, c).astype(np.float32)
    key = jax.random.PRNGKey(6)
    mid = np.asarray(jax.random.randint(key, (b * q,), 1, t - 1))
    assert len(set(mid.tolist())) > 1

    def jfn(x):
        bc, htm = jax_brownian(key, x, neg_log=neg_log)
        return bc + 2.0 * htm, (bc, htm)

    (_, (jbc, jhtm)), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    bc, htm = brownian_bridge_loss(torch.Generator(), x, neg_log=neg_log,
                                   draw_mid=lambda g, n, tt: torch.from_numpy(mid).long())
    grad, = torch.autograd.grad(bc + 2.0 * htm, x)
    np.testing.assert_allclose(bc.item(), float(jbc), rtol=BROWNIAN_RTOL)
    np.testing.assert_allclose(htm.item(), float(jhtm), rtol=BROWNIAN_RTOL)
    assert _rel(grad, jgrad) <= 1e-5


def test_brivis_amp_loss_within_bf16_bound_of_jax(brivis):
    (loss, metrics, grads), (jloss, jmetrics, _) = _losses(brivis, True, True)
    assert all(v.dtype == np.float32 for v in grads.values())  # f32 masters
    assert np.isfinite(loss) and abs(loss - jloss) <= AMP_LOSS_RTOL * abs(jloss)
    for k in jmetrics:
        assert abs(metrics[k] - jmetrics[k]) <= AMP_LOSS_RTOL * abs(jmetrics[k]), k
