"""PyTorch port, the ResNet-50 trunk against the JAX package on the CPU in f32
(both stride placements), the AMP norm and softmax dtype policy, and a
single frame's tracking.  Shapes and helpers: ``tests/test_torch_port_modules.py``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from openvis_tpu.models.amp import amp_norm as jax_amp_norm
from openvis_tpu.models.backbone.resnet import ResNet as JaxResNet
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, load_flax_params
from openvis_tpu_torch.models import tracking
from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.backbone.resnet import ResNet

from test_torch_port_modules import (  # noqa: F401  (fixtures and helpers)
    H,
    W,
    _np_tree,
    _randomize,
    _t,
)
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def test_amp_norm_and_softmax_keep_dtype_and_compute_f32():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32)
    scale = rng.randn(64).astype(np.float32) * 0.1 + 1.0
    bias = rng.randn(64).astype(np.float32) * 0.1
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref = jax_amp_norm(lambda v: fnn.LayerNorm().apply(params, v), xb)
    ln = torch.nn.LayerNorm(64, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
        out = amp_norm(ln, _t(x).bfloat16())
    assert out.dtype == torch.bfloat16
    # same f32 arithmetic, one bf16 rounding of the result
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)
    s = softmax_f32(_t(x).bfloat16(), dim=-1)
    assert s.dtype == torch.bfloat16
    np.testing.assert_allclose(s.float().numpy(),
                               torch.softmax(_t(x).bfloat16().float(), -1).numpy(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("stride_in_1x1,h,w", [(False, H, W), (True, 32, 64)])
def test_resnet50_matches_jax(stride_in_1x1, h, w):
    rng = np.random.RandomState(2)
    x = rng.randn(1, h, w, 3).astype(np.float32)
    jm = JaxResNet(depth=50, stride_in_1x1=stride_in_1x1)
    # the port's seeded init (flax's initializers) as the weights: JAX's init
    # would compile the trunk once more
    tm = init_params(ResNet(depth=50, stride_in_1x1=stride_in_1x1), seed=0)
    params = _randomize(jax.tree.map(jnp.asarray, flax_from_state_dict(tm.state_dict())), rng,
                        keys=("norm",))
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    tm = load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        out = tm(_t(x).permute(0, 3, 1, 2))
    assert sorted(out) == ["res2", "res3", "res4", "res5"]
    for k in out:
        got = out[k].permute(0, 2, 3, 1).numpy()
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_single_frame_tracking_is_identity():
    idx = tracking.track_by_embeds(torch.randn(2, 1, 5, 4))
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(5), (2, 1, 5)))
