"""PyTorch port: MSDA plain version against the JAX package, and the CUDA
wrapper's CPU behaviour.

``ms_deform_attn_plain`` defines the semantics the CUDA kernel is held to on
the card; here it is held to ``ms_deform_attn_xla`` and to the fused Pallas
kernel run in interpret mode.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.ops.msda_pallas as MP
from openvis_tpu.ops.msda import ms_deform_attn_xla
from openvis_tpu_torch.ops import msda_cuda
from openvis_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def _inputs(seed, shapes, b=2, nh=4, ch=32, p=4, lq=17):
    rng = np.random.RandomState(seed)
    nl = len(shapes)
    length = sum(h * w for h, w in shapes)
    value = rng.randn(b, length, nh, ch).astype(np.float32)
    # locations spill outside [0, 1] to exercise the zero padding
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, nh, nl, p, 2)).astype(np.float32)
    logits = rng.randn(b, lq, nh, nl * p)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.reshape(b, lq, nh, nl, p).astype(np.float32)


def _plain(value, shapes, loc, attn):
    return ms_deform_attn_plain(
        torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn)
    ).numpy()


@pytest.mark.parametrize("seed,shapes", [
    (0, [(6, 9), (3, 5)]),
    (1, [(8, 12), (4, 6), (2, 3)]),
    (2, [(12, 20), (6, 10), (3, 5)]),
])
def test_plain_matches_xla_f32(seed, shapes):
    value, loc, attn = _inputs(seed, shapes)
    ref = np.asarray(jax.jit(ms_deform_attn_xla, static_argnums=1)(
        jnp.asarray(value), tuple(shapes), jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_plain(value, shapes, loc, attn), ref, rtol=1e-5, atol=1e-5)


def test_plain_matches_fused_pallas_interpret():
    shapes = [(6, 9), (3, 5)]
    value, loc, attn = _inputs(3, shapes)
    ref = np.asarray(MP._msda_fused(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), tuple(shapes),
        interpret=True, rr_lanes=True,
    ))
    np.testing.assert_allclose(_plain(value, shapes, loc, attn), ref, rtol=1e-4, atol=1e-5)


def test_plain_bf16_value_computes_f32():
    """bf16 value and attention: f32 arithmetic, bf16 result -- within one
    bf16 rounding (relative 2^-8) of the f32 result on the same inputs."""
    shapes = [(8, 12), (4, 6), (2, 3)]
    value, loc, attn = _inputs(4, shapes)
    vb = torch.from_numpy(value).bfloat16()
    ab = torch.from_numpy(attn).bfloat16()
    out = ms_deform_attn_plain(vb, shapes, torch.from_numpy(loc), ab)
    assert out.dtype == torch.bfloat16
    ref = ms_deform_attn_plain(vb.float(), shapes, torch.from_numpy(loc), ab.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2 ** -8, atol=1e-6)


def test_dispatch_uses_plain_on_cpu_and_leaves_counter():
    shapes = [(6, 9), (3, 5)]
    value, loc, attn = _inputs(5, shapes)
    before = msda_cuda.launches
    out = ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                         torch.from_numpy(attn))
    np.testing.assert_array_equal(out.numpy(), _plain(value, shapes, loc, attn))
    assert msda_cuda.launches == before == 0


def test_cuda_wrapper_rejects_cpu_tensors():
    shapes = [(6, 9), (3, 5)]
    value, loc, attn = (torch.from_numpy(a) for a in _inputs(6, shapes))
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn)
    assert msda_cuda.launches == 0
