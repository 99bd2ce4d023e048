"""PyTorch port: the MSDA backward.

Autograd through ``ms_deform_attn_plain`` (the plain version K2/K3 are held to
on the card) against ``jax.vjp`` of ``ms_deform_attn_xla`` and against the
fused Pallas backward in interpret mode; and the wiring of
``MSDeformAttnFunction``, the route a CUDA tensor takes, with its ``*_cuda``
entry points stood in by the plain versions.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.ops.msda_pallas as MP
from openvis_tpu.ops.msda import ms_deform_attn_xla
from openvis_tpu_torch.models import pixel_decoder
from openvis_tpu_torch.ops import msda, msda_cuda
from openvis_tpu_torch.ops.msda import (
    MSDeformAttnFunction,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_plain,
)


def _inputs(seed, shapes, b=2, nh=2, ch=32, p=4, lq=13):
    rng = np.random.RandomState(seed)
    nl = len(shapes)
    length = sum(h * w for h, w in shapes)
    value = rng.randn(b, length, nh, ch).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, nh, nl, p, 2)).astype(np.float32)
    attn = rng.rand(b, lq, nh, nl, p).astype(np.float32)
    g = rng.randn(b, lq, nh * ch).astype(np.float32)
    return value, loc, attn, g


def _plain_grads(value, shapes, loc, attn, g):
    dv, dl, da = ms_deform_attn_bwd_plain(torch.from_numpy(value), shapes,
                                          torch.from_numpy(loc), torch.from_numpy(attn),
                                          torch.from_numpy(g))
    return dv.numpy(), dl.numpy(), da.numpy()


# f32 on both sides; the sums run in other orders and the slopes are
# differences of corners, so dloc gets the looser absolute bound
TOL = {"dvalue": (1e-4, 1e-5), "dloc": (1e-4, 2e-5), "dattn": (1e-4, 1e-5)}


@pytest.mark.parametrize("seed,shapes", [
    (0, [(6, 9), (3, 5)]),
    (1, [(8, 9), (4, 5), (2, 3)]),
])
def test_plain_grads_match_jax_vjp(seed, shapes):
    value, loc, attn, g = _inputs(seed, shapes)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    for name, got, ref in zip(TOL, _plain_grads(value, shapes, loc, attn, g), refs):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def test_plain_grads_match_fused_pallas_backward_interpret():
    shapes = [(8, 9), (4, 5), (2, 3)]
    value, loc, attn, g = _inputs(2, shapes)
    refs = MP._msda_bwd_fused.__wrapped__(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), jnp.asarray(g),
        tuple(shapes), interpret=True)
    for name, got, ref in zip(TOL, _plain_grads(value, shapes, loc, attn, g), refs):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Stand the CUDA entry points in with the plain versions, so the
    autograd Function runs on the CPU."""
    monkeypatch.setattr(msda_cuda, "ms_deform_attn_cuda", ms_deform_attn_plain)
    monkeypatch.setattr(msda_cuda, "ms_deform_attn_bwd_cuda", ms_deform_attn_bwd_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_gives_every_input_its_gradient(plain_kernels, dtype):
    shapes = [(6, 9), (3, 5)]
    value, loc, attn, g = (torch.from_numpy(a) for a in _inputs(3, shapes))
    v = value.to(dtype).requires_grad_()
    lc = loc.clone().requires_grad_()
    a = attn.to(dtype).requires_grad_()
    out = MSDeformAttnFunction.apply(v, lc, a, tuple(shapes))
    assert out.grad_fn is not None and out.dtype == dtype
    out.backward(g.to(dtype))
    assert (v.grad.dtype, lc.grad.dtype, a.grad.dtype) == (dtype, torch.float32, dtype)
    ref = ms_deform_attn_bwd_plain(v.detach(), shapes, loc, a.detach(), g.to(dtype))
    for got, want in zip((v.grad, lc.grad, a.grad), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(float(t.grad.abs().sum()) > 0 for t in (v, lc, a))


def test_cuda_route_trains_the_sampling_offsets(plain_kernels, monkeypatch):
    """The route a CUDA tensor takes keeps the encoder's gradient: the
    sampling-offset and attention-weight heads of MSDeformAttn get one."""
    monkeypatch.setattr(pixel_decoder, "ms_deform_attn", lambda v, s, l, a: (
        MSDeformAttnFunction.apply(v, l, a, tuple(s))))
    torch.manual_seed(0)
    mod = pixel_decoder.MSDeformAttnModule(d_model=32, n_levels=2, n_heads=2, n_points=2)
    shapes = [(4, 6), (2, 3)]
    length = sum(h * w for h, w in shapes)
    src = torch.randn(1, length, 32)
    ref = pixel_decoder.encoder_reference_points(shapes)[None]
    out = mod(src, ref, src, shapes, pixel_decoder.level_normalizer(shapes))
    assert out.grad_fn is not None
    out.square().sum().backward()
    for head in (mod.sampling_offsets, mod.attention_weights, mod.value_proj):
        assert head.weight.grad is not None and float(head.weight.grad.abs().sum()) > 0


def test_cpu_dispatch_launches_no_kernel():
    shapes = [(6, 9), (3, 5)]
    value, loc, attn, g = (torch.from_numpy(x) for x in _inputs(4, shapes))
    value.requires_grad_()
    msda.ms_deform_attn(value, shapes, loc, attn).backward(g)
    assert value.grad is not None
    assert (msda_cuda.launches, msda_cuda.dcoord_launches, msda_cuda.dvalue_launches) == (0, 0, 0)


def test_backward_wrappers_reject_cpu_tensors():
    shapes = [(6, 9), (3, 5)]
    value, loc, attn, g = (torch.from_numpy(x) for x in _inputs(5, shapes))
    for fn in (msda_cuda.msda_dcoord_cuda, msda_cuda.msda_dvalue_cuda,
               msda_cuda.ms_deform_attn_bwd_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(value, shapes, loc, attn, g)
    assert (msda_cuda.dcoord_launches, msda_cuda.dvalue_launches) == (0, 0)
