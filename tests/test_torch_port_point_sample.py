"""PyTorch port: the criterion's point sampler and its selection helper.

The plain sampler (the version K5/K6 are held to on the card) and its
gradient against the JAX package's gather composition and against the Pallas
sampler in interpret mode; ``kth_largest`` and ``sorted_uniform_points``; and
the wiring of ``SharedPointSample``, the route a CUDA tensor takes, with its
``*_cuda`` entry points stood in by the plain versions.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.ops.point_sample as jps
import openvis_tpu.ops.point_sample_pallas as PSP
from openvis_tpu.ops.select import kth_largest as jax_kth_largest
from openvis_tpu_torch.ops import point_sample as ps
from openvis_tpu_torch.ops import point_sample_cuda
from openvis_tpu_torch.ops.select import kth_largest
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def _sorted_points(rng, b, p):
    e = rng.exponential(size=(b, p + 1))
    s = np.cumsum(e, -1)
    return np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]], -1).astype(np.float32)


def _case(seed, b=2, r=5, h=12, w=20, p=300):
    rng = np.random.RandomState(seed)
    maps = (rng.randn(b, r, h, w) * 3).astype(np.float32)
    coords = _sorted_points(rng, b, p)
    coords[:, :7] = rng.uniform(-0.05, 1.05, size=(b, 7, 2))  # a few near the edges
    g = rng.randn(b, r, p).astype(np.float32)
    return maps, coords, g


def _jax_ref(maps, coords, g, f32_policy=False):
    fn = lambda m: jps.sample_maps_shared(m, jnp.asarray(coords), f32_policy=f32_policy)
    out, vjp = jax.vjp(fn, jnp.asarray(maps))
    return np.asarray(out, np.float32), np.asarray(vjp(jnp.asarray(g).astype(out.dtype))[0],
                                                    np.float32)


def _port(maps_t, coords, g, f32_policy=False):
    m = maps_t.clone().requires_grad_()
    out = ps.sample_maps_shared(m, torch.from_numpy(coords), f32_policy=f32_policy)
    out.backward(torch.from_numpy(g).to(out.dtype))
    return out.detach().float().numpy(), m.grad.float().numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sampler_and_grad_match_jax_f32(seed):
    maps, coords, g = _case(seed)
    ref, dref = _jax_ref(maps, coords, g)
    got, dgot = _port(torch.from_numpy(maps), coords, g)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dgot, dref, rtol=1e-5, atol=1e-6)


def test_bf16_maps_under_the_f32_policy_match_jax():
    """bf16 maps sampled in f32 after an exact widening, on both sides; the
    gradient comes back in bf16 (one rounding each side)."""
    maps, coords, g = _case(2)
    mb = jnp.asarray(maps).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda m: jps.sample_maps_shared(m, jnp.asarray(coords), True), mb)
    ref = np.asarray(out, np.float32)
    dref = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    mt = torch.from_numpy(maps).bfloat16()
    got, dgot = _port(mt, coords, g, f32_policy=True)
    assert ps.sample_maps_shared(mt, torch.from_numpy(coords), True).dtype == torch.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dgot, dref, rtol=2 ** -7, atol=1e-6)


def test_plain_sampler_matches_pallas_interpret():
    """Against the TPU kernel's own semantics, forward and dValue; the
    Pallas dot is a 3-pass bf16 split of f32 (~1e-5 relative)."""
    maps, coords, g = _case(3, p=256)
    value = jnp.asarray(maps.transpose(0, 2, 3, 1))           # (B, H, W, R)

    @jax.jit
    def ref(v, c, gr):
        out, vjp = jax.vjp(lambda v: PSP.point_sample_nhwc_pallas(v, c, interpret=True), v)
        return out, vjp(gr)[0]

    out, dv = ref(value, jnp.asarray(coords), jnp.asarray(g))
    dref = np.asarray(dv).transpose(0, 3, 1, 2)
    got, dgot = _port(torch.from_numpy(maps), coords, g)
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dgot, dref, rtol=1e-4, atol=1e-4)


def test_pre_transposed_rows_and_per_row_sampler_match_jax():
    maps, coords, _ = _case(4)
    b, r, h, w = maps.shape
    flat_t = maps.reshape(b, r, h * w).transpose(0, 2, 1).copy()
    ref = np.asarray(jps.sample_maps_shared_t(jnp.asarray(flat_t).astype(jnp.bfloat16), h, w,
                                              jnp.asarray(coords), f32_policy=True))
    got = ps.sample_maps_shared_t(torch.from_numpy(flat_t).bfloat16(), h, w,
                                  torch.from_numpy(coords), f32_policy=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    per_row = np.broadcast_to(coords[:, None], (b, r) + coords.shape[1:]).copy()
    ref = np.asarray(jps.point_sample(jnp.asarray(maps), jnp.asarray(per_row)))
    got = ps.point_sample(torch.from_numpy(maps), torch.from_numpy(per_row))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_kth_largest_matches_jax_with_ties(k):
    rng = np.random.RandomState(k)
    x = rng.randn(3, 4, 40).astype(np.float32)
    x[0] = np.round(x[0])                                     # many ties
    x[1, :, ::2] = -np.abs(x[1, :, ::2])
    ref = np.asarray(jax_kth_largest(jnp.asarray(x), k))
    got = kth_largest(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(torch.from_numpy(x) >= torch.from_numpy(got)[..., None],
                                  x >= ref[..., None])


def test_sorted_uniform_points():
    g = torch.Generator().manual_seed(0)
    pts = ps.sorted_uniform_points(g, (3,), 1000)
    assert pts.shape == (3, 1000, 2) and pts.dtype == torch.float32
    assert bool((pts >= 0).all()) and bool((pts < 1).all())
    assert bool((pts[..., 1].diff(dim=-1) >= 0).all())
    again = ps.sorted_uniform_points(torch.Generator().manual_seed(0), (3,), 1000)
    assert torch.equal(pts, again)
    # x is not sorted, and both coordinates spread over [0, 1)
    assert float(pts[..., 0].diff(dim=-1).lt(0).float().mean()) > 0.3
    assert abs(float(pts.mean()) - 0.5) < 0.05


@pytest.fixture
def plain_kernels(monkeypatch):
    def fwd(maps, coords):
        return ps.sample_maps_shared_plain(maps, coords, f32_policy=True)

    def dvalue(coords, grad, shape, dtype):
        return ps.sample_maps_dvalue_plain(torch.zeros(shape, dtype=dtype), coords, grad)

    monkeypatch.setattr(point_sample_cuda, "point_sample_fwd_cuda", fwd)
    monkeypatch.setattr(point_sample_cuda, "point_sample_dvalue_cuda", dvalue)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_gives_the_maps_a_gradient(plain_kernels, dtype):
    maps, coords, g = _case(5)
    m = torch.from_numpy(maps).to(dtype).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    out = point_sample_cuda.SharedPointSample.apply(m, c)
    assert out.grad_fn is not None and out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    assert m.grad.dtype == dtype and c.grad is None
    want = ps.sample_maps_dvalue_plain(m.detach(), torch.from_numpy(coords), torch.from_numpy(g))
    torch.testing.assert_close(m.grad, want, rtol=0, atol=0)


def test_cpu_routing_and_wrappers():
    maps, coords, g = (torch.from_numpy(a) for a in _case(6))
    ps.sample_maps_shared(maps, coords)
    assert (point_sample_cuda.fwd_launches, point_sample_cuda.dvalue_launches) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_fwd_cuda(maps, coords)
    with pytest.raises(ValueError, match="CUDA"):
        point_sample_cuda.point_sample_dvalue_cuda(coords, g, maps.shape, maps.dtype)
    assert (point_sample_cuda.fwd_launches, point_sample_cuda.dvalue_launches) == (0, 0)
