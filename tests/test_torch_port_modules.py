"""PyTorch port, module by module, against the JAX package at a tiny size.

Parameters come from the flax modules' own init and are carried across by
``openvis_tpu_torch.convert.params_from_flax``.  Norm affines and the MSDA
offset/attention-weight kernels are randomized, so that a wrong order, a
swapped axis or a sampling point that never leaves its init ring shows.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from openvis_tpu.models import tracking as jax_tracking
from openvis_tpu.models.amp import amp_norm as jax_amp_norm
from openvis_tpu.models.backbone.resnet import ResNet as JaxResNet
from openvis_tpu.models.meta.simple_baseline import eval_scores as jax_eval_scores
from openvis_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from openvis_tpu.models.position_encoding import position_encoding_2d as jax_pe2d
from openvis_tpu.models.postprocess import inference_video_topk as jax_topk
from openvis_tpu.models.transformer_decoder import MaskedTransformerDecoder as JaxDecoder
from openvis_tpu.utils.image import resize_bilinear_torch_hw as jax_resize_hw
from openvis_tpu_torch.convert import load_flax_params
from openvis_tpu_torch.models import tracking
from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.backbone.resnet import ResNet, feature_channels
from openvis_tpu_torch.models.meta.simple_baseline import eval_scores
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openvis_tpu_torch.models.position_encoding import position_encoding_2d
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.transformer_decoder import MaskedTransformerDecoder
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw

HID, NHEADS, Q, D = 64, 4, 8, 32
H, W = 64, 96  # input frame size; features at strides 4..32


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(params, rng, keys=("norm",), scale=0.1):
    """Replace every leaf whose path contains one of ``keys`` by 1 + noise
    (norm affines) or noise (kernels)."""
    def f(path, v):
        name = "/".join(str(getattr(k, "key", k)) for k in path).lower()
        if any(k in name for k in keys):
            noise = rng.randn(*v.shape).astype(np.float32) * scale
            return jnp.asarray(noise + (1.0 if "norm" in name else 0.0))
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("src,dst", [((16, 24), (4, 6)), ((4, 6), (16, 24)), ((12, 20), (7, 9))])
def test_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    ref = np.asarray(jax_resize_hw(jnp.asarray(x), dst))
    np.testing.assert_allclose(resize_bilinear_torch_hw(_t(x), dst).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_position_encoding_matches_jax():
    ref = np.asarray(jax_pe2d(6, 10, 32))
    np.testing.assert_allclose(position_encoding_2d(6, 10, 32).numpy(), ref, rtol=1e-5, atol=1e-5)


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
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomize(params, rng, keys=("norm",))
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    tm = load_flax_params(ResNet(depth=50, stride_in_1x1=stride_in_1x1), _np_tree(params))
    with torch.no_grad():
        out = tm(_t(x).permute(0, 3, 1, 2))
    assert sorted(out) == ["res2", "res3", "res4", "res5"]
    for k in out:
        got = out[k].permute(0, 2, 3, 1).numpy()
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=k)


def _features(rng, b=2):
    chans = feature_channels(50)
    return {
        f"res{i + 2}": rng.randn(b, H // s, W // s, chans[f"res{i + 2}"]).astype(np.float32)
        for i, s in enumerate((4, 8, 16, 32))
    }


def test_pixel_decoder_matches_jax():
    rng = np.random.RandomState(3)
    feats = _features(rng)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jm = JaxPixelDecoder(conv_dim=HID, mask_dim=HID, enc_layers=2, n_heads=NHEADS,
                         n_points=4, d_ffn=128)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jfeats)["params"]
    params = _randomize(params, rng, keys=("norm",))
    # sampling leaves the init ring: random offset / attention-weight kernels
    params = _randomize(params, rng, keys=("sampling_offsets/kernel",
                                           "attention_weights/kernel"), scale=0.05)
    mf, _, ms = jax.jit(jm.apply)({"params": params}, jfeats)
    tm = load_flax_params(
        MSDeformAttnPixelDecoder(feature_channels(50), conv_dim=HID, mask_dim=HID,
                                 enc_layers=2, n_heads=NHEADS, n_points=4, d_ffn=128),
        _np_tree(params),
    )
    with torch.no_grad():
        tmf, _, tms = tm({k: _t(v).permute(0, 3, 1, 2) for k, v in feats.items()})
    np.testing.assert_allclose(tmf.permute(0, 2, 3, 1).numpy(), np.asarray(mf),
                               rtol=1e-4, atol=1e-4, err_msg="mask_features")
    for i in range(3):
        np.testing.assert_allclose(tms[i].permute(0, 2, 3, 1).numpy(), np.asarray(ms[i]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"level {i}")


@pytest.mark.parametrize("in_channels,pre_norm", [(HID, False), (48, True)])
def test_frame_decoder_matches_jax(in_channels, pre_norm):
    """3 decoder layers: every level once, through the masked attention;
    the second case adds the input projections and pre-norm layers."""
    rng = np.random.RandomState(4)
    t = 2
    ms = [rng.randn(t, h, w, in_channels).astype(np.float32)
          for h, w in ((2, 3), (4, 6), (8, 12))]
    mf = rng.randn(t, 16, 24, HID).astype(np.float32)
    kw = dict(hidden_dim=HID, num_queries=Q, nheads=NHEADS, dim_feedforward=128,
              dec_layers=3, mask_dim=HID, clip_dim=D, in_channels=in_channels,
              pre_norm=pre_norm)
    jm = JaxDecoder(mode="frame", head="embedding", **kw)
    jargs = ([jnp.asarray(m) for m in ms], jnp.asarray(mf), t)
    params = jax.jit(jm.init, static_argnums=3)(jax.random.PRNGKey(0), *jargs)["params"]
    params = _randomize(params, rng, keys=("norm",))
    ref = jax.jit(jm.apply, static_argnums=3)({"params": params}, *jargs)
    tm = load_flax_params(MaskedTransformerDecoder(mode="frame", head="embedding", **kw),
                          _np_tree(params))
    with torch.no_grad():
        out = tm([_t(m).permute(0, 3, 1, 2) for m in ms], _t(mf).permute(0, 3, 1, 2), t)
    for k in ("pred_logits_all", "pred_masks_all", "pred_embeds"):
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_tracking_and_postprocess_match_jax():
    rng = np.random.RandomState(5)
    b, t, q, k, c = 1, 4, 8, 5, 16
    embeds = rng.randn(b, t, q, c).astype(np.float32)
    logits = (rng.randn(b, t, q, k + 1) * 3).astype(np.float32)
    masks = rng.randn(q, t, 6, 8).astype(np.float32)

    ref_idx = np.asarray(jax_tracking.track_by_embeds(jnp.asarray(embeds)))
    idx = tracking.track_by_embeds(_t(embeds))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)

    ref_aligned = jax_tracking.apply_track_indices(jnp.asarray(logits), jnp.asarray(ref_idx))
    aligned = tracking.apply_track_indices(_t(logits), idx)
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(ref_aligned))

    ref_scores = jax_eval_scores(ref_aligned, True)[0]
    scores = eval_scores(aligned)[0]
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-6, atol=1e-7)

    ref = jax_topk(ref_scores, jnp.asarray(masks), 10, track_indices=jnp.asarray(ref_idx[0]))
    out = inference_video_topk(scores, _t(masks), 10, track_indices=idx[0])
    for name in ("labels", "query_idx"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)
    for name in ("scores", "entropy", "mask_logits"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_single_frame_tracking_is_identity():
    idx = tracking.track_by_embeds(torch.randn(2, 1, 5, 4))
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(5), (2, 1, 5)))
