"""PyTorch port, the pixel decoder, the frame decoder (post- and pre-norm) and
the tracking and top-k post-process against the JAX package on the CPU in
f32.  Shapes and helpers: ``tests/test_torch_port_modules.py``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvis_tpu.models import tracking as jax_tracking
from openvis_tpu.models.meta.simple_baseline import eval_scores as jax_eval_scores
from openvis_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from openvis_tpu.models.postprocess import inference_video_topk as jax_topk
from openvis_tpu.models.transformer_decoder import MaskedTransformerDecoder as JaxDecoder
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, load_flax_params
from openvis_tpu_torch.models import tracking
from openvis_tpu_torch.models.backbone.resnet import feature_channels
from openvis_tpu_torch.models.meta.simple_baseline import eval_scores
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.transformer_decoder import MaskedTransformerDecoder

from test_torch_port_modules import (  # noqa: F401  (fixtures and helpers)
    D,
    HID,
    NHEADS,
    Q,
    _features,
    _np_tree,
    _randomize,
    _t,
)
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def test_pixel_decoder_matches_jax():
    rng = np.random.RandomState(3)
    feats = _features(rng)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jm = JaxPixelDecoder(conv_dim=HID, mask_dim=HID, enc_layers=2, n_heads=NHEADS,
                         n_points=4, d_ffn=128)
    tm = MSDeformAttnPixelDecoder(feature_channels(50), conv_dim=HID, mask_dim=HID,
                                  enc_layers=2, n_heads=NHEADS, n_points=4, d_ffn=128)
    # the port's seeded init (flax's initializers, the ring bias) as the
    # weights: JAX's init would compile the decoder once more
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(init_params(tm, seed=0).state_dict()))
    params = _randomize(params, rng, keys=("norm",))
    # sampling leaves the init ring: random offset / attention-weight kernels
    params = _randomize(params, rng, keys=("sampling_offsets/kernel",
                                           "attention_weights/kernel"), scale=0.05)
    mf, _, ms = jax.jit(jm.apply)({"params": params}, jfeats)
    tm = load_flax_params(tm, _np_tree(params))
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
    # the port's seeded init (flax's initializers) as the weights
    tm = init_params(MaskedTransformerDecoder(mode="frame", head="embedding", **kw), seed=0)
    params = _randomize(jax.tree.map(jnp.asarray, flax_from_state_dict(tm.state_dict())), rng,
                        keys=("norm",))
    ref = jax.jit(jm.apply, static_argnums=3)({"params": params}, *jargs)
    tm = load_flax_params(tm, _np_tree(params))
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

    ref_idx = np.asarray(jax.jit(jax_tracking.track_by_embeds)(jnp.asarray(embeds)))
    idx = tracking.track_by_embeds(_t(embeds))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)

    ref_aligned = jax.jit(jax_tracking.apply_track_indices)(jnp.asarray(logits),
                                                            jnp.asarray(ref_idx))
    aligned = tracking.apply_track_indices(_t(logits), idx)
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(ref_aligned))

    ref_scores = jax.jit(lambda a: jax_eval_scores(a, True)[0])(ref_aligned)
    scores = eval_scores(aligned)[0]
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-6, atol=1e-7)

    ref = jax.jit(lambda sc, m, ti: jax_topk(sc, m, 10, track_indices=ti))(
        ref_scores, jnp.asarray(masks), jnp.asarray(ref_idx[0]))
    out = inference_video_topk(scores, _t(masks), 10, track_indices=idx[0])
    for name in ("labels", "query_idx"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)
    for name in ("scores", "entropy", "mask_logits"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
