"""PyTorch port, BriVIS's temporal resamplers against the JAX package on the
CPU in f32: each resampler and its split (temporal, decoupled, raw), and the
real frames' outputs moved by frames appended to the video (the engine pads
T as the JAX engine does).  Shapes and helpers: ``tests/test_torch_port_brivis.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvis_tpu_torch.convert import flax_from_state_dict
from openvis_tpu_torch.models import resampler

from test_torch_port_san import _rel  # noqa: F401  (fixtures and helpers)
from test_torch_port_brivis import (  # noqa: F401  (fixtures and helpers)
    HID,
    LAYERS,
    Q,
    RESAMPLERS,
    SPLIT_REL_TO_MAX,
    _jax_resampler,
    _port_resampler,
    _resampler_inputs,
    tiny_clip,
)


@pytest.mark.parametrize("name", RESAMPLERS)
def test_resampler_and_its_split_match_jax(name):
    rng = np.random.RandomState(3)
    mod = _port_resampler(name, seed=3)
    jmod = _jax_resampler(name)
    tree = {"params": flax_from_state_dict(mod.state_dict())}
    x, mf, af, ms_feats, ms_pos = _resampler_inputs(rng)
    raw = name == "raw"
    extra = (ms_feats, ms_pos) if raw else ()
    ref = jax.jit(lambda p, *a: jmod.apply(p, *a))(
        tree, *jax.tree.map(jnp.asarray, (x, mf, af, *extra)))
    args = [torch.from_numpy(a) for a in (x, mf, af)]
    if raw:
        args += [[torch.from_numpy(a) for a in ms_feats], [torch.from_numpy(a) for a in ms_pos]]
    with torch.no_grad():
        got = mod(*args)
        b, t = x.shape[:2]
        if raw:  # the halves, layer by layer, in windows of 2 frames
            seq = resampler._to_sequences(args[0])
            for i in range(LAYERS):
                pf = resampler._to_frames(mod.temporal_half(seq, i), b)
                lvl = i % 3
                pf = torch.cat([mod.frame_half(pf[j:j + 2], args[3][lvl][j:j + 2], args[4][lvl],
                                               i) for j in range(0, b * t, 2)])
                seq = resampler._to_sequences(pf.reshape(b, t, Q, HID))
            final = mod.finalize_embeds(resampler._to_frames(seq, b)).reshape(b, t, Q, HID)
        else:
            final = mod.final_embeds(args[0])
        masks, biases = mod.predict_frames(final.reshape(b * t, *final.shape[2:]), *args[1:3])
    nq = 6 if name == "decoupled" else Q
    shapes = {"pred_masks_all": (LAYERS + 1, b, nq, t, 6, 8),
              "attn_biases_all": (LAYERS + 1, b * t, 4, nq, 3, 4),
              "pred_embeds": (b, t, nq, HID)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert _rel(got[k], ref[k]) <= SPLIT_REL_TO_MAX, k
    assert _rel(final, got["pred_embeds"]) <= SPLIT_REL_TO_MAX
    assert _rel(masks, got["pred_masks_all"][-1].transpose(1, 2).reshape(b * t, nq, 6, 8)) \
        <= SPLIT_REL_TO_MAX
    assert _rel(biases, got["attn_biases_all"][-1]) <= SPLIT_REL_TO_MAX


def test_resampler_sees_appended_frames():
    """The temporal self-attention is not masked: frames appended to a video
    change its real frames' outputs (why the engine pads as JAX's does)."""
    mod = _port_resampler("temporal", seed=4)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 5, Q, HID).astype(np.float32))
    with torch.no_grad():
        real = mod.final_embeds(x)
        padded = mod.final_embeds(torch.cat([x, x[:, -1:].expand(1, 3, Q, HID)], 1))[:, :5]
    assert _rel(padded, real) > 1e-2
