"""PyTorch port, SANOnline's side adapter against the JAX package on the CPU in
f32: the CLIP attention with a dense bias and in the sos-split form, the
front and post encodes; offline SAN builds (over a Swin trunk too) and its
train step raises its named error.  Shapes and helpers:
``tests/test_torch_port_san.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvis_tpu.models import side_adapter as jax_sa
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.models.segmenter import Segmenter

from test_torch_port_san import (  # noqa: F401  (fixtures and helpers)
    B,
    BROKEN,
    D,
    HID,
    K,
    MERGE,
    Q,
    REL_TO_MAX,
    T,
    TINY,
    TINY_CLIP,
    _rel,
    san,
    san_cfg,
    tiny_clip,
)


@pytest.mark.parametrize("form", ["dense", "sos_split"])
def test_clip_attention_matches_jax(form):
    rng = np.random.RandomState(1)
    c, heads, sos, l = 64, 4, 3, 1 + 16
    attn = init_params(clip_model.CLIPAttention(c, heads), seed=1)
    tree = flax_from_state_dict(attn.state_dict())
    x = rng.randn(2, sos + l, c).astype(np.float32)
    if form == "dense":
        bias, kw = rng.randn(2, heads, sos + l, sos + l).astype(np.float32), {}
    else:
        bias, kw = rng.randn(2, heads, sos, l).astype(np.float32) * 3, {"sos_q": sos}
    ref = jax.jit(lambda p, v, b: jax_clip.CLIPAttention(c, heads).apply(
        {"params": p}, v, attn_bias=b, **kw))(tree, jnp.asarray(x), jnp.asarray(bias))
    with torch.no_grad():
        got = attn(torch.from_numpy(x), attn_bias=torch.from_numpy(bias), **kw)
    assert _rel(got, ref) <= REL_TO_MAX


def test_side_adapter_front_and_post_encode_match_jax(san):
    model, params, frames, _, rng = san
    adapter = model.clip_adapter
    jmod = jax_sa.SideAdapter(clip_model_name=TINY, out_dims=HID, broken_idx=BROKEN,
                              merge_ids=MERGE, num_queries=Q)
    jp = {"params": params["clip_adapter"]}
    raw = (frames * 50 + 120).astype(np.float32)
    biases = rng.randn(B * T, TINY_CLIP["vision_heads"], Q, 4, 6).astype(np.float32) * 4

    def both(p, x, b):
        mg, toks, grid = jmod.apply(p, x, method=jmod.front_encode)
        return mg, toks, jmod.apply(p, toks, b, grid, method=jmod.post_encode)

    mg, toks, feats = jax.jit(both)(jp, jnp.asarray(raw), jnp.asarray(biases))
    with torch.no_grad():
        pmg, ptoks, pgrid = adapter.front_encode(torch.from_numpy(raw))
        pfeats = adapter.post_encode(ptoks, torch.from_numpy(biases), pgrid)
    assert tuple(pgrid) == (4, 4)
    assert _rel(ptoks, toks) <= REL_TO_MAX
    for a, b in zip(pmg, mg):
        assert _rel(a.permute(0, 2, 3, 1), b) <= REL_TO_MAX
    assert pfeats.shape == (B * T, Q, D) and _rel(pfeats, feats) <= REL_TO_MAX


def test_offline_san_raises_its_roadmap_item():
    """Offline SAN builds over the video decoder and evaluates (its parity:
    tests/test_torch_port_offline.py); its train step raises, naming the
    JAX package's failing criterion and ROADMAP.md §3, with the Swin trunk
    of the SAN Swin-B recipes too, which builds (tests/test_torch_port_swin*.py)."""
    cfg = san_cfg(Config)
    offline = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="SAN", transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="side_adapter_video")))
    model = train.build_model(offline, device="cpu")
    assert model.segmenter.video
    with pytest.raises(NotImplementedError, match=r"criterion\.py:290.*ROADMAP\.md §3"):
        train.build_train_step(offline, model, K, device="cpu")
    swin = dataclasses.replace(offline, model=dataclasses.replace(
        offline.model, backbone=dataclasses.replace(offline.model.backbone, name="swin")))
    assert type(Segmenter(swin.model).backbone).__name__ == "SwinTransformer"
    with pytest.raises(NotImplementedError, match=r"criterion\.py:290.*ROADMAP\.md §3"):
        train.build_train_step(swin, train.build_model(swin, device="cpu"), K, device="cpu")
