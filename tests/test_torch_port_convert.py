"""PyTorch port: the flax -> torch parameter converter and the seeded init."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.train as jax_train
from openvis_tpu.config import Config
from openvis_tpu_torch import train
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    init_params,
    load_flax_params,
    params_from_flax,
)
from openvis_tpu_torch.models.pixel_decoder import ring_bias
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

K, D, HID = 5, 32, 64


def _cfg() -> Config:
    cfg = Config()
    m = dataclasses.replace(
        cfg.model,
        num_classes=K,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID,
            transformer_enc_layers=2, dim_feedforward=128, num_heads=4, num_points=4,
        ),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, hidden_dim=HID, num_queries=8, nheads=4,
            dim_feedforward=128, dec_layers=2, mask_dim=HID, clip_embed_dim=D,
        ),
    )
    return dataclasses.replace(cfg, model=m)


@pytest.fixture(scope="module")
def flax_tree():
    """Random leaves in the shapes of the JAX model's parameter tree (traced
    with ``eval_shape``: nothing is computed)."""
    cfg = _cfg()
    jm = jax_train.build_model(cfg)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 96, 3)), 2,
                        jnp.zeros((K, D)))
    )["params"]
    rng = np.random.RandomState(0)
    return cfg, jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_round_trip_is_exact(flax_tree):
    cfg, tree = flax_tree
    model = load_flax_params(train.build_model(cfg, device="cpu"), tree)
    back = dict(_flat(flax_from_state_dict(model.state_dict())))
    orig = dict(_flat(jax.tree.map(np.asarray, tree)))
    assert back.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg="/".join(k))


def test_leaf_mapping(flax_tree):
    cfg, tree = flax_tree
    sd = params_from_flax(tree)
    seg = tree["segmenter"]
    dense = seg["pixel_decoder"]["encoder"]["layer0"]["linear1"]["kernel"]
    np.testing.assert_array_equal(
        sd["segmenter.pixel_decoder.encoder.layer0.linear1.weight"].numpy(), dense.T)
    conv = seg["backbone"]["res2_block0"]["conv2"]["kernel"]            # HWIO
    np.testing.assert_array_equal(
        sd["segmenter.backbone.res2_block0.conv2.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    # a LayerNorm's scale becomes weight; a FrozenAffine keeps scale
    assert "segmenter.pixel_decoder.encoder.layer0.norm1.weight" in sd
    assert "segmenter.backbone.res2_block0.norm1.scale" in sd
    assert "segmenter.backbone.stem_norm1.scale" in sd
    for name in ("non_object_embedding", "segmenter.predictor.query_feat",
                 "segmenter.predictor.level_embed", "segmenter.pixel_decoder.level_embed"):
        assert name in sd, name


def test_bf16_leaves_convert_exactly(flax_tree):
    _, tree = flax_tree
    leaf = jnp.asarray(tree["non_object_embedding"]).astype(jnp.bfloat16)
    sd = params_from_flax({"non_object_embedding": np.asarray(leaf)})
    assert sd["non_object_embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["non_object_embedding"].float().numpy(),
                                  np.asarray(leaf.astype(jnp.float32)))


def test_rejects_missing_extra_and_misshapen_keys(flax_tree):
    cfg, tree = flax_tree
    missing = jax.tree.map(lambda x: x, tree)
    del missing["segmenter"]["predictor"]["query_embed"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_params(train.build_model(cfg, device="cpu"), missing)
    extra = jax.tree.map(lambda x: x, tree)
    extra["segmenter"]["predictor"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_params(train.build_model(cfg, device="cpu"), extra)
    bad = jax.tree.map(lambda x: x, tree)
    bad["non_object_embedding"] = np.zeros((2, D), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax_params(train.build_model(cfg, device="cpu"), bad)
    # rank 3 is a 1-D Conv (BriVIS's resampler, tests/test_torch_port_brivis.py)
    with pytest.raises(ValueError, match="kernel of rank 5"):
        params_from_flax({"x": {"kernel": np.zeros((2, 2, 2, 2, 2), np.float32)}})


def test_seeded_init(flax_tree):
    cfg, _ = flax_tree
    a = init_params(train.build_model(cfg, device="cpu"), seed=3).state_dict()
    b = init_params(train.build_model(cfg, device="cpu"), seed=3).state_dict()
    c = init_params(train.build_model(cfg, device="cpu"), seed=4).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(a["segmenter.predictor.query_feat"], c["segmenter.predictor.query_feat"])
    attn = "segmenter.pixel_decoder.encoder.layer1.self_attn."
    assert torch.count_nonzero(a[attn + "sampling_offsets.weight"]) == 0
    assert torch.count_nonzero(a[attn + "attention_weights.weight"]) == 0
    assert torch.count_nonzero(a[attn + "attention_weights.bias"]) == 0
    np.testing.assert_array_equal(a[attn + "sampling_offsets.bias"].numpy(), ring_bias(4, 3, 4))
    assert torch.equal(a["segmenter.backbone.res3_block0.norm2.scale"], torch.ones(128))
    assert torch.equal(a["segmenter.predictor.heads.decoder_norm.weight"], torch.ones(HID))
    w = a["segmenter.backbone.res4_block1.conv2.weight"]                # fan_in 256*9
    assert abs(w.std().item() - (1 / (256 * 9)) ** 0.5) < 0.1 * (1 / (256 * 9)) ** 0.5
