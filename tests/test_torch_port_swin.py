"""PyTorch port, the Swin trunk against the JAX package on the CPU in f32: the
forward on maps that are not window multiples, through both shifts, with the
absolute position embedding on and off; the stochastic-depth schedule, its
per-sample keep draw and 1/keep scaling, active in training only; the d2
Swin and timm ResNet readers against ``tools/convert_weights.py`` on
synthetic state dicts; and the parameter groups of a Swin segmenter against
JAX's ``label_params`` (its LayerNorms frozen by JAX's FrozenAffine rule,
``freeze_at`` over the Swin stages).

Shapes: a Swin of width 16 with depths (2, 2, 2, 2), heads (2, 2, 4, 4) and
windows of 3 on 60x92 frames (15x23 patches: no stage a window multiple)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.train as jax_train
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models.backbone.swin import SwinTransformer as JaxSwin
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import flax_from_state_dict, flax_path, init_params, load_flax_params
from openvis_tpu_torch.models.backbone import swin
from openvis_tpu_torch.models.backbone.resnet import ResNet
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.weights import convert_swin, convert_timm_resnet, swin_size
from tools import convert_weights as tool
from torch_port_common import (
    flat,
    jax_labels,
    jit_safe_jax_swin,
    one_thread_fixture,
    rel,
    seeded_model,
)

SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=3)
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
REL_TO_MAX = 1e-5

one_thread = one_thread_fixture()


def swin_cfg(cls):
    """SimpleBaselineOnline over the test's Swin (APE on, 8x8 pretraining
    grid) with a tiny pixel decoder and decoder."""
    cfg = cls()
    b = dataclasses.replace(cfg.model.backbone, name="swin", swin_embed_dim=16,
                            swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 2, 4, 4),
                            swin_window_size=3, swin_ape=True, swin_pretrain_img_size=32,
                            swin_drop_path_rate=0.3)
    td = dataclasses.replace(cfg.model.transformer_decoder, hidden_dim=32, num_queries=4,
                             nheads=2, dim_feedforward=32, dec_layers=1, mask_dim=32,
                             clip_embed_dim=16)
    pd = dataclasses.replace(cfg.model.pixel_decoder, conv_dim=32, mask_dim=32,
                             transformer_enc_layers=1, dim_feedforward=32, num_heads=2)
    crit = dataclasses.replace(cfg.model.criterion, train_num_points=16)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=3, backbone=b, transformer_decoder=td, pixel_decoder=pd,
        criterion=crit), solver=dataclasses.replace(cfg.solver, amp=False))


def _random_norms(model, rng):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            elif p.dim() == 1:   # biases: nonzero, so that a misplaced one shows
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    return model


def test_swin_forward_matches_jax():
    """Every stage's map is off the window grid (padded, then cropped), each
    stage runs a plain and a shifted block; without the APE on 60x92 frames,
    with it (resized bicubic from the 8x8 pretraining grid) on 64x100."""
    for ape, hw in ((False, (60, 92)), (True, (64, 100))):
        kw = dict(SWIN, ape=ape, pretrain_img_size=32)
        rng = np.random.RandomState(0)
        model = _random_norms(init_params(swin.SwinTransformer(**kw), seed=0), rng)
        tree = flax_from_state_dict(model.state_dict())
        x = rng.randn(2, *hw, 3).astype(np.float32)
        with pytest.MonkeyPatch.context() as mp:
            jit_safe_jax_swin(mp, shapes=((6, 9, 3, 1), (3, 6, 3, 1)))
            ref = jax.jit(lambda p, v: JaxSwin(**kw).apply({"params": p}, v))(
                tree, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert [b.shift for b in (model.stage0_block0, model.stage0_block1)] == [0, 1]
        for i, name in enumerate(("res2", "res3", "res4", "res5")):
            g = got[name].permute(0, 2, 3, 1).numpy()
            assert g.shape == np.asarray(ref[name]).shape
            assert g.shape[-1] == 16 * 2 ** i
            assert rel(g, ref[name]) <= REL_TO_MAX, (ape, name)
        assert got["res2"].shape[-2:] == (hw[0] // 4, hw[1] // 4)


def test_drop_path_schedule_and_keep_scaling():
    """Rates ``linspace(0, rate, sum(depths))`` over the blocks; inside
    ``dropout_generator`` a block keeps each sample's branch with probability
    1 - rate, drawn from the generator, and scales the kept ones by 1/keep;
    outside it (eval) the branch passes whole.  The train loss enters it."""
    model = swin.SwinTransformer(**SWIN, drop_path_rate=0.3)
    rates = [getattr(model, f"stage{s}_block{b}").drop_path for s in range(4) for b in range(2)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 8))
    block = model.stage3_block1
    y = torch.randn(64, 2, 3, 4)
    assert block._drop(y) is y                                      # eval: no draw
    with swin.dropout_generator(torch.Generator().manual_seed(5)):
        got = block._drop(y)
    keep = 1 - 0.3
    mask = torch.bernoulli(torch.full((64, 1, 1, 1), keep),
                           generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, y * mask / keep, rtol=0, atol=0)
    assert 0 < mask.sum() < 64
    with swin.dropout_generator(torch.Generator().manual_seed(5)):
        assert model.stage0_block0._drop(y) is y                    # rate 0: no draw

    calls = []
    orig = swin.SwinBlock._drop

    def counting(self, v):
        calls.append(swin._DROPOUT.get() is not None)
        return orig(self, v)

    cfg = swin_cfg(Config)
    model = train.build_model(cfg, device="cpu")
    text = torch.randn(3, 16)
    batch = {"pixels": torch.randn(1, 1, 64, 96, 3), "text_feats": text,
             "targets": ClipTargets(torch.zeros(1, 2, dtype=torch.int64),
                                    torch.rand(1, 2, 1, 64, 96) > 0.5,
                                    torch.ones(1, 2, dtype=torch.bool),
                                    torch.ones(1, 2, 1, dtype=torch.bool))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(swin.SwinBlock, "_drop", counting)
        with torch.no_grad():
            train.make_eval_fn(cfg, model)(batch["pixels"][0], text)
        assert len(calls) == 16 and not any(calls)                   # eval: off
        calls.clear()
        loss, _ = train.make_loss_fn(cfg, model, 3)(dict(model.named_parameters()), batch,
                                                    torch.Generator().manual_seed(0))
        assert len(calls) == 16 and all(calls) and torch.isfinite(loss)   # train: on


def _swin_d2_state(rng, ape: bool):
    """A synthetic d2 Mask2Former Swin-T backbone (width 16) in the reference's names."""
    depths, c = swin.SWIN_SHAPES["tiny"]["depths"], 16
    heads = (1, 2, 2, 4)
    d = {"backbone.patch_embed.proj.weight": rng.randn(c, 3, 4, 4),
         "backbone.patch_embed.proj.bias": rng.randn(c),
         "backbone.patch_embed.norm.weight": rng.randn(c),
         "backbone.patch_embed.norm.bias": rng.randn(c)}
    if ape:
        d["backbone.absolute_pos_embed"] = rng.randn(1, c, 8, 8)
    dim = c
    for si, nb in enumerate(depths):
        for bi in range(nb):
            pre = f"backbone.layers.{si}.blocks.{bi}"
            for n, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                             ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                             ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                             ("attn.relative_position_bias_table", (25, heads[si])),
                             ("attn.relative_position_index", (9, 9)),
                             ("norm2.weight", (dim,)), ("norm2.bias", (dim,)),
                             ("mlp.fc1.weight", (4 * dim, dim)), ("mlp.fc1.bias", (4 * dim,)),
                             ("mlp.fc2.weight", (dim, 4 * dim)), ("mlp.fc2.bias", (dim,))):
                d[f"{pre}.{n}"] = rng.randn(*shape)
        if si < 3:
            pre = f"backbone.layers.{si}.downsample"
            d[f"{pre}.norm.weight"], d[f"{pre}.norm.bias"] = rng.randn(4 * dim), rng.randn(4 * dim)
            d[f"{pre}.reduction.weight"] = rng.randn(2 * dim, 4 * dim)
        d[f"backbone.norm{si}.weight"] = rng.randn(dim)
        d[f"backbone.norm{si}.bias"] = rng.randn(dim)
        dim *= 2
    return {k: v.astype(np.float32) for k, v in d.items()}, heads


def _timm_state(rng):
    d = {"conv1.weight": rng.randn(8, 3, 7, 7), "fc.weight": rng.randn(10, 64)}
    bn = lambda n, c: {f"{n}.{p}": (rng.rand(c) + 0.5 if p == "running_var"  # noqa: E731
                                   else rng.randn(c)) for p in ("weight", "bias",
                                                                 "running_mean", "running_var")}
    d.update(bn("bn1", 8))
    cin = 8
    for si, nb in enumerate((3, 4, 6, 3)):
        width = 8 * 2 ** si
        for bi in range(nb):
            pre = f"layer{si + 1}.{bi}"
            for ci, (o, i, k) in enumerate(((width, cin, 1), (width, width, 3),
                                            (4 * width, width, 1)), 1):
                d[f"{pre}.conv{ci}.weight"] = rng.randn(o, i, k, k)
                d.update(bn(f"{pre}.bn{ci}", o))
            if bi == 0:
                d[f"{pre}.downsample.0.weight"] = rng.randn(4 * width, cin, 1, 1)
                d.update(bn(f"{pre}.downsample.1", 4 * width))
            cin = 4 * width
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _assert_same_tree(got, want):
    g, w = dict(flat(got)), dict(flat(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_swin_and_timm_readers_match_the_tool():
    """``convert_swin`` (through ``convert_mask2former(backbone="swin")``) and
    ``convert_timm_resnet`` build the tool's trees from synthetic reference
    state dicts, bit for bit; the trees load strictly into the port's trunks
    (the ``relative_position_index`` buffers are rebuilt, not read)."""
    rng = np.random.RandomState(0)
    for ape in (False, True):
        state, heads = _swin_d2_state(rng, ape)
        want = tool.convert_swin(tool.migrate_legacy_keys(state), "tiny")
        got = convert_swin(state, "tiny")
        _assert_same_tree(got, want)
        trunk = swin.SwinTransformer(embed_dim=16, depths=(2, 2, 6, 2), num_heads=heads,
                                     window_size=3, ape=ape, pretrain_img_size=32)
        load_flax_params(trunk, got)
        ln = trunk.stage1_block0.norm1.weight.detach().numpy()
        np.testing.assert_array_equal(ln, state["backbone.layers.1.blocks.0.norm1.weight"])
    state = _timm_state(rng)
    want = tool.convert_timm_resnet(state)
    got = convert_timm_resnet(state)
    _assert_same_tree(got, want)
    load_flax_params(ResNet(50, 8, stride_in_1x1=False), got)
    cfg = Config()
    for size, shape in swin.SWIN_SHAPES.items():
        b = dataclasses.replace(cfg.model.backbone, name="swin", swin_embed_dim=shape["embed_dim"],
                                swin_depths=shape["depths"], swin_num_heads=shape["num_heads"])
        assert swin_size(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=b))) == size


def test_swin_parameter_groups_match_jax():
    """The groups of every parameter of a Swin segmenter equal JAX's
    ``label_params``, with ``freeze_at`` 0 and 2: the LayerNorms of the trunk
    frozen, the bias tables and the APE ``backbone_embed``, ``qkv/bias``
    ``backbone_nodecay``; JAX's tree has the port's names."""
    model, tree = seeded_model(swin_cfg(Config))
    jm = jax_train.build_model(swin_cfg(JaxConfig))
    with pytest.MonkeyPatch.context() as mp:
        jit_safe_jax_swin(mp)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)), 1, jnp.zeros((3, 16))))["params"]
    jtree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert dict(flat(jtree)).keys() == dict(flat(tree)).keys()
    named = dict(model.named_parameters())
    for freeze_at in (0, 2):
        groups = label_params(named.items(), freeze_at=freeze_at)
        pl = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in named.items()}
        assert pl == jax_labels(tree, freeze_at=freeze_at)
    groups = label_params(named.items())
    pl = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in named.items()}
    bb = "segmenter/backbone/"
    for k in ("stage0_block0/norm1/scale", "stage2_block1/norm2/bias", "patch_norm/scale",
              "out_norm3/scale", "downsample1/norm/bias"):
        assert pl[bb + k] == "frozen", k
    assert pl[bb + "stage1_block1/attn/relative_position_bias_table"] == "backbone_embed"
    assert pl[bb + "absolute_pos_embed"] == "backbone_embed"
    assert pl[bb + "stage1_block1/attn/qkv/bias"] == "backbone_nodecay"
    assert pl[bb + "downsample0/reduction/kernel"] == "backbone"
    frozen2 = label_params(named.items(), freeze_at=2)
    assert frozen2["segmenter.backbone.stage0_block1.mlp_fc1.weight"] == "frozen"
    assert frozen2["segmenter.backbone.stage1_block0.mlp_fc1.weight"] == "backbone"
    # a Swin LayerNorm's flax ``scale`` is the port's ``weight`` (not a folded
    # BatchNorm's ``scale``)
    assert "segmenter.backbone.stage0_block0.norm1.weight" in named
