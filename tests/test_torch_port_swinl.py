"""PyTorch port, the Swin-L OpenVIS recipe
(``configs/openvoc_ytvis_coco/swin/openvis_swinL_bs16_6000st_ViT-L-336.yaml``)
against the JAX package on the CPU in f32: the Swin-L trunk at its widths
(192 ... 1536), heads (6, 12, 24, 48) and windows of 12 (2 blocks a stage)
and its drop-path schedule over the recipe's 24 blocks;
the d2 reader at ``swin_size="large"`` against ``tools/convert_weights.py``
over the whole 24-block key layout, with the flax path and the parameter
groups; offline OpenVIS with the ``frame_proposal`` head at the recipe's 200
queries (the engine's single shot of T=5 frames padded to 8, the
per-frame matcher's loss and every gradient) over a narrow Swin of Swin-L's
heads and windows; then the recipe through the CLI (2 steps from a stand-in
init, ``--eval-only`` with the frozen ``mask`` CLIP tower).

Shapes: the trunk alone on 2 frames of 100x164 (no stage a window
multiple); the model a Swin of width 12 (heads of 2), depths (2, 2, 2, 2),
windows of 12, with a tiny segmenter (64x96 frames, 1 encoder and 1 decoder
layer, hidden 64) at Q=200.  One set
of weights, the port's seeded init, goes into both packages
(``convert.flax_from_state_dict``); each JAX reference is one ``jax.jit``, the
JAX Swin under ``torch_port_common.jit_safe_jax_swin``.  Peak memory ~1 GB
(the trunk at Swin-L's widths: 77 M parameters, in both packages)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import openvis_tpu.engine as jax_engine
import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models.backbone import swin as jax_swin
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, engine, train
from openvis_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import flax_from_state_dict, flax_path, init_params, params_from_flax
from openvis_tpu_torch.models.backbone import swin
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.utils import flax_msgpack
from openvis_tpu_torch.weights import convert_mask2former, convert_swin, swin_size
from test_torch_port_cli import CFG_YAML, D as CLI_D, cli_root  # noqa: F401  (the CLI's fixture)
from tests.test_convert_weights import _d2_state
from tools import convert_weights as tool
from torch_port_common import flat, jax_labels, jit_safe_jax_swin, one_thread_fixture, rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "openvoc_ytvis_coco", "swin",
                      "openvis_swinL_bs16_6000st_ViT-L-336.yaml")
LARGE = swin.SWIN_SHAPES["large"]
SWIN_L = dict(embed_dim=LARGE["embed_dim"], depths=(2, 2, 2, 2),
              num_heads=LARGE["num_heads"], window_size=12, pretrain_img_size=384)
FRAMES_HW = (100, 164)   # 25x41 patches: 36x48, 24x24, 12x12, 12x12 padded windows
# a narrow trunk of Swin-L's heads and windows (head width 2) for the model
NARROW = dict(swin_embed_dim=12, swin_depths=(2, 2, 2, 2), swin_num_heads=LARGE["num_heads"],
              swin_window_size=12, swin_pretrain_img_size=384, swin_drop_path_rate=0.0)
K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 5, 64, 96, 64, 200, 3, 32
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
TRUNK_REL_TO_MAX = 1e-5
FORWARD_REL_TO_MAX = 1e-4  # the whole model, ~60 layers deep
LOSS_RTOL = 1e-5
GRAD_REL_NORM = 1e-2       # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)

one_thread = one_thread_fixture()


def _random_affines(model, rng):
    """Norm scales near 1 and every bias nonzero (a misplaced one shows, and
    padded windows do not stay exactly zero)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            elif p.dim() == 1 or name.endswith("bias_table"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    return model


def test_swinl_trunk_and_drop_path_schedule_match_jax():
    """Swin-L's widths, heads and windows of 12 (the recipe's trunk: no APE,
    so its 384 pretraining size reads nothing; the APE's resize is
    ``tests/test_torch_port_swin.py``'s), 2 blocks a stage, on maps off the
    window grid at every stage; then the drop-path rates of the recipe's
    [2, 2, 18, 2] blocks against the rates JAX's trunk gives its blocks."""
    rng = np.random.RandomState(0)
    model = _random_affines(init_params(swin.SwinTransformer(**SWIN_L), seed=0), rng)
    tree = flax_from_state_dict(model.state_dict())
    x = rng.randn(2, *FRAMES_HW, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        jit_safe_jax_swin(mp, shapes=((36, 48, 12, 6), (24, 24, 12, 6), (12, 12, 12, 6)))
        ref = jax.jit(lambda p, v: jax_swin.SwinTransformer(**SWIN_L).apply({"params": p}, v))(
            tree, jnp.asarray(x))
    del tree
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, name in enumerate(("res2", "res3", "res4", "res5")):
        g = got[name].permute(0, 2, 3, 1).numpy()
        assert g.shape == np.asarray(ref[name]).shape and g.shape[-1] == 192 * 2 ** i
        assert rel(g, ref[name]) <= TRUNK_REL_TO_MAX, name
    assert model.stage3_block1.attn.relative_position_bias_table.shape == (23 * 23, 48)

    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_swin.SwinBlock) and context.method_name == "__call__":
            rates.append((context.module.name, context.module.drop_path))
        return next_fun(*args, **kwargs)

    full = dict(LARGE, embed_dim=12, window_size=12)   # the recipe's blocks, a narrow width
    with pytest.MonkeyPatch.context() as mp:
        jit_safe_jax_swin(mp, shapes=())
        with nn.intercept_methods(record):
            jax.eval_shape(lambda: jax_swin.SwinTransformer(**full, drop_path_rate=0.3).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 3))))
    port = swin.SwinTransformer(**full, drop_path_rate=0.3)
    want = [(n, getattr(port, n).drop_path) for n, _ in port.named_children()
            if "_block" in n]
    assert len(want) == 24 and rates[:24] == want
    np.testing.assert_allclose([r for _, r in want], np.linspace(0, 0.3, 24))


def _swinl_d2_state(rng, c=12):
    """A synthetic d2 Mask2Former Swin-L state dict in the reference's names:
    Swin-L's 24 blocks, heads and (23^2, heads) bias tables at width ``c``,
    with ``tests/test_convert_weights.py``'s pixel decoder and predictor."""
    d = {k: v for k, v in _d2_state(rng).items() if not k.startswith("backbone.")}
    heads, depths = LARGE["num_heads"], LARGE["depths"]
    d.update({"backbone.patch_embed.proj.weight": rng.randn(c, 3, 4, 4),
              "backbone.patch_embed.proj.bias": rng.randn(c),
              "backbone.patch_embed.norm.weight": rng.randn(c),
              "backbone.patch_embed.norm.bias": rng.randn(c)})
    dim = c
    for si, nb in enumerate(depths):
        for bi in range(nb):
            pre = f"backbone.layers.{si}.blocks.{bi}"
            for n, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                             ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                             ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                             ("attn.relative_position_bias_table", (23 * 23, heads[si])),
                             ("attn.relative_position_index", (144, 144)),
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
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _same_tree(got, want):
    g, w = dict(flat(got)), dict(flat(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_swinl_reader_matches_the_tool(tmp_path):
    """``convert_swin(state, "large")`` and ``convert_mask2former(...,
    backbone="swin", swin_size="large")`` build the tool's trees bit for bit
    over Swin-L's 24 blocks; the tool's tree written as a flax ``.msgpack``
    reads back through the port's reader and ``convert.params_from_flax`` into
    a trunk of Swin-L's layout, strictly; every parameter of that trunk has
    JAX's group (its LayerNorms frozen); the recipe's trunk is ``"large"``."""
    state = _swinl_d2_state(np.random.RandomState(0))
    want = tool.convert_swin(tool.migrate_legacy_keys(state), "large")
    _same_tree(convert_swin(state, "large"), want)
    kw = dict(enc_layers=2, dec_layers=2, backbone="swin", swin_size="large")
    full = convert_mask2former(state, **kw)
    _same_tree(full, tool.convert_mask2former(state, **kw))
    assert len([k for k in full["backbone"] if "_block" in k]) == 24
    tool.save_msgpack(full, str(tmp_path / "m2f_swinL.msgpack"))
    read = flax_msgpack.read_msgpack(str(tmp_path / "m2f_swinL.msgpack"))
    trunk = swin.SwinTransformer(embed_dim=12, depths=LARGE["depths"],
                                 num_heads=LARGE["num_heads"], window_size=12)
    trunk.load_state_dict(params_from_flax(read["backbone"]), strict=True)
    np.testing.assert_array_equal(
        trunk.stage2_block17.attn.relative_position_bias_table.detach().numpy(),
        state["backbone.layers.2.blocks.17.attn.relative_position_bias_table"])
    named = {f"segmenter.backbone.{n}": p for n, p in trunk.named_parameters()}
    groups = label_params(named.items())
    pl = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in named.items()}
    tree = {"segmenter": {"backbone": flax_from_state_dict(trunk.state_dict())}}
    assert pl == jax_labels(tree)
    assert pl["segmenter/backbone/stage2_block17/norm2/scale"] == "frozen"
    assert pl["segmenter/backbone/stage3_block1/attn/relative_position_bias_table"] == \
        "backbone_embed"
    cfg = load_config(RECIPE)
    assert (cfg.model.backbone.swin_embed_dim, swin_size(cfg)) == (192, "large")
    assert (cfg.model.meta_architecture, cfg.model.transformer_decoder.name,
            cfg.model.transformer_decoder.num_queries, cfg.model.clip_adapter.name) == \
        ("OpenVIS", "frame_proposal", 200, "mask")


def openvis_cfg(cls):
    """Offline OpenVIS over the ``frame_proposal`` head at the recipe's 200
    queries, the narrow Swin, the tiny pixel decoder and decoder."""
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=1, meta_architecture="OpenVIS",
        backbone=dataclasses.replace(cfg.model.backbone, name="swin", **NARROW),
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="frame_proposal", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=1, mask_dim=HID,
            clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


def test_offline_openvis_200_queries_shot_and_step_match_jax():
    """The engine's single shot (T=5 frames padded to 8, the frame head's
    logits averaged over the 5 valid frames, every query's probability and
    mask) and the per-frame class-agnostic loss (the matcher on (5, 3, 200)
    costs a layer), its terms and every trainable gradient, one set of
    weights, frames and points."""
    rng = np.random.RandomState(0)
    cfg, jcfg = openvis_cfg(Config), openvis_cfg(JaxConfig)
    model = _random_affines(init_params(train.build_model(cfg, device="cpu"), seed=0), rng)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    labels, masks = rng.randint(0, K, (B, N)), rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            s = np.cumsum(rng.exponential(size=(b, p + 1)), -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]],
                                     -1).astype(np.float32)
        return table[(b, p)]

    tb = engine._bucket(T)
    padded = np.concatenate([frames, frames[-1:].repeat(tb - T, 0)])
    fv = np.arange(tb) < T
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        jit_safe_jax_swin(mp, shapes=((24, 24, 12, 6), (12, 12, 12, 6)))
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, b, p: jnp.asarray(draw(b[0], p)))
        jm = jax_train.build_model(jcfg)
        jshot = jax_engine.make_single_shot_fn(jcfg, jm, pre_topk=True)
        jloss_fn = jax_train.make_loss_fn(jcfg, jm, K)

        def ref_fn(p):
            fn = lambda q: jloss_fn(q, jbatch, jax.random.PRNGKey(1))  # noqa: E731
            return (jshot(p, jnp.asarray(padded), jnp.asarray(text), jnp.asarray(fv)),
                    jax.value_and_grad(fn, has_aux=True)(p))

        (jprobs, jmasks), ((jloss, jmetrics), jgrads) = jax.jit(ref_fn)(params)
    del params
    shot = engine.make_single_shot_fn(cfg, model, pre_topk=True)
    with torch.no_grad():
        probs, shot_masks = shot({n: p.detach() for n, p in model.named_parameters()},
                                 torch.from_numpy(padded), torch.from_numpy(text),
                                 torch.from_numpy(fv))
    assert probs.shape == (Q, 1) and shot_masks.shape == (Q, tb, H // 4, W // 4)
    assert rel(probs, jprobs) <= FORWARD_REL_TO_MAX
    assert rel(shot_masks, jmasks) <= FORWARD_REL_TO_MAX

    tbatch = {"pixels": torch.from_numpy(frames.reshape(B, T, H, W, 3)),
              "text_feats": torch.from_numpy(text),
              "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                     torch.from_numpy(valid),
                                     torch.ones(B, N, T, dtype=torch.bool))}
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
    try:
        step = train.build_train_step(cfg, model, K, device="cpu",
                                      draw_points=lambda g, b, p: torch.from_numpy(draw(b[0], p)))
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        loss, metrics = step.loss_fn(dict(model.named_parameters()), tbatch, torch.Generator())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    finally:
        torch.backends.mkldnn.enabled = prev
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    pgrads, jg = dict(flat(flax_from_state_dict(grads))), dict(flat(jgrads))
    assert "segmenter/backbone/stage0_block0/norm1/scale" not in pgrads   # frozen, as in JAX
    assert not np.any(jg["segmenter/backbone/stage0_block0/norm1/scale"])
    for part in ("backbone/stage3_block1/attn/relative_position_bias_table",
                 "backbone/patch_embed/kernel", "predictor/heads/class_embed/kernel"):
        assert np.any(pgrads[f"segmenter/{part}"]), part
    for k, g in pgrads.items():
        if k.endswith("k_proj/bias") or not np.any(jg[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(g).max() < 1e-5 and np.abs(jg[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(g - jg[k]) / np.linalg.norm(jg[k])
        assert err <= GRAD_REL_NORM, (k, err)


# the recipe cut to the tests' width (Swin-L's heads and windows kept, 2
# blocks a stage), its 0.3 drop path and 200 queries kept; the test-tiny CLIP
# in place of ViT-L/14@336px; pretrained/m2f_swinL.msgpack is not in the
# repository (training starts from _stand_in_init)
SWINL_OVERRIDES = ("model.weights=", "model.backbone.swin_embed_dim=12",
                   "model.backbone.swin_depths=[2,2,2,2]",
                   "model.clip_adapter.clip_model_name=test-tiny")


def _recipe_yaml(root):
    """A yaml with the recipe as ``_BASE_`` and the CLI test's tiny settings
    (the recipe's arch, decoder, queries and ``mask`` adapter kept)."""
    path = os.path.join(root, "tiny_openvis_swinL.yaml")
    body = CFG_YAML.format(d=CLI_D, root=root, train="torch_port_cli_train",
                           eval="torch_port_cli_eval")
    for line in ("  meta_architecture: SimpleBaselineOnline\n", "  num_classes: 2\n",
                 "  backbone: {name: resnet, depth: 50}\n", "    name: frame_embedding\n",
                 "    num_queries: 8\n", "    name: bg_clip\n",
                 "    clip_model_name: test-tiny\n"):
        assert line in body, line
        body = body.replace(line, "")
    body = body.replace("test: {window_inference: true, window_size: 4, topk_per_video: 5}",
                        "test: {topk_per_video: 5}")
    with open(path, "w") as f:
        f.write(f"_BASE_: {RECIPE}\n" + body)
    return path


def _stand_in_init(root, cfg):
    """A port checkpoint of the segmenter, the trunk's biases drawn N(0, 0.02),
    in the place of the recipe's Mask2Former Swin-L init (a fresh trunk's zero
    biases overflow the first step's gradient on padded frames, ROADMAP.md
    §3)."""
    seg = init_params(Segmenter(cfg.model), seed=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in seg.backbone.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    path = os.path.join(root, "swinl_init")
    save_checkpoint(path, 0, {"step": 0, "params": {f"segmenter.{n}": p for n, p
                                                    in seg.state_dict().items()}})
    return path


def test_swinl_recipe_through_the_cli(cli_root):  # noqa: F811
    """``openvis_swinL`` trains 2 steps (drop path on, 200 queries, gradients
    finite) from a stand-in for the recipe's init, its trunk moved and its
    LayerNorms fixed, then evaluates (``--eval-only``: the frozen ``mask``
    tower is built, the single shot scores the objectness)."""
    root, _ = cli_root
    path = _recipe_yaml(root)
    cfg = load_config(path, list(SWINL_OVERRIDES))
    assert (cfg.model.meta_architecture, cfg.model.backbone.swin_num_heads,
            cfg.model.backbone.swin_window_size, cfg.model.backbone.swin_drop_path_rate,
            cfg.model.transformer_decoder.num_queries, cfg.model.clip_adapter.name) == \
        ("OpenVIS", (6, 12, 24, 48), 12, 0.3, 200, "mask")
    out = os.path.join(root, "swinl")
    init = _stand_in_init(root, cfg)
    train_net_torch.main(["--config-file", path, "--device", "cpu", f"output_dir={out}",
                          "solver.max_iter=2", "solver.checkpoint_period=2", *SWINL_OVERRIDES,
                          f"model.weights={init}"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    ckpt = os.path.join(out, "checkpoints")
    start, end = load_checkpoint(init)["params"], load_checkpoint(ckpt)["params"]
    trunk = [k for k in start if k.startswith("segmenter.backbone.")]
    assert all(torch.equal(end[k], start[k]) for k in trunk if "norm" in k)
    assert not torch.equal(end["segmenter.backbone.patch_embed.weight"],
                           start["segmenter.backbone.patch_embed.weight"])
    built = []
    orig = train_net_torch.build_clip_visual

    def counting(*a, **kw):
        built.append(a[0].model.clip_adapter.name)
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch, "build_clip_visual", counting)
        train_net_torch.main(["--config-file", path, "--device", "cpu", "--eval-only",
                              "--weights", ckpt, f"output_dir={out}", *SWINL_OVERRIDES])
    assert built == ["mask"]
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
