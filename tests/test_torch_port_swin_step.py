"""PyTorch port, the Swin trunk under SAN: a SANOnline train step with a
tiny Swin trunk against the JAX package on the CPU in f32 (loss and
gradients; drop path 0, as the JAX reference draws its own stream), then the
three Swin-B recipes through the CLI at tiny shapes: ``san_online_SwinB``
trains and evaluates, ``san_SwinB`` evaluates (``--eval-only``) on that run's
checkpoint, ``brivis_SwinB`` runs stage 2 from it.

Shapes: ``tests/test_torch_port_san.py``'s SAN (the tiny CLIP "TINY/8",
64x96 frames, 2 encoder and 2 decoder layers, Q=8, hidden 64) over a Swin of
width 16, depths (2, 2, 2, 2), heads (2, 2, 4, 4), windows of 3; the CLI at
``tests/test_torch_port_cli.py``'s shapes with the test-tiny CLIP.  The JAX
Swin runs under ``jax.jit`` with the port's shift mask
(``torch_port_common.jit_safe_jax_swin``)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.structures import ClipTargets
from test_torch_port_cli import D as CLI_D, cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import (  # noqa: F401  (tiny_clip: the tiny CLIP's shape, autouse)
    B,
    GRAD_REL_NORM,
    H,
    K,
    LOSS_RTOL,
    N,
    SAN_YAML,
    T,
    W,
    D,
    san_cfg,
    tiny_clip,
)
from torch_port_common import flat, jit_safe_jax_swin, point_table, seeded_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_DIR = os.path.join(REPO, "configs", "openvoc_ytvis_coco", "swin")
TINY_SWIN = dict(swin_embed_dim=16, swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 2, 4, 4),
                 swin_window_size=3, swin_drop_path_rate=0.0)


def swin_san_cfg(cls):
    cfg = san_cfg(cls)
    backbone = dataclasses.replace(cfg.model.backbone, name="swin", **TINY_SWIN)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=backbone))


def test_san_swin_train_step_matches_jax():
    """The loss, its terms and every trainable gradient of one f32 step."""
    rng = np.random.RandomState(0)
    model, tree = seeded_model(swin_san_cfg(Config), 0, rng)
    params = jax.tree.map(jnp.asarray, tree)
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    labels, masks = rng.randint(0, K, (B, N)), rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    draw = point_table(rng)
    jcfg, cfg = swin_san_cfg(JaxConfig), swin_san_cfg(Config)
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        jit_safe_jax_swin(mp)
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
        jloss_fn = jax_train.make_loss_fn(jcfg, jax_train.build_model(jcfg), K)
        fn = lambda p: jloss_fn(p, jbatch, jax.random.PRNGKey(1))  # noqa: E731
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
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
        model.requires_grad_(True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    pgrads, jg = dict(flat(flax_from_state_dict(grads))), dict(flat(jgrads))
    # the trunk's LayerNorms are frozen (JAX's FrozenAffine rule): no gradient
    # in the port, exact zeros in JAX
    assert "segmenter/backbone/stage0_block0/norm1/scale" not in pgrads
    assert not np.any(jg["segmenter/backbone/stage0_block0/norm1/scale"])
    for part in ("stage3_block1/attn/relative_position_bias_table", "patch_embed/kernel",
                 "downsample2/reduction/kernel"):
        assert np.any(pgrads[f"segmenter/backbone/{part}"]), part
    for k, g in pgrads.items():
        if k.endswith("k_proj/bias") or not np.any(jg[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(g).max() < 1e-5 and np.abs(jg[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(g - jg[k]) / np.linalg.norm(jg[k])
        assert err <= GRAD_REL_NORM, (k, err)


# the recipes' Swin-B cut to the tests' width, its 0.3 drop path kept; the
# recipes' m2f_swinB.msgpack is not in the repository (training starts from
# _stand_in_init)
SWIN_OVERRIDES = ("model.weights=", "model.backbone.swin_embed_dim=16",
                  "model.backbone.swin_depths=[2,2,2,2]", "model.backbone.swin_num_heads=[2,2,4,4]",
                  "model.backbone.swin_window_size=3")


def _recipe_yaml(root, recipe):
    """A yaml with the recipe as ``_BASE_`` and the CLI test's tiny settings."""
    path = os.path.join(root, f"tiny_{recipe}")
    with open(path, "w") as f:
        f.write(f"_BASE_: {os.path.join(SWIN_DIR, recipe)}\n" + SAN_YAML.format(
            d=CLI_D, root=root, train="torch_port_cli_train", eval="torch_port_cli_eval")
            .replace("  meta_architecture: SANOnline\n", "").replace(
                "  backbone: {name: resnet, depth: 50}\n", "").replace(
                "    name: side_adapter_frame\n", ""))
    return path


def _stand_in_init(root, cfg):
    """A port checkpoint of the segmenter, the trunk's biases drawn N(0, 0.02),
    in the place of the recipe's Mask2Former Swin-B init.  With the zero
    biases of a fresh init, a window of padded (zero) pixels stays zero
    through the trunk and each LayerNorm's backward scales its gradient by
    1/sqrt(eps): the step's gradient norm overflows, the JAX package's too."""
    seg = init_params(Segmenter(cfg.model), seed=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in seg.backbone.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    path = os.path.join(root, "swin_init")
    save_checkpoint(path, 0, {"step": 0, "params": {f"segmenter.{n}": p for n, p
                                                    in seg.state_dict().items()}})
    return path


def test_swin_recipes_through_the_cli(cli_root):  # noqa: F811
    """``san_online_SwinB`` trains a step (drop path on; its gradient finite)
    from a stand-in for the recipe's pretrained init and evaluates;
    ``san_SwinB`` evaluates its checkpoint; ``brivis_SwinB`` grafts it for
    stage 2, trains a step and evaluates, its segmenter the checkpoint's bit
    for bit."""
    root, _ = cli_root
    online = _recipe_yaml(root, "san_online_SwinB_bs16_6000st_ViT-L-336.yaml")
    offline = _recipe_yaml(root, "san_SwinB_bs16_6000st_ViT-L-336.yaml")
    brivis = _recipe_yaml(root, "brivis_SwinB_bs16_6000st_ViT-L-336.yaml")
    cfg = load_config(online, list(SWIN_OVERRIDES))
    assert (cfg.model.meta_architecture, cfg.model.backbone.name) == ("SANOnline", "swin")
    assert cfg.model.backbone.swin_drop_path_rate == 0.3
    assert load_config(offline, list(SWIN_OVERRIDES)).model.transformer_decoder.name == \
        "side_adapter_video"
    s1 = os.path.join(root, "swin_stage1")
    ckpt = os.path.join(s1, "checkpoints")
    train_net_torch.main(["--config-file", online, "--device", "cpu", f"output_dir={s1}",
                          "solver.max_iter=1", "solver.checkpoint_period=1", *SWIN_OVERRIDES,
                          f"model.weights={_stand_in_init(root, cfg)}"])
    with open(os.path.join(s1, "metrics.jsonl")) as f:
        first = json.loads(f.readline())
    assert np.isfinite(first["total_loss"]) and np.isfinite(first["grad_norm"]), first
    for path, out in ((online, s1), (offline, os.path.join(root, "swin_offline"))):
        train_net_torch.main(["--config-file", path, "--device", "cpu", "--eval-only",
                              "--weights", ckpt, f"output_dir={out}", *SWIN_OVERRIDES])
        with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
            metrics = json.load(f)
        assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    s2 = os.path.join(root, "swin_stage2")
    train_net_torch.main(["--config-file", brivis, "--device", "cpu", f"output_dir={s2}",
                          "solver.max_iter=1", "solver.checkpoint_period=1", *SWIN_OVERRIDES,
                          "model.resampler.num_layers=2", "input.sampling_frame_num=3",
                          f"model.weights={ckpt}"])
    train_net_torch.main(["--config-file", brivis, "--device", "cpu", "--eval-only", "--weights",
                          os.path.join(s2, "checkpoints"), f"output_dir={s2}", *SWIN_OVERRIDES,
                          "model.resampler.num_layers=2"])
    with open(os.path.join(s2, "metrics_torch_port_cli_eval.json")) as f:
        assert all(np.isfinite(v) for v in json.load(f).values())
    stage1 = load_checkpoint(ckpt)["params"]
    stage2 = load_checkpoint(os.path.join(s2, "checkpoints"))["params"]
    seg = [k for k in stage1 if k.startswith("segmenter.backbone.")]
    assert seg and all(torch.equal(stage2[k], stage1[k]) for k in seg)
    assert any(k.startswith("resampler.") for k in stage2)
