"""PyTorch port, OpenVISOnline against the JAX package on the CPU in f32: the
proposal head's tree and parameter groups, the forward, the class-agnostic
loss and its gradients, ``openvis_ov_scores`` with a CLIP tower; what
stays unported refused; then the CLI with an OpenVISOnline yaml.

Shapes: the tiny segmenter of ``tests/test_torch_parity_e2e.py`` (64x96
frames, 2 encoder and 2 decoder layers, Q=8, hidden 64) with the proposal
head; the ``test-tiny`` CLIP (64x64 crops) in OpenAI's layout, read by both
packages from one ``.pt``.  One set of weights, the port's seeded init with
random norm affines and sampling-offset kernels, goes into both packages
(``convert.flax_from_state_dict``), so JAX's init never compiles."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models.meta import openvis as jax_openvis
from openvis_tpu.parallel.train_step import label_params as jax_label_params
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, clip_towers, train
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
)
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from openvis_tpu_torch.models.meta import openvis
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from test_torch_port_cli import CFG_YAML, cli_root  # noqa: F401  (the CLI's fixture)

K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 2, 64, 96, 64, 8, 3, 32
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
FORWARD_REL_TO_MAX = 1e-4  # the whole model, ~60 layers deep
LOSS_RTOL = 1e-5
GRAD_REL_NORM = 1e-2       # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)
# tests/test_torch_port_clip_ensemble.py's bounds
LOGIT_ATOL = 1e-4
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def openvis_cfg(cls):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=1, meta_architecture="OpenVISOnline",
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="frame_proposal", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


@pytest.fixture(scope="module")
def ov():
    """The port's OpenVIS model and the same weights as a JAX tree, with frames."""
    rng = np.random.RandomState(0)
    model = init_params(train.build_model(openvis_cfg(Config), device="cpu"), seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return model, params, frames, text


def test_proposal_tree_loads_and_groups_match_jax():
    """The JAX model's tree (shapes by ``eval_shape``) loads into the port
    strictly, back out unchanged; the groups equal JAX's ``label_params``;
    the head is drawn as flax's Dense draws it."""
    jm = jax_train.build_model(openvis_cfg(JaxConfig))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T, jnp.zeros((K, D))))["params"]
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
    model = load_flax_params(train.build_model(openvis_cfg(Config), device="cpu"), tree)
    head = "segmenter/predictor/heads/class_embed"
    assert tree["segmenter"]["predictor"]["heads"]["class_embed"]["kernel"].shape == (HID, 2)
    back = dict(_flat(flax_from_state_dict(model.state_dict())))
    assert set(back) == set(dict(_flat(tree)))
    for k, v in _flat(tree):
        assert np.array_equal(back[k], v), k
    jlabels = {"/".join(k.key for k in path): label for path, label in
               jax.tree_util.tree_flatten_with_path(jax_label_params(tree))[0]}
    plabels = label_params(model.named_parameters())
    got = {"/".join(flax_path(n, p.dim())): plabels[n] for n, p in model.named_parameters()}
    assert got == jlabels
    assert (got[f"{head}/kernel"], got[f"{head}/bias"]) == ("main", "nodecay")
    fresh = init_params(train.build_model(openvis_cfg(Config), device="cpu"), seed=3)
    lin = fresh.segmenter.predictor.heads.class_embed
    std = (1.0 / HID) ** 0.5  # lecun-normal, truncated at 2 sigma
    assert lin.weight.shape == (2, HID) and not lin.bias.any()
    assert lin.weight.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert 0.5 * std < lin.weight.std().item() < 1.5 * std


def test_openvis_forward_matches_jax(ov):
    model, params, frames, text = ov
    jm = jax_openvis.OpenVISModel(openvis_cfg(JaxConfig).model)
    ref = jax.jit(lambda p, x, txt: jm.apply({"params": p}, x, T, txt))(
        params, jnp.asarray(frames), jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(frames), T, torch.from_numpy(text))
    l = 2 + 1
    shapes = {"pred_logits_all": (l, B, T, Q, 2), "pred_masks_all": (l, B, Q, T, 16, 24),
              "pred_logits": (B, T, Q, 2), "pred_embeds": (B, T, Q, HID)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert _rel(got[k], ref[k]) <= FORWARD_REL_TO_MAX, k


def _losses(ov, labels):
    """The loss and gradients of each package from one set of weights, batch
    and points: (loss, metrics, grads) of the port, then of JAX."""
    model, params, frames, text = ov
    rng = np.random.RandomState(7)
    masks = rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]],
                                     -1).astype(np.float32)
        return table[(b, p)]

    jcfg, cfg = openvis_cfg(JaxConfig), openvis_cfg(Config)
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
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
        # the labels are zeroed: others give the same loss
        other, _ = step.loss_fn(dict(model.named_parameters()),
                                dict(tbatch, targets=dataclasses.replace(
                                    tbatch["targets"],
                                    labels=torch.full_like(tbatch["targets"].labels, K - 1))),
                                torch.Generator())
    finally:
        torch.backends.mkldnn.enabled = prev
        model.requires_grad_(True)
    assert other.item() == loss.item()
    port = (loss.item(), {k: v.item() for k, v in metrics.items()},
            dict(_flat(flax_from_state_dict(grads))))
    return port, (float(jloss), {k: float(v) for k, v in jmetrics.items()}, dict(_flat(jgrads)))


def test_openvis_loss_and_gradients_match_jax(ov):
    labels = np.random.RandomState(3).randint(0, K, (B, N))
    (loss, metrics, grads), (jloss, jmetrics, jgrads) = _losses(ov, labels)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)
    # the ResNet's frozen affines: no gradient in the port, exact zeros in JAX
    assert set(grads) < set(jgrads)
    assert all(not np.any(v) for k, v in jgrads.items() if k not in grads)
    head = "segmenter/predictor/heads/class_embed"
    assert np.any(grads[f"{head}/kernel"]) and np.any(grads[f"{head}/bias"])
    for k in grads:
        if k.endswith("k_proj/bias") or not np.any(jgrads[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(grads[k]).max() < 1e-5 and np.abs(jgrads[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(grads[k] - jgrads[k]) / np.linalg.norm(jgrads[k])
        assert err <= GRAD_REL_NORM, (k, err)


def test_openvis_ov_scores_match_jax(tmp_path):
    """The chunked crop scoring at the input resolution (7 frames in chunks
    of 3: a tail chunk), with a query valid in no frame."""
    weights = str(tmp_path / "clip_tiny.pt")
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=1, dtype=torch.float32),
               weights)
    cfgs = []
    for mod in (jax_config, port_config):
        cfg = openvis_cfg(mod.Config)
        cfgs.append(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, test=dataclasses.replace(cfg.model.test, amp=False),
            clip_adapter=dataclasses.replace(cfg.model.clip_adapter, name="clip",
                                             clip_model_name="test-tiny", weights=weights))))
    jvis, _ = jax_engine.build_clip_visual(cfgs[0])
    pvis = clip_towers.build_clip_visual(cfgs[1], "cpu")
    rng = np.random.RandomState(2)
    t, q = 7, 5
    frames = rng.rand(t, H, W, 3).astype(np.float32) * 255
    logits = rng.randn(q, t, H, W).astype(np.float32) * 2 - 1.5
    for i in range(t):
        y, x = rng.randint(0, H - 20), rng.randint(0, W - 30)
        logits[:4, i, y:y + 20, x:x + 30] += 6.0
    logits[4] = -5.0                                  # valid in no frame
    text = rng.randn(K, 32).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    kw = dict(chunk=3, input_resolution=64, sampling_ratio=2)
    scores, valid = openvis.openvis_ov_scores(pvis, torch.from_numpy(frames),
                                              torch.from_numpy(logits), torch.from_numpy(text),
                                              **kw)
    jscores, jvalid = jax.jit(lambda f, m, x: jax_openvis.openvis_ov_scores(jvis, f, m, x, **kw))(
        jnp.asarray(frames), jnp.asarray(logits), jnp.asarray(text))
    assert scores.shape == (q, K) and valid.tolist() == [True] * 4 + [False]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(scores.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_ov2seg_masqclip_and_the_unported_decoders_raise_their_items():
    """Offline OpenVIS builds over the video decoder (its parity:
    tests/test_torch_port_offline.py), and so do OV2Seg, its decoder, its
    timm ResNet and the Swin trunk (tests/test_torch_port_ov2seg*.py,
    tests/test_torch_port_swin*.py), and MasQCLIP with its MasQ tower
    (tests/test_torch_port_masqclip*.py), and the zero-shot decoders with
    their packed ``object_embed`` head (their parity:
    tests/test_torch_port_fpn.py)."""
    cfg = openvis_cfg(Config)
    offline = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="OpenVIS", transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="video_proposal")))
    assert train.build_model(offline, device="cpu").segmenter.video
    ov2seg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="ov2seg_frame")))
    for arch in ("OV2SegOnline", "OV2Seg"):
        built = train.build_model(dataclasses.replace(ov2seg, model=dataclasses.replace(
            ov2seg.model, meta_architecture=arch)), device="cpu")
        assert built.segmenter.predictor.heads.head == "ov2seg"
    masq = train.build_model(dataclasses.replace(offline, model=dataclasses.replace(
        offline.model, meta_architecture="MasQCLIP")), device="cpu")
    assert masq.segmenter.video and masq.segmenter.predictor.heads.head == "proposal"
    assert masq.clip_adapter.resblock0.attn.new_q_proj.out_features == 768  # ViT-B/16
    heads = Segmenter(ov2seg.model).predictor.heads
    clip_dim = cfg.model.transformer_decoder.clip_embed_dim
    assert heads.zs_fc2.out_features == clip_dim and heads.object_embed.out_features == 2
    hidden = cfg.model.transformer_decoder.hidden_dim
    for name, video in (("frame_zero_shot", False), ("video_zero_shot", True)):
        decoder = dataclasses.replace(cfg.model, transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name=name))
        built = Segmenter(decoder)
        heads = built.predictor.heads
        assert built.video == video and heads.head == "zero_shot"
        assert heads.object_embed.layer0.out_features == hidden
        assert heads.object_embed.layer1.out_features == 2
    for name, trunk in (("timm_resnet", "ResNet"), ("swin", "SwinTransformer")):
        backbone = dataclasses.replace(cfg.model, backbone=dataclasses.replace(
            cfg.model.backbone, name=name))
        assert type(Segmenter(backbone).backbone).__name__ == trunk


OPENVIS_YAML = CFG_YAML.replace("meta_architecture: SimpleBaselineOnline",
                                "meta_architecture: OpenVISOnline").replace(
    "num_classes: 2", "num_classes: 1").replace(
    "name: frame_embedding", "name: frame_proposal").replace(
    "name: bg_clip", "name: clip").replace(
    "    clip_ensemble: true\n    clip_ensemble_weight: 0.5\n", "")


def test_cli_trains_and_evaluates_openvis(cli_root):  # noqa: F811
    """Two steps and a checkpoint of an OpenVISOnline yaml, then ``--eval-only``
    through the tower: the predictions are the eval set's categories."""
    root, _ = cli_root
    path = os.path.join(root, "openvis.yaml")
    with open(path, "w") as f:
        f.write(OPENVIS_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                    eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_openvis")
    run = ["--config-file", path, "--device", "cpu", f"output_dir={out}"]
    train_net_torch.main(run)
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r[k]) for r in lines for k in ("total_loss", "loss_ce", "grad_norm"))
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(out, "results_torch_port_cli_eval.json")) as f:
        preds = json.load(f)
    assert preds and {p["category_id"] for p in preds} <= {1, 2}
    assert all(0.0 < p["score"] <= 1.0 for p in preds)
