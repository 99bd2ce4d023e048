"""PyTorch port, SANOnline against the JAX package on the CPU in f32: the CLIP
attention with a dense bias and in the sos-split form, the adaptive max pool,
the side adapter's front and post encodes, the SAN forward with and without
the aux layers' CLIP logits, the loss and its gradients (the frozen CLIP
tower getting none) and one bf16 AMP forward; then the CLI with a SAN yaml.

Shapes: the tiny CLIP of ``tests/test_torch_parity_e2e_san.py`` ("TINY/8",
4 blocks split at 3, taps 1..3; set into both packages' shape tables) and
the tiny segmenter of ``tests/test_torch_parity_e2e.py`` (64x96 frames, 2
encoder and 2 decoder layers, Q=8, hidden 64).  One set of weights, the
port's seeded init with random norm affines and sampling-offset kernels,
goes into both packages (``convert.flax_from_state_dict``), so JAX's init
never compiles."""

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
from openvis_tpu.models import side_adapter as jax_sa
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu.models.meta.san import SANModel as JaxSAN
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.checkpoint import load_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, params_from_flax
from openvis_tpu_torch.models import side_adapter
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.weights import convert_clip
from test_torch_port_cli import CFG_YAML, cli_root  # noqa: F401  (the CLI's fixture)

K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 2, 64, 96, 64, 8, 3, 32
TINY = "TINY/8"
TINY_CLIP = dict(embed_dim=32, vision_patch=8, vision_width=64, vision_layers=4,
                 vision_heads=4, image_size=32, text_width=32, text_heads=4, text_layers=2)
BROKEN, MERGE = 3, (1, 2, 3)
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
REL_TO_MAX = 1e-5          # a module's output, relative to its largest element
FORWARD_REL_TO_MAX = 1e-4  # the whole model, ~60 layers deep
LOSS_RTOL = 1e-5
GRAD_REL_NORM = 1e-2       # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)
AMP_LOSS_RTOL = 3e-2       # tests/test_torch_port_train_amp.py's bf16 bound


@pytest.fixture(scope="module", autouse=True)
def tiny_clip():
    """One intra-op thread (the test workers share the machine's cores) and
    the tiny CLIP shape in both packages' tables."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip._MODEL_SHAPES, TINY, TINY_CLIP)
        mp.setitem(clip_model._MODEL_SHAPES, TINY, TINY_CLIP)
        yield
    torch.set_num_threads(threads)


def san_cfg(cls, amp: bool = False):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K, meta_architecture="SANOnline",
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="side_adapter_frame", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID,
            clip_embed_dim=D),
        clip_adapter=dataclasses.replace(
            cfg.model.clip_adapter, name="side", clip_model_name=TINY,
            clip_num_heads=TINY_CLIP["vision_heads"], merge_ids=MERGE, broken_id=BROKEN),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=amp))


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
def san():
    """The port's SAN model and the same weights as a JAX tree, with a batch."""
    rng = np.random.RandomState(0)
    model = init_params(train.build_model(san_cfg(Config), device="cpu"), seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or ".ln" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return model, params, frames, text, rng


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
    ref = jax_clip.CLIPAttention(c, heads).apply({"params": tree}, jnp.asarray(x),
                                                 attn_bias=jnp.asarray(bias), **kw)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), attn_bias=torch.from_numpy(bias), **kw)
    assert _rel(got, ref) <= REL_TO_MAX


@pytest.mark.parametrize("src", [(30, 54), (31, 45), (14, 14)], ids=["train", "odd", "same"])
def test_adaptive_max_pool_matches_jax(src):
    """Exact: both take the maximum of the same window."""
    x = np.random.RandomState(2).randn(2, 3, 5, *src).astype(np.float32)
    ref = np.asarray(jax_sa.adaptive_max_pool(jnp.asarray(x), (14, 14)))
    got = side_adapter.adaptive_max_pool(torch.from_numpy(x), (14, 14)).numpy()
    assert got.shape == (2, 3, 5, 14, 14)
    np.testing.assert_array_equal(got, ref)


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


@pytest.mark.parametrize("aux", [True, False], ids=["aux_logits", "last_layer_only"])
def test_san_forward_matches_jax(san, aux):
    model, params, frames, text, _ = san
    cfg = san_cfg(JaxConfig)
    jm = JaxSAN(cfg.model, supervise_aux_logits=aux)
    ref = jax.jit(lambda p, x, txt: jm.apply({"params": p}, x, T, txt))(
        params, jnp.asarray(frames), jnp.asarray(text))
    model.supervise_aux_logits = aux
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(frames), T, torch.from_numpy(text))
    finally:
        model.supervise_aux_logits = True
    l = 2 + 1
    shapes = {"pred_logits_all": (l, B, T, Q, K + 1), "pred_masks_all": (l, B, Q, T, 16, 24),
              "class_attn_biases_all": (l, B, T, 4, Q, 4, 6), "pred_embeds": (B, T, Q, HID),
              "attn_feats": (B * T, 4, 4, 6, HID)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert _rel(got[k], ref[k]) <= FORWARD_REL_TO_MAX, k
    if not aux:  # the last layer's logits, broadcast
        assert torch.equal(got["pred_logits_all"][0], got["pred_logits_all"][-1])


def _batch(rng):
    labels, masks = rng.randint(0, K, (B, N)), rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]],
                                     -1).astype(np.float32)
        return table[(b, p)]

    return labels, masks, valid, draw


def _losses(san, amp: bool):
    """The loss and gradients of each package from one set of weights, batch
    and points: ((loss, metrics, grads) of the port, the same of JAX; JAX's
    gradients under AMP are not computed)."""
    model, params, frames, text, rng = san
    labels, masks, valid, draw = _batch(np.random.RandomState(7))
    jcfg, cfg = san_cfg(JaxConfig, amp), san_cfg(Config, amp)
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
        if amp:
            (jloss, jmetrics), jgrads = jax.jit(fn)(params), {}
        else:
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
    port = (loss.item(), {k: v.item() for k, v in metrics.items()},
            dict(_flat(flax_from_state_dict(grads))))
    return port, (float(jloss), {k: float(v) for k, v in jmetrics.items()}, dict(_flat(jgrads)))


def test_san_loss_and_gradients_match_jax(san):
    (loss, metrics, grads), (jloss, jmetrics, jgrads) = _losses(san, amp=False)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)
    # the frozen tower (and the ResNet's frozen affines): no gradient in the
    # port, exact zeros in JAX
    assert not [k for k in grads if k.startswith("clip_adapter/visual/")]
    assert set(grads) < set(jgrads)
    assert all(not np.any(v) for k, v in jgrads.items() if k not in grads)
    assert any(k.startswith("clip_adapter/visual/") for k in jgrads)
    trained = list(grads)
    for k in ("clip_adapter/bg_embed", "clip_adapter/attn_proj0/kernel",
              "clip_adapter/attn_proj2/kernel", "clip_adapter/logit_scale",
              "segmenter/predictor/heads/attn_embed/layer0/kernel",
              "segmenter/predictor/attn_mlp2/kernel"):
        assert np.any(grads[k]), k
    for k in trained:
        if k.endswith("k_proj/bias") or not np.any(jgrads[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(grads[k]).max() < 1e-5 and np.abs(jgrads[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(grads[k] - jgrads[k]) / np.linalg.norm(jgrads[k])
        assert err <= GRAD_REL_NORM, (k, err)


def test_san_amp_loss_within_bf16_bound_of_jax(san):
    (loss, metrics, grads), (jloss, jmetrics, _) = _losses(san, amp=True)
    assert all(v.dtype == np.float32 for v in grads.values())  # f32 masters
    assert np.isfinite(loss) and abs(loss - jloss) <= AMP_LOSS_RTOL * abs(jloss)
    for k in jmetrics:
        assert abs(metrics[k] - jmetrics[k]) <= AMP_LOSS_RTOL * abs(jmetrics[k]), k


def test_offline_san_raises_its_roadmap_item():
    """Offline SAN builds over the video decoder and evaluates (its parity:
    tests/test_torch_port_offline.py); its train step raises, naming the
    JAX package's failing criterion and ROADMAP.md §3; Swin raises naming
    item 8.6."""
    cfg = san_cfg(Config)
    offline = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="SAN", transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="side_adapter_video")))
    model = train.build_model(offline, device="cpu")
    assert model.segmenter.video
    with pytest.raises(NotImplementedError, match=r"criterion\.py:290.*ROADMAP\.md §3"):
        train.build_train_step(offline, model, K, device="cpu")
    swin = dataclasses.replace(offline.model, backbone=dataclasses.replace(
        offline.model.backbone, name="swin"))
    with pytest.raises(NotImplementedError, match="queue 1 item 8.6"):
        Segmenter(swin)


SAN_YAML = CFG_YAML.replace("meta_architecture: SimpleBaselineOnline",
                            "meta_architecture: SANOnline").replace(
    "name: frame_embedding", "name: side_adapter_frame").replace(
    "name: bg_clip", "name: side\n    clip_num_heads: 4\n    merge_ids: [1, 2, 3]\n"
                     "    broken_id: 3")


def test_cli_trains_and_evaluates_san(cli_root):  # noqa: F811
    """One step and an eval of a SAN yaml; the tower's state is the CLIP
    checkpoint's, converted, and it stays so."""
    root, _ = cli_root
    path = os.path.join(root, "san.yaml")
    with open(path, "w") as f:
        f.write(SAN_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_san")
    loaded = {}
    load = train_net_torch.load_clip_visual

    def recording(model, tree):
        load(model, tree)
        loaded.update({k: v.clone() for k, v in model.clip_adapter.visual.state_dict().items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch, "load_clip_visual", recording)
        run = ["--config-file", path, "--device", "cpu", f"output_dir={out}",
               "solver.max_iter=1", "solver.checkpoint_period=1"]
        train_net_torch.main(run)
        train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    cfg = load_config(path)
    want = params_from_flax(convert_clip({k: v.numpy() for k, v in torch.load(
        cfg.model.clip_adapter.weights).items()})["visual"])
    assert set(loaded) == set(want)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    params = load_checkpoint(os.path.join(out, "checkpoints"))["params"]
    for k, v in want.items():
        assert torch.equal(params[f"clip_adapter.visual.{k}"], v), k
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert np.isfinite(json.loads(f.readline())["total_loss"])
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
