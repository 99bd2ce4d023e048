"""PyTorch port, BriVIS against the JAX package on the CPU in f32: the three
temporal resamplers and their split methods, the rank-3 (1-D Conv) kernels of
``convert`` and the resampler's parameter groups, the Brownian-bridge loss,
``set_criterion`` with a fixed assignment and ``tracking_match``, the BriVIS
forward with and without the aux layers' CLIP logits, ``make_eval_fn``, the
loss and its gradients under both matcher sources, one bf16 AMP loss; then
stage 2 through the CLI from a SANOnline checkpoint.

Shapes: ``tests/test_torch_port_san.py``'s tiny SAN (64x96 frames, Q=8,
hidden 64, the tiny CLIP "TINY/8") with 2 resampler layers and T=3 frames.
One set of weights, the port's seeded init with random norm affines, goes
into both packages (``convert.flax_from_state_dict``), and each JAX reference
is one ``jax.jit``."""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.losses.brownian import brownian_bridge_loss as jax_brownian
from openvis_tpu.models import resampler as jax_resampler
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu.parallel.train_step import label_params as jax_label_params
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.checkpoint import load_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
    params_from_flax,
)
from openvis_tpu_torch.losses import criterion
from openvis_tpu_torch.losses.brownian import brownian_bridge_loss
from openvis_tpu_torch.models import resampler
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from test_torch_port_cli import cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import (
    AMP_LOSS_RTOL,
    FORWARD_REL_TO_MAX,
    GRAD_REL_NORM,
    LOSS_RTOL,
    SAN_YAML,
    TINY,
    TINY_CLIP,
    _batch,
    _flat,
    _rel,
    san_cfg,
)

K, D, B, T, H, W, HID, Q, N = 5, 32, 1, 3, 64, 96, 64, 8, 3
LAYERS = 2
RESAMPLERS = ("temporal", "decoupled", "raw")
SPLIT_REL_TO_MAX = 1e-4   # a resampler's outputs and their split, to its largest element
BROWNIAN_RTOL = 1e-5


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


def brivis_cfg(cls, name: str = "temporal", amp: bool = False):
    cfg = san_cfg(cls, amp)
    m = dataclasses.replace(cfg.model, meta_architecture="BriVIS", freeze_segmenter=True,
                            resampler=dataclasses.replace(cfg.model.resampler, name=name,
                                                          num_layers=LAYERS))
    return dataclasses.replace(cfg, model=m)


def _randomize_norms(model, rng):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or ".ln" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
    return model


# ---- the resamplers ----

def _resampler_inputs(rng, b=2, t=5, q=Q, c=HID):
    x = rng.randn(b, t, q, c).astype(np.float32)
    mf = rng.randn(b * t, 6, 8, c).astype(np.float32)
    af = rng.randn(b * t, 4, 3, 4, c).astype(np.float32)
    ms_feats = [rng.randn(b * t, hw, c).astype(np.float32) for hw in (6, 12, 24)]
    ms_pos = [rng.randn(1, hw, c).astype(np.float32) for hw in (6, 12, 24)]
    return x, mf, af, ms_feats, ms_pos


def _port_resampler(name, seed):
    kw = dict(hidden_dim=HID, feed_dim=128, nheads=4, nlayers=LAYERS, conv_kernels=(5, 3),
              nqueries=6)
    mod = init_params(resampler.build_resampler(name, **kw), seed=seed)
    return _randomize_norms(mod, np.random.RandomState(seed))


def _jax_resampler(name):
    kw = dict(hidden_dim=HID, feed_dim=128, nheads=4, nlayers=LAYERS, conv_kernels=(5, 3))
    if name == "decoupled":
        return jax_resampler.DecoupledTemporalResampler(nqueries=6, **kw)
    if name == "raw":
        return jax_resampler.RawTemporalResampler(**kw)
    return jax_resampler.TemporalResampler(**kw)


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


def test_even_conv_kernels_raise():
    with pytest.raises(ValueError, match="must be odd"):
        resampler.TemporalResampler(64, 128, 4, 1, (4, 3))


def test_rank3_kernels_round_trip_and_convolve_as_flax():
    rng = np.random.RandomState(5)
    conv = init_params(torch.nn.Conv1d(6, 4, 5), seed=5)
    tree = flax_from_state_dict(conv.state_dict())
    assert tree["kernel"].shape == (5, 6, 4)                   # flax (k, in, out)
    np.testing.assert_array_equal(tree["kernel"],
                                  conv.weight.detach().numpy().transpose(2, 1, 0))
    back = params_from_flax(tree)
    assert set(back) == {"weight", "bias"}
    assert torch.equal(back["weight"], conv.weight.detach())
    # lecun-normal over fan-in in * k, as flax draws it
    big = init_params(torch.nn.Conv1d(64, 64, 5), seed=6).weight
    assert abs(big.std().item() - (64 * 5) ** -0.5) < 0.1 * (64 * 5) ** -0.5
    x = rng.randn(3, 9, 6).astype(np.float32)                   # (N, T, C) channels-last
    ref = fnn.Conv(4, (5,), padding="VALID").apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert _rel(got, ref) <= 1e-5


def test_brivis_tree_loads_into_the_port_and_groups_match_jax():
    """The JAX model's parameter tree (shapes by ``eval_shape``) loads into the
    port strictly, for each resampler; the groups equal JAX's ``label_params``
    on the same tree; the decoupled queries draw N(0, 1)."""
    for name in RESAMPLERS:
        jcfg, cfg = brivis_cfg(JaxConfig, name), brivis_cfg(Config, name)
        jm = jax_train.build_model(jcfg)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T, jnp.zeros((K, D))))["params"]
        rng = np.random.RandomState(0)
        tree = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
        model = load_flax_params(train.build_model(cfg, device="cpu"), tree)
        jlabels = {"/".join(k.key for k in path): label for path, label in
                   jax.tree_util.tree_flatten_with_path(
                       jax_label_params(tree, ("segmenter", "clip_adapter")))[0]}
        plabels = label_params(model.named_parameters(), ("segmenter", "clip_adapter"))
        got = {"/".join(flax_path(n, p.dim())): plabels[n] for n, p in model.named_parameters()}
        assert got == jlabels, name
        res = {k: v for k, v in got.items() if k.startswith("resampler/")}
        assert res["resampler/short0_conv1/kernel"] == "main"
        assert res["resampler/short0_conv1/bias"] == "nodecay"
        assert not any(v == "frozen" for v in res.values())
        assert all(v == "frozen" for k, v in got.items()
                   if k.startswith(("segmenter/", "clip_adapter/")))
        if name == "decoupled":
            q = init_params(train.build_model(cfg, device="cpu"), seed=1).resampler.query_emb
            assert abs(q.std().item() - 1.0) < 0.2 and res["resampler/query_emb"] == "main"


# ---- the losses ----

@pytest.mark.parametrize("neg_log", [True, False], ids=["neg_log", "ratio"])
def test_brownian_bridge_loss_matches_jax(neg_log):
    rng = np.random.RandomState(6)
    b, t, q, c = 2, 6, 5, 16
    e = rng.randn(b, t, q, c).astype(np.float32)
    key = jax.random.PRNGKey(6)
    mid = np.asarray(jax.random.randint(key, (b * q,), 1, t - 1))
    assert len(set(mid.tolist())) > 1

    def jfn(x):
        bc, htm = jax_brownian(key, x, neg_log=neg_log)
        return bc + 2.0 * htm, (bc, htm)

    (_, (jbc, jhtm)), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    bc, htm = brownian_bridge_loss(torch.Generator(), x, neg_log=neg_log,
                                   draw_mid=lambda g, n, tt: torch.from_numpy(mid).long())
    grad, = torch.autograd.grad(bc + 2.0 * htm, x)
    np.testing.assert_allclose(bc.item(), float(jbc), rtol=BROWNIAN_RTOL)
    np.testing.assert_allclose(htm.item(), float(jhtm), rtol=BROWNIAN_RTOL)
    assert _rel(grad, jgrad) <= 1e-5


def _criterion_inputs(rng, t=3, q=6, h=8, w=12):
    logits = rng.randn(B + 1, t, q, K + 1).astype(np.float32)
    masks = rng.randn(B + 1, q, t, h, w).astype(np.float32)
    labels = rng.randint(0, K, (B + 1, N))
    tmasks = rng.rand(B + 1, N, t, 2 * h, 2 * w) > 0.6
    valid = np.array([[True, True, False], [True, True, True]])
    fv = rng.rand(B + 1, N, t) > 0.4
    fv[:, :, -1] = True
    return logits, masks, labels, tmasks, valid, fv


def _settings(mod):
    return mod.CriterionSettings(num_classes=K, num_points=24)


def test_set_criterion_fixed_assignment_and_tracking_match_match_jax():
    rng = np.random.RandomState(7)
    logits, masks, labels, tmasks, valid, fv = _criterion_inputs(rng)
    _, _, _, draw = _batch(np.random.RandomState(8))
    jt = JaxTargets(labels=jnp.asarray(labels, jnp.int32), masks=jnp.asarray(tmasks),
                    valid=jnp.asarray(valid), frame_valid=jnp.asarray(fv))
    pt = ClipTargets(torch.from_numpy(labels), torch.from_numpy(tmasks),
                     torch.from_numpy(valid), torch.from_numpy(fv))
    fixed = np.array([[3, 0, 5], [1, 4, 2]])
    lg_all = np.stack([logits.mean(1), logits[:, 0]])             # (2, B, Q, K+1)
    mk_all = np.stack([masks, masks[:, ::-1]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))

        @jax.jit
        def ref(lg, mk, lg_t, mk_t):
            losses, _ = jcrit.set_criterion(jax.random.PRNGKey(0), lg, mk, jt, _settings(jcrit),
                                            fixed_assignment=jnp.asarray(fixed, jnp.int32))
            return losses, jcrit.tracking_match(jax.random.PRNGKey(1), lg_t, mk_t, jt,
                                                _settings(jcrit))

        jlosses, jtrack = ref(jnp.asarray(lg_all), jnp.asarray(mk_all), jnp.asarray(logits),
                              jnp.asarray(masks))
    pdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
    solved = []
    orig = criterion.batched_hungarian

    def counting(cost):
        solved.append(cost.shape)
        return orig(cost)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(criterion, "batched_hungarian", counting)
        losses, last = criterion.set_criterion(
            torch.Generator(), torch.from_numpy(lg_all), torch.from_numpy(mk_all.copy()), pt,
            _settings(criterion), pdraw, fixed_assignment=torch.from_numpy(fixed))
        assert not solved  # no matching with an assignment given
        track = criterion.tracking_match(torch.Generator(), torch.from_numpy(logits),
                                         torch.from_numpy(masks), pt, _settings(criterion),
                                         pdraw)
    assert solved == [(B + 1, N, 6)] * T  # one Hungarian call a frame
    assert torch.equal(last, torch.from_numpy(fixed))
    for k in ("loss_ce", "loss_mask", "loss_dice", "total"):
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_array_equal(track.numpy()[valid], np.asarray(jtrack)[valid])
    # distinct queries per clip, each slot on a query free in its first frame
    for row, v in zip(track.numpy(), valid):
        assert len(set(row[v].tolist())) == v.sum()


# ---- the model ----

@pytest.fixture(scope="module")
def brivis():
    """The port's BriVIS (temporal) and the same weights as a JAX tree, with
    frames and text."""
    rng = np.random.RandomState(0)
    model = init_params(train.build_model(brivis_cfg(Config), device="cpu"), seed=0)
    _randomize_norms(model, rng)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return model, params, frames, text


@pytest.mark.parametrize("aux", [True, False], ids=["aux_logits", "last_layer_only"])
def test_brivis_forward_and_eval_fn_match_jax(brivis, aux):
    model, params, frames, text = brivis
    cfg = brivis_cfg(JaxConfig)
    jm = jax_train.build_model(cfg).clone(supervise_aux_logits=aux)
    jeval = jax_train.make_eval_fn(cfg, jm) if aux else (lambda p, x, txt: None)
    ref, ref_eval = jax.jit(lambda p, x, txt: (jm.apply({"params": p}, x, T, txt),
                                               jeval(p, x, txt)))(
        params, jnp.asarray(frames), jnp.asarray(text))
    model.supervise_aux_logits = aux
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(frames), T, torch.from_numpy(text))
    finally:
        model.supervise_aux_logits = True
    l1 = LAYERS + 1
    shapes = {"pred_logits_all": (l1, B, T, Q, K + 1), "pred_masks_all": (l1, B, Q, T, 16, 24),
              "pred_embeds": (B, T, Q, HID), "brownian_embeds": (B, T, Q, HID)}
    if aux:
        shapes.update(image_logits=(B, T, Q, K + 1), image_masks=(B, Q, T, 16, 24))
    else:
        assert "image_logits" not in got  # the loss's only
        assert torch.equal(got["pred_logits_all"][0], got["pred_logits_all"][-1])
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert _rel(got[k], ref[k]) <= FORWARD_REL_TO_MAX, k
    if not aux:
        return
    out = train.make_eval_fn(brivis_cfg(Config), model)(torch.from_numpy(frames),
                                                         torch.from_numpy(text))
    assert model.supervise_aux_logits  # make_eval_fn ran a copy
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref_eval["scores"]), atol=1e-5)
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref_eval["labels"]))
    assert _rel(out["mask_logits"], ref_eval["mask_logits"]) <= FORWARD_REL_TO_MAX


def _losses(brivis, amp: bool, image_matcher: bool):
    """The loss, metrics and gradients of each package from one set of weights,
    batch and points (JAX's gradients are not computed under AMP)."""
    model, params, frames, text = brivis
    labels, masks, valid, draw = _batch(np.random.RandomState(7))
    masks = np.random.RandomState(9).rand(B, N, T, H, W) > 0.7
    jcfg, cfg = brivis_cfg(JaxConfig, amp=amp), brivis_cfg(Config, amp=amp)
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
        jloss_fn = jax_train.make_loss_fn(jcfg, jax_train.build_model(jcfg), K,
                                          brivis_image_matcher=image_matcher)
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
        pdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
        step = train.build_train_step(cfg, model, K, device="cpu", draw_points=pdraw)
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        # the frozen stage 1: no AdamW state, so no update and no share of the clip norm
        assert set(step.state.opt.mu) == set(named)
        loss_fn = train.make_loss_fn(cfg, model, K, pdraw, brivis_image_matcher=image_matcher)
        loss, metrics = loss_fn(dict(model.named_parameters()), tbatch, torch.Generator())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    finally:
        torch.backends.mkldnn.enabled = prev
        model.requires_grad_(True)
    port = (loss.item(), {k: v.item() for k, v in metrics.items()},
            dict(_flat(flax_from_state_dict(grads))))
    return port, (float(jloss), {k: float(v) for k, v in jmetrics.items()}, dict(_flat(jgrads)))


@pytest.mark.parametrize("image_matcher", [True, False], ids=["image_matcher", "resampler"])
def test_brivis_loss_and_gradients_match_jax(brivis, image_matcher):
    (loss, metrics, grads), (jloss, jmetrics, jgrads) = _losses(brivis, False, image_matcher)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert {"bc_loss", "htm_loss"} < set(metrics) and metrics["bc_loss"] > 0
    for k in ("loss_ce", "loss_mask", "loss_dice"):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)
    # the JAX loss's total less its three metrics' weighted sum: bc + htm
    c = brivis_cfg(Config).model.criterion
    jbrown = jloss - (c.class_weight * jmetrics["loss_ce"] + c.mask_weight * jmetrics["loss_mask"]
                      + c.dice_weight * jmetrics["loss_dice"])
    np.testing.assert_allclose(metrics["bc_loss"] + metrics["htm_loss"], jbrown, rtol=1e-4)
    # the frozen stage 1: no gradient in the port, exact zeros in JAX
    assert all(k.startswith(("resampler/", "brownian_proj/")) for k in grads)
    assert set(grads) < set(jgrads)
    assert all(not np.any(v) for k, v in jgrads.items() if k not in grads)
    for k in ("resampler/short0_conv1/kernel", "resampler/long1/q_proj/kernel",
              "resampler/attn_embed/layer0/kernel", "resampler/mask_embed/layer2/kernel",
              "brownian_proj/kernel"):
        assert np.any(grads[k]), k
    for k, g in grads.items():
        if k.endswith("k_proj/bias") or not np.any(jgrads[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(g).max() < 1e-5 and np.abs(jgrads[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(g - jgrads[k]) / np.linalg.norm(jgrads[k])
        assert err <= GRAD_REL_NORM, (k, err)


def test_brivis_amp_loss_within_bf16_bound_of_jax(brivis):
    (loss, metrics, grads), (jloss, jmetrics, _) = _losses(brivis, True, True)
    assert all(v.dtype == np.float32 for v in grads.values())  # f32 masters
    assert np.isfinite(loss) and abs(loss - jloss) <= AMP_LOSS_RTOL * abs(jloss)
    for k in jmetrics:
        assert abs(metrics[k] - jmetrics[k]) <= AMP_LOSS_RTOL * abs(jmetrics[k]), k


# ---- stage 2 through the CLI ----

BRIVIS_YAML = SAN_YAML.replace("meta_architecture: SANOnline", "meta_architecture: BriVIS\n"
                               "  freeze_segmenter: true\n"
                               "  resampler: {{name: temporal, num_layers: 2}}")


def test_cli_stage2_from_a_san_checkpoint(cli_root):  # noqa: F811
    """SANOnline trains a step and saves; BriVIS grafts its segmenter and
    clip_adapter, trains 2 steps across the matcher switch and evaluates;
    the grafted subtrees stay the SAN checkpoint's bit for bit."""
    root, _ = cli_root
    paths = {}
    for name, text in (("san", SAN_YAML), ("brivis", BRIVIS_YAML)):
        paths[name] = os.path.join(root, f"stage_{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(text.format(d=D, root=root, train="torch_port_cli_train",
                                eval="torch_port_cli_eval"))
    san_out, out = os.path.join(root, "stage1"), os.path.join(root, "stage2")
    san_ckpt = os.path.join(san_out, "checkpoints")
    train_net_torch.main(["--config-file", paths["san"], "--device", "cpu",
                          f"output_dir={san_out}", "solver.max_iter=1"])
    switched = []
    use = train_net_torch.use_brivis_matcher

    def recording(step, cfg, num_text_classes, image_matcher):
        switched.append((step.state.step, image_matcher))
        use(step, cfg, num_text_classes, image_matcher)

    run = ["--config-file", paths["brivis"], "--device", "cpu", f"output_dir={out}",
           f"model.weights={san_ckpt}", "solver.max_iter=2", "input.sampling_frame_num=3"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch, "use_brivis_matcher", recording)
        train_net_torch.main(run)
    assert switched == [(1, False)]  # at half of max_iter
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    san, brivis = (load_checkpoint(d)["params"] for d in (san_ckpt, os.path.join(out,
                                                                                  "checkpoints")))
    grafted = [k for k in brivis if k.startswith(("segmenter.", "clip_adapter."))]
    assert grafted and set(grafted) == set(san)
    for k in grafted:
        assert torch.equal(brivis[k], san[k]), k
    fresh = init_params(train.build_model(load_config(paths["brivis"]), device="cpu"), seed=0)
    moved = [k for k, v in fresh.state_dict().items() if k.startswith("resampler.")
             and not torch.equal(v, brivis[k])]
    assert moved
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r[k]) for r in lines for k in ("total_loss", "bc_loss", "htm_loss"))
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())


def test_cli_refuses_the_recipes_flax_weights(cli_root):  # noqa: F811
    root, _ = cli_root
    path = os.path.join(root, "stage_msgpack.yaml")
    with open(path, "w") as f:
        f.write(BRIVIS_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                   eval="torch_port_cli_eval"))
    with pytest.raises(SystemExit, match="msgpack"):
        train_net_torch.main(["--config-file", path, "--device", "cpu",
                              f"output_dir={os.path.join(root, 'never')}",
                              "model.weights=work_dirs/san/model_final.msgpack"])
