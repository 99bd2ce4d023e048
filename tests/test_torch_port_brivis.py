"""PyTorch port, BriVIS against the JAX package on the CPU in f32: the BriVIS
forward with and without the aux layers' CLIP logits, ``make_eval_fn``, the
loss and its gradients under both matcher sources; and the shapes, weights
and helpers of the BriVIS tests split off so that no file holds more than 4
(``test_torch_port_brivis_resampler.py``: the three resamplers and their
split; ``_parts.py``: the rank-3 kernels of ``convert``, the groups,
``set_criterion`` with a fixed assignment and ``tracking_match``;
``_bridge.py``: the Brownian-bridge loss and one bf16 AMP loss; ``_cli.py``:
stage 2 through the CLI from a SANOnline checkpoint).

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


# ---- the losses ----


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


# ---- stage 2 through the CLI ----

BRIVIS_YAML = SAN_YAML.replace("meta_architecture: SANOnline", "meta_architecture: BriVIS\n"
                               "  freeze_segmenter: true\n"
                               "  resampler: {{name: temporal, num_layers: 2}}")
