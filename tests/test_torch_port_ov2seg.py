"""PyTorch port, OV2Seg against the JAX package on the CPU in f32: the
``ov2seg`` head's tree and parameter groups and the forward, the loss
(fused-probability matching, CE, objectness CE, point mask losses) and its
gradients, the eval scores and the frame gate, and the EMA tracker (T = 13,
T = 1 and a tied frame).

Shapes: the tiny segmenter of ``tests/test_torch_parity_e2e.py`` (64x96
frames, 2 encoder and 2 decoder layers, Q=8, hidden 64) with the ``ov2seg``
head (D = 32).  One set of weights, the port's seeded init with random norm
affines and sampling-offset kernels, goes into both packages, so JAX's init
never compiles; each JAX reference is one ``jax.jit``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.models.meta.ov2seg as jax_ov2seg
import openvis_tpu.train as jax_train
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models import tracking as jax_tracking
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import flax_from_state_dict, flax_path, load_flax_params
from openvis_tpu_torch.models import tracking
from openvis_tpu_torch.models.meta import ov2seg
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from torch_port_common import flat, jax_labels, one_thread_fixture, point_table, rel, seeded_model

K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 2, 64, 96, 64, 8, 3, 32
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
FORWARD_REL_TO_MAX = 1e-4  # the whole model, ~60 layers deep
SCORE_ATOL = 1e-6          # a few elementwise operations
LOSS_RTOL = 1e-5
GRAD_REL_NORM = 1e-2       # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)

one_thread = one_thread_fixture()


def ov2seg_cfg(cls):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K, meta_architecture="OV2SegOnline",
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="ov2seg_frame", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID,
            clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


@pytest.fixture(scope="module")
def ov2():
    """The port's OV2Seg model and the same weights as a JAX tree, with frames and text."""
    rng = np.random.RandomState(0)
    model, tree = seeded_model(ov2seg_cfg(Config), 0, rng)
    params = jax.tree.map(jnp.asarray, tree)
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return model, params, frames, text


def test_ov2seg_tree_groups_and_forward_match_jax(ov2):
    """JAX's tree (shapes by ``eval_shape``) loads into the port strictly and
    back unchanged, the heads' groups equal JAX's ``label_params``, and the
    forward's outputs equal JAX's."""
    jm = jax_train.build_model(ov2seg_cfg(JaxConfig))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T, jnp.zeros((K, D))))["params"]
    rng = np.random.RandomState(1)
    tree = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
    loaded = load_flax_params(train.build_model(ov2seg_cfg(Config), device="cpu"), tree)
    heads = tree["segmenter"]["predictor"]["heads"]
    assert heads["zs_fc1"]["kernel"].shape == (HID, D // 2)
    assert heads["zs_fc2"]["kernel"].shape == (D // 2, D)
    assert heads["object_embed"]["kernel"].shape == (HID, 2)
    back = dict(flat(flax_from_state_dict(loaded.state_dict())))
    assert back.keys() == dict(flat(tree)).keys()
    assert all(np.array_equal(back[k], v) for k, v in flat(tree))
    groups = label_params(loaded.named_parameters())
    pl = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in loaded.named_parameters()}
    assert pl == jax_labels(tree)
    assert pl["segmenter/predictor/heads/zs_fc1/kernel"] == "main"
    assert pl["segmenter/predictor/heads/object_embed/bias"] == "nodecay"

    model, params, frames, text = ov2
    ref = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, T, t))(
        params, jnp.asarray(frames), jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(frames), T, torch.from_numpy(text))
    l = 2 + 1
    shapes = {"pred_logits_all": (l, B, T, Q, K + 1), "pred_object_logits_all": (l, B, T, Q, 2),
              "pred_masks_all": (l, B, Q, T, 16, 24), "pred_embeds": (B, T, Q, HID)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
        assert rel(got[k], ref[k]) <= FORWARD_REL_TO_MAX, k
    # the zero background row: its logit is 0 everywhere
    assert torch.equal(got["pred_logits"][..., -1], torch.zeros(B, T, Q))


def test_ov2seg_loss_and_gradients_match_jax(ov2):
    """One slot invalid: JAX drops its write (``mode="drop"``), the port too."""
    model, params, frames, text = ov2
    rng = np.random.RandomState(7)
    labels, masks = rng.randint(0, K, (B, N)), rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    draw = point_table(rng)
    jcfg, cfg = ov2seg_cfg(JaxConfig), ov2seg_cfg(Config)
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    fake_points = lambda key, batch, p: jnp.asarray(draw(batch[0], p))  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points", fake_points)
        mp.setattr(jax_ov2seg, "sorted_uniform_points", fake_points)
        jloss_fn = jax_train.make_loss_fn(jcfg, jax_train.build_model(jcfg), K)
        fn = lambda p: jloss_fn(p, jbatch, jax.random.PRNGKey(1))  # noqa: E731
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
        # the objectness CE is not among the train metrics: from the outputs

        def losses(p):
            out = jax_train.build_model(jcfg).apply(
                {"params": p}, jbatch["pixels"].reshape(B * T, H, W, 3), T, jbatch["text_feats"])
            return jax_ov2seg.ov2seg_loss(jax.random.PRNGKey(2), out, jbatch["targets"],
                                          jcfg.model, K)

        jlosses = jax.jit(losses)(params)
    tbatch = {"pixels": torch.from_numpy(frames.reshape(B, T, H, W, 3)),
              "text_feats": torch.from_numpy(text),
              "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                     torch.from_numpy(valid),
                                     torch.ones(B, N, T, dtype=torch.bool))}
    tdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
    try:
        step = train.build_train_step(cfg, model, K, device="cpu", draw_points=tdraw)
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        loss, metrics = step.loss_fn(dict(model.named_parameters()), tbatch, torch.Generator())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        with torch.no_grad():
            pout = model(tbatch["pixels"].reshape(B * T, H, W, 3), T, tbatch["text_feats"])
            plosses = ov2seg.ov2seg_loss(torch.Generator(), pout, tbatch["targets"], cfg.model,
                                         K, draw_points=tdraw)
    finally:
        torch.backends.mkldnn.enabled = prev
        model.requires_grad_(True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    for k in ("loss_ce", "loss_object_ce", "loss_mask", "loss_dice"):
        np.testing.assert_allclose(plosses[k].numpy(), np.asarray(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    pgrads = dict(flat(flax_from_state_dict(grads)))
    jg = dict(flat(jgrads))
    for k in ("segmenter/predictor/heads/zs_fc1/kernel", "segmenter/predictor/heads/zs_fc2/kernel",
              "segmenter/predictor/heads/object_embed/kernel"):
        assert np.any(pgrads[k]), k
    for k, g in pgrads.items():
        if k.endswith("k_proj/bias") or not np.any(jg[k]):
            # an exact zero (softmax is shift-invariant): both sides round
            assert np.abs(g).max() < 1e-5 and np.abs(jg[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(g - jg[k]) / np.linalg.norm(jg[k])
        assert err <= GRAD_REL_NORM, (k, err)


def _chain_costs(embeds, indices, alpha):
    """Each frame's assignment cost along the chain ``indices`` defines, and
    the optimum of that frame's problem (scipy), in float64."""
    e = embeds / (np.linalg.norm(embeds, axis=-1, keepdims=True) + 1e-6)
    carry, got, best = e[0], [], []
    for s in range(e.shape[0]):
        c = carry / (np.linalg.norm(carry, axis=-1, keepdims=True) + 1e-6)
        cost = 1.0 - c @ e[s].T
        idx = indices[s]
        got.append(cost[np.arange(len(idx)), idx].sum())
        r, cols = linear_sum_assignment(cost)
        best.append(cost[r, cols].sum())
        carry = alpha * e[s][idx] + (1 - alpha) * carry
    return np.array(got), np.array(best)


def test_ov2seg_scores_gate_and_ema_tracking_match_jax():
    """``ov2seg_eval_scores``, ``ov2seg_frame_gate`` and the EMA chain (alpha
    0.7, frame 0 against itself) against JAX: T = 13 (a length that is not a
    multiple of 8) and T = 1; with a query duplicated in one frame (a tie) the
    port's chain is held by its costs, each frame at its optimum."""
    rng = np.random.RandomState(3)
    cls = rng.randn(13, Q, K + 1).astype(np.float32) * 3
    obj = rng.randn(13, Q, 2).astype(np.float32)
    jv, jpf = jax.jit(jax_ov2seg.ov2seg_eval_scores)(jnp.asarray(cls), jnp.asarray(obj))
    pv, ppf = ov2seg.ov2seg_eval_scores(torch.from_numpy(cls), torch.from_numpy(obj))
    assert np.abs(pv.numpy() - np.asarray(jv)).max() <= SCORE_ATOL
    assert np.abs(ppf.numpy() - np.asarray(jpf)).max() <= SCORE_ATOL
    masks = rng.randn(4, 13, 6, 8).astype(np.float32)
    video = np.array([0.5, 0.2, 0.05, 0.9], np.float32)
    per_frame = (rng.rand(13, 4) * video[None] * 0.2).astype(np.float32)
    jg = jax_ov2seg.ov2seg_frame_gate(jnp.asarray(masks), jnp.asarray(video),
                                      jnp.asarray(per_frame))
    pg = ov2seg.ov2seg_frame_gate(torch.from_numpy(masks), torch.from_numpy(video),
                                  torch.from_numpy(per_frame))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    assert (pg.numpy() == -1).any() and (pg.numpy() != -1).any()

    for t in (13, 1):
        embeds = rng.randn(2, t, Q, 16).astype(np.float32)
        ref = jax.jit(lambda e: jax_tracking.track_by_embeds(e, ema_alpha=0.7))(
            jnp.asarray(embeds))
        got = tracking.track_by_embeds(torch.from_numpy(embeds), ema_alpha=0.7)
        assert got.shape == (2, t, Q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    embeds = rng.randn(1, 13, Q, 16).astype(np.float32)
    embeds[0, 5, 3] = embeds[0, 5, 2]                          # a tie in frame 5
    got = tracking.track_by_embeds(torch.from_numpy(embeds), ema_alpha=0.7)[0].numpy()
    assert all(sorted(row) == list(range(Q)) for row in got)  # permutations
    chain, best = _chain_costs(embeds[0].astype(np.float64), got, 0.7)
    np.testing.assert_allclose(chain, best, rtol=1e-5, atol=1e-5)
