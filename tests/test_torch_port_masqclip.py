"""PyTorch port, MasQCLIP against the JAX package on the CPU in f32: the MasQ
tower (mask class tokens, the allow mask), its tree, ``convert`` and
parameter groups, the resizes it stands on, the whole model's forward, loss,
gradients and one AdamW step, ``label_assign`` at its threshold and the fused
eval scores.

Shapes: ``tests/test_masqclip_ov2seg.py``'s tiny segmenter (64x96 frames, Q=8,
hidden 64, 2 decoder layers) over the ``video_proposal`` decoder, as JAX's
own engine test pairs it, with the ``test-tiny`` CLIP as the MasQ tower (4
blocks of width 64, patch 8 at 64x64, D = 32).  One set of weights, the
port's seeded init with random norm affines and sampling-offset kernels, goes
into both packages; each JAX reference is one ``jax.jit``.

Bounds (f32, the same arithmetic in another order): outputs within 1e-5 of
their largest element, gradients within 1e-4 of theirs (``k_proj``'s bias
has an exact zero gradient, softmax being shift-invariant: both sides round
to below 1e-5), the parameters after one AdamW step within 1e-6; the fused
scores within 1e-6; the pseudo-labels equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import openvis_tpu.models.meta.masqclip as jax_masq
import openvis_tpu.train as jax_train
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models.clip_masq import MasQCLIPVisual as JaxMasQVisual
from openvis_tpu.parallel.train_step import make_optimizer
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu.utils import image as jax_image
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
)
from openvis_tpu_torch.models.clip.model import model_shape
from openvis_tpu_torch.models.clip_masq import MasQCLIPVisual, allow_bias
from openvis_tpu_torch.models.meta import masqclip
from openvis_tpu_torch.parallel.train_step import config_labels
from openvis_tpu_torch.structures import ClipTargets
from openvis_tpu_torch.utils.image import resize_bicubic_torch_hw, resize_bilinear_torch_hw
from torch_port_common import (
    flat,
    jax_labels,
    one_thread_fixture,
    point_table,
    rel,
    seeded_model,
    step_with_grads,
)

K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 2, 64, 96, 64, 8, 3, 128
OUT_REL_TO_MAX = 1e-5
GRAD_REL_TO_MAX = 1e-4
EXACT_ZERO_ATOL = 1e-5
PARAM_ATOL = 1e-6
SCORE_ATOL = 1e-6
TINY = model_shape("test-tiny")

one_thread = one_thread_fixture()


def masq_cfg(cls, freeze_segmenter=False):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K, meta_architecture="MasQCLIP",
        freeze_segmenter=freeze_segmenter,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=1,
            dim_feedforward=128, num_heads=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="video_proposal", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID,
            clip_embed_dim=D),
        clip_adapter=dataclasses.replace(cfg.model.clip_adapter, clip_model_name="test-tiny"),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


def _tower(seed):
    """The port's test-tiny MasQ tower from a seed, random norm affines, and
    its weights as a flax tree."""
    s = TINY
    tower = init_params(MasQCLIPVisual(s["vision_patch"], s["vision_width"], s["vision_layers"],
                                       s["vision_heads"], s["embed_dim"], s["image_size"]), seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if name.endswith("ln.weight"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
    return tower, flax_from_state_dict(tower.state_dict())


def test_masq_tower_tree_groups_and_resizes_match_jax():
    """The tower against JAX on 2 images of 4 masks each: one mask empty
    everywhere (its token attends to the cls key alone), the others at 40x56
    (bilinear to the 64x64 grid inside the tower) with edges off the patch
    grid.  The whole model's tree loads strictly and back, and its groups
    equal JAX's ``label_params`` with ``freeze_segmenter`` off and on.  The
    resizes it stands on, on non-square inputs: masks (96, 160) -> (224, 224)
    bilinear, frames (40, 72) -> (64, 64) bicubic."""
    rng = np.random.RandomState(0)
    maps = rng.randn(2, 3, 96, 160).astype(np.float32)
    np.testing.assert_allclose(
        resize_bilinear_torch_hw(torch.from_numpy(maps), (224, 224)).numpy(),
        np.asarray(jax.jit(jax_image.resize_bilinear_torch_hw, static_argnums=1)(
            jnp.asarray(maps), (224, 224))),
        rtol=0, atol=OUT_REL_TO_MAX * np.abs(maps).max())
    frames = rng.rand(2, 40, 72, 3).astype(np.float32)
    got = resize_bicubic_torch_hw(torch.from_numpy(frames).permute(0, 3, 1, 2), (64, 64))
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(),
        np.asarray(jax.jit(jax_image.resize_bicubic_torch, static_argnums=1)(
            jnp.asarray(frames), (64, 64))),
        rtol=0, atol=OUT_REL_TO_MAX)

    tower, tree = _tower(3)
    s = TINY
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    masks = np.full((2, 4, 40, 56), -4.0, np.float32)
    masks[0, 1, 3:17, 5:29] = 3.0      # edges inside patches
    masks[0, 2] = rng.randn(40, 56)
    masks[1, 0, 20:, 30:] = 2.0
    masks[1, 1:3] = rng.randn(2, 40, 56) + 0.5
    masks[1, 3, 11, 13] = 5.0          # one pixel
    jt = JaxMasQVisual(patch_size=s["vision_patch"], width=s["vision_width"],
                       layers=s["vision_layers"], heads=s["vision_heads"],
                       embed_dim=s["embed_dim"], image_size=s["image_size"])
    ref = jax.jit(lambda p, x, m: jt.apply({"params": p}, x, m))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images), jnp.asarray(masks))
    with torch.no_grad():
        feats = tower(torch.from_numpy(images), torch.from_numpy(masks))
    assert feats.shape == (2, 4, s["embed_dim"])
    assert rel(feats, ref) <= OUT_REL_TO_MAX
    np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=-1).numpy(), 1.0, rtol=1e-5)
    # the empty mask allows the cls key alone; a one-pixel mask its patch too
    bias = allow_bias(torch.from_numpy(masks), (8, 8), 8, torch.float32)
    assert torch.isfinite(bias[0, 0, 0]).tolist() == [True] + [False] * 64
    assert 2 <= int(torch.isfinite(bias[1, 0, 3]).sum()) <= 5

    jm = jax_train.build_model(masq_cfg(JaxConfig))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T, jnp.zeros((K, D))))["params"]
    tree = jax.tree.map(lambda x: np.asarray(rng.randn(*x.shape), np.float32), shapes)
    attn = tree["clip_adapter"]["resblock0"]["attn"]
    assert set(attn) == {"q_proj", "k_proj", "v_proj", "out_proj", "new_q_proj"}
    assert tree["clip_adapter"]["mask_embeddings"].shape == (s["vision_width"],)
    for freeze in (False, True):
        cfg = masq_cfg(Config, freeze)
        model = load_flax_params(train.build_model(cfg, device="cpu"), tree)
        back = dict(flat(flax_from_state_dict(model.state_dict())))
        assert back.keys() == dict(flat(tree)).keys()
        assert all(np.array_equal(back[k], v) for k, v in flat(tree))
        groups = config_labels(cfg, model)
        pl = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in model.named_parameters()}
        prefixes = ("segmenter", "clip_adapter") if freeze else ()
        assert pl == jax_labels(tree, freeze_prefixes=prefixes)
        # JAX freezes clip_adapter/visual/ only: the MasQ tower trains
        want = "frozen" if freeze else "main"
        assert pl["clip_adapter/resblock0/attn/new_q_proj/kernel"] == want
        assert pl["clip_adapter/resblock0/attn/q_proj/kernel"] == want
        assert pl["clip_adapter/mask_embeddings"] == ("frozen" if freeze else "embed")


def test_masqclip_forward_loss_gradients_and_adamw_match_jax():
    """The whole model's forward, the loss (one target slot invalid) and every
    gradient against JAX's loss closure, the segmenter's gradients exactly
    zero on both sides (its outputs are detached); then one AdamW step of the
    port's train step against optax's update of JAX's gradients, the
    segmenter's weights decaying."""
    rng = np.random.RandomState(0)
    cfg, jcfg = masq_cfg(Config), masq_cfg(JaxConfig)
    model, tree = seeded_model(cfg, 0, rng)
    params = jax.tree.map(jnp.asarray, tree)
    pixels = rng.randn(B, T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    labels, masks = rng.randint(0, K, (B, N)), rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    draw = point_table(rng)
    jbatch = {"pixels": jnp.asarray(pixels), "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_masq, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
        jm = jax_train.build_model(jcfg)
        loss_fn = jax_train.make_loss_fn(jcfg, jm, K)
        tx = make_optimizer(jcfg, params)

        def reference(p, batch):
            (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                p, batch, jax.random.PRNGKey(1))
            updates, _ = tx.update(grads, tx.init(p), p)
            return loss, metrics, grads, optax.apply_updates(p, updates)

        jloss, jmetrics, jgrads, jnew = jax.jit(reference)(params, jbatch)
        jout = jax.jit(lambda p, x, t: {k: v for k, v in jm.apply({"params": p}, x, T, t).items()
                                        if k in ("clip_logits", "base_logits", "pred_masks")})(
            params, jbatch["pixels"].reshape(B * T, H, W, 3), jbatch["text_feats"])
    tbatch = {"pixels": torch.from_numpy(pixels), "text_feats": torch.from_numpy(text),
              "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                     torch.from_numpy(valid),
                                     torch.ones(B, N, T, dtype=torch.bool))}
    tdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
    try:
        with torch.no_grad():
            out = model(tbatch["pixels"].reshape(B * T, H, W, 3), T, tbatch["text_feats"])
        step = train.build_train_step(cfg, model, K, device="cpu", draw_points=tdraw)
        # the step's own gradients (zeros where a parameter takes none) and its update
        metrics, grads = step_with_grads(step, tbatch, torch.Generator())
        loss = metrics["total_loss"]
    finally:
        torch.backends.mkldnn.enabled = prev
    assert out["clip_logits"].shape == (B, Q, K) and out["base_logits"].shape == (B, Q, 2)
    for k in jout:
        assert rel(out[k], jout[k]) <= OUT_REL_TO_MAX, k
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=OUT_REL_TO_MAX)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=OUT_REL_TO_MAX,
                                   atol=0, err_msg=k)
    pgrads, jg = dict(flat(flax_from_state_dict(grads))), dict(flat(jgrads))
    # the backbone's frozen affines: no gradient in the port, zero in JAX
    assert pgrads.keys() <= jg.keys()
    assert all(not np.any(jg[k]) for k in jg.keys() - pgrads.keys())
    for k, g in pgrads.items():
        if k.startswith("segmenter/"):
            assert not np.any(g) and not np.any(jg[k]), k
        elif k.endswith("k_proj/bias") or not np.any(jg[k]):
            assert np.abs(g).max() < EXACT_ZERO_ATOL and np.abs(jg[k]).max() < EXACT_ZERO_ATOL, k
        else:
            assert rel(g, jg[k]) <= GRAD_REL_TO_MAX, k
    # the tower trains through the mask tokens only
    trained = {k for k, g in jg.items() if np.any(g) and not k.endswith("k_proj/bias")}
    assert "clip_adapter/resblock0/attn/new_q_proj/kernel" in trained
    assert "clip_adapter/mask_embeddings" in trained
    assert not {"clip_adapter/conv1/kernel", "clip_adapter/positional_embedding",
                "clip_adapter/resblock0/attn/q_proj/kernel"} & trained
    got, new, before = (dict(flat(flax_from_state_dict(model.state_dict()))), dict(flat(jnew)),
                        dict(flat(tree)))
    for k, v in new.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
    decayed = [k for k in new if k.startswith("segmenter/") and not np.array_equal(got[k],
                                                                                  before[k])]
    assert "segmenter/predictor/heads/class_embed/kernel" in decayed and len(decayed) > 50


def _fixed_points(p):
    """(1, p, 2) points on pixel centres of the 64x96 map, y ascending."""
    ys, xs = np.divmod(np.arange(p) * 37 % (H * W), W)
    order = np.argsort(ys, kind="stable")
    return np.stack([(xs[order] + 0.5) / W, (ys[order] + 0.5) / H], -1)[None].astype(np.float32)


def test_label_assign_matches_jax_at_its_threshold():
    """Fixed points, T=1.  Target 0 covers the map, target 1 its left half,
    target 2 the map too but its slot is invalid.  A query of constant
    probability s has the dice ``1 - (2 P s + 1) / (P s + P + 1)`` against
    target 0; queries 0 and 1 sit 1e-3 in s on either side of the dice 0.4,
    query 2 copies target 1, query 3 is empty."""
    p = 64
    coords = _fixed_points(p)
    s0 = (0.6 * p - 0.4) / (1.4 * p)            # dice exactly 0.4 against target 0
    logit = lambda s: float(np.log(s / (1 - s)))  # noqa: E731
    pm = np.full((1, 4, 1, H, W), -20.0, np.float32)
    pm[0, 0] = logit(s0 + 1e-3)
    pm[0, 1] = logit(s0 - 1e-3)
    pm[0, 2, :, :, :W // 2] = 20.0
    tm = np.zeros((1, N, 1, H, W), bool)
    tm[0, 0] = True
    tm[0, 1, :, :, :W // 2] = True
    tm[0, 2] = True
    labels = np.array([[4, 2, 3]])
    valid = np.array([[True, True, False]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_masq, "sorted_uniform_points", lambda key, b, n: jnp.asarray(coords))
        ref = jax.jit(lambda m: jax_masq.label_assign(
            jax.random.PRNGKey(0), m, JaxTargets(jnp.asarray(labels), jnp.asarray(tm),
                                                 jnp.asarray(valid),
                                                 jnp.ones((1, N, 1), bool)), num_points=p))(
            jnp.asarray(pm))
    got = masqclip.label_assign(
        torch.Generator(), torch.from_numpy(pm),
        ClipTargets(torch.from_numpy(labels), torch.from_numpy(tm), torch.from_numpy(valid),
                    torch.ones(1, N, 1, dtype=torch.bool)),
        num_points=p, draw_points=lambda g, b, n: torch.from_numpy(coords))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    lab, ok, idx = (a.numpy()[0] for a in got)
    assert ok.tolist() == [True, False, True, False]
    assert idx[:3].tolist() == [0, 0, 1] and lab[2] == 2    # the invalid slot is never taken


def test_eval_scores_and_the_last_row_as_background():
    """``masqclip_eval_scores`` with a clip-level and a frame head against JAX.
    The last text row is the background: its column is never scored, and a
    query whose pseudo-label is the last class costs the loss what an
    unassigned one does (weight ``no_object_weight`` on the last row), in
    both packages."""
    rng = np.random.RandomState(4)
    clip = rng.randn(2, Q, K).astype(np.float32) * 4
    for base in (rng.randn(2, Q, 2), rng.randn(2, T, Q, 2)):
        base = base.astype(np.float32) * 3
        ref = jax_masq.masqclip_eval_scores({"base_logits": jnp.asarray(base),
                                             "clip_logits": jnp.asarray(clip)})
        got = masqclip.masqclip_eval_scores({"base_logits": torch.from_numpy(base),
                                             "clip_logits": torch.from_numpy(clip)})
        assert got.shape == (2, Q, K - 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=SCORE_ATOL)

    cfg, jcfg = masq_cfg(Config), masq_cfg(JaxConfig)
    # sparse random masks: a query's dice against another query's mask is ~0.8
    masks = np.where(rng.rand(1, Q, 1, H, W) > 0.8, 20.0, -20.0).astype(np.float32)
    outputs = {"pred_masks": masks, "clip_logits": clip[:1]}
    coords = _fixed_points(POINTS)
    tm = masks > 0
    valid = np.zeros((1, Q), bool)
    valid[0, :4] = True
    jax_loss = jax.jit(lambda o, labels: jax_masq.masqclip_loss(
        jax.random.PRNGKey(0), o, JaxTargets(labels, jnp.asarray(tm), jnp.asarray(valid),
                                             jnp.ones((1, Q, 1), bool)), jcfg.model, K)["total"])
    losses = []
    for label in (K - 1, 0):
        # query i's mask is target i's: every query takes its target's label
        labels = np.full((1, Q), label)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_masq, "sorted_uniform_points", lambda key, b, n: jnp.asarray(coords))
            jl = jax_loss({k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(labels))
        pl = masqclip.masqclip_loss(
            torch.Generator(), {k: torch.from_numpy(v) for k, v in outputs.items()},
            ClipTargets(torch.from_numpy(labels), torch.from_numpy(tm), torch.from_numpy(valid),
                        torch.ones(1, Q, 1, dtype=torch.bool)),
            cfg.model, draw_points=lambda g, b, n: torch.from_numpy(coords))["total"]
        np.testing.assert_allclose(pl.item(), float(jl), rtol=OUT_REL_TO_MAX)
        losses.append(pl.item())
    # all queries background either way (the last class) or 4 of them class 0
    logp = torch.log_softmax(torch.from_numpy(clip[0]), -1)
    w = cfg.model.criterion.no_object_weight
    np.testing.assert_allclose(losses[0], float(-logp[:, -1].mean()), rtol=OUT_REL_TO_MAX)
    want = -(logp[:4, 0].sum() + w * logp[4:, -1].sum()) / (4 + w * (Q - 4))
    np.testing.assert_allclose(losses[1], float(want), rtol=OUT_REL_TO_MAX)
