"""PyTorch port, ``solver.optimizer=sgd`` with the ``transformer_enc`` pixel
decoder against the JAX package on the CPU in f32:

  * three train steps of SimpleBaselineOnline against JAX's ``make_loss_fn``
    + ``make_optimizer`` + ``make_train_step``: the metrics of each step, the
    first step's gradients, every parameter after the third; the schedule
    crosses the warm-up's end and a decay step, and the groups take the
    backbone multiplier, three weight decays (``main``, ``nodecay``,
    ``embed``) and ``frozen`` (the stem and res2-res4, by ``freeze_at``,
    and the folded BatchNorms; the backbone's backward runs through res5
    alone); the port's SGD fed JAX's own gradients lands on JAX's
    parameters to f32 rounding;
  * a checkpoint after 2 steps restored into another init and run 1 step
    equals 3 uninterrupted steps; a checkpoint of one optimizer restored
    under the other raises, naming both;
  * the CLI: train 2 steps, ``--resume`` for a third (its trace continued),
    ``--eval-only`` from the
    checkpoint and from a flax ``.msgpack`` of the same weights; a d2
    checkpoint for the FPN decoders raises a named error.

Shapes: the tiny model of ``tests/test_torch_port_train_step.py`` (64x96
frames, 2 encoder and 2 decoder layers, Q=8, hidden 64, N=3, 32 points).  The
JAX step is one ``jax.jit``, called three times."""

import copy
import dataclasses
import json
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.parallel.train_step import TrainState, make_optimizer, make_train_step
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.checkpoint import (
    latest_step,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, params_from_flax
from openvis_tpu_torch.parallel.train_step import SGD, AdamW, config_labels, stop_frozen_gradients
from openvis_tpu_torch.structures import ClipTargets
from test_torch_port_cli import cli_root  # noqa: F401
from torch_port_common import (
    flat,
    one_thread_fixture,
    point_table,
    seeded_model,
    step_with_grads,
)

K, D, T, H, W, HID, Q, N, POINTS = 5, 32, 2, 64, 96, 64, 8, 3, 32
STEPS = 3
LOSS_RTOL = 1e-5      # f32 on both sides, the sums in other orders
GRAD_NORM_RTOL = 1e-4  # read 1.7e-5: JAX's own f32 error in the ResNet's stage 5
GRAD_REL_NORM = 1e-2  # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)
# an element moves by lr * (its clipped gradient, of global norm 0.01, plus
# its decay) a step; the clipped gradients' 1 % disagreement gives 1e-5 of
# the 0.1 rate over three steps at most (read 1.2e-7)
PARAM_ATOL = 1e-6
OPTAX_RTOL, OPTAX_ATOL = 1e-6, 1e-8  # the same gradients: f32 rounding
RESUME_REL = 1e-6                    # tests/test_torch_port_checkpoint.py's bound

one_thread = one_thread_fixture()


def sgd_cfg(cls):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K,
        backbone=dataclasses.replace(cfg.model.backbone, freeze_at=4),
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, name="transformer_enc", conv_dim=HID, mask_dim=HID,
            transformer_enc_layers=2, dim_feedforward=128, num_heads=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, hidden_dim=HID, num_queries=Q, nheads=4,
            dim_feedforward=128, dec_layers=2, mask_dim=HID, clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    # the rate: 0.05 (warm-up), 0.1, then 0.01 from the decay at 1 after it
    s = dataclasses.replace(cfg.solver, amp=False, optimizer="sgd", base_lr=0.1,
                            warmup_iters=1, warmup_factor=0.5, steps=(1,), gamma=0.1,
                            weight_decay=0.05, weight_decay_norm=0.01, weight_decay_embed=0.02,
                            backbone_multiplier=0.1)
    return dataclasses.replace(cfg, model=m, solver=s)


def _batch(rng):
    pixels = rng.randn(1, T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return (pixels, text, rng.randint(0, K, (1, N)), rng.rand(1, N, T, H, W) > 0.7,
            np.array([[True, True, False]]))


def _torch_batch(pixels, text, labels, masks, valid):
    return {"pixels": torch.from_numpy(pixels), "text_feats": torch.from_numpy(text),
            "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                   torch.from_numpy(valid), torch.ones(1, N, T, dtype=torch.bool))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's 3 steps from one set of weights, batch and
    points, the port's state saved after its second; another init restored
    from that checkpoint takes the third step."""
    rng = np.random.RandomState(0)
    cfg, jcfg = sgd_cfg(Config), sgd_cfg(JaxConfig)
    model, tree = seeded_model(cfg, 0, rng)
    start = copy.deepcopy(model.state_dict())
    params = jax.tree.map(jnp.asarray, tree)
    data = _batch(rng)
    draw = point_table(rng)
    pixels, text, labels, masks, valid = data
    jbatch = {"pixels": jnp.asarray(pixels), "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((1, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
        loss_fn = jax_train.make_loss_fn(jcfg, jax_train.build_model(jcfg), K)
        tx = make_optimizer(jcfg, params)
        # the optimizer, keeping the gradients it is handed in its state
        keep = optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)),
            lambda g, s, p=None: (lambda u, new: (u, (new, g)))(*tx.update(g, s[0], p)))
        jstep = jax.jit(make_train_step(loss_fn, keep))
        # the state made under one jit: its zero traces compile once there
        state = jax.jit(lambda p: TrainState.create(p, keep))(params)
        jmetrics, jgrads = [], []
        for _ in range(STEPS):
            state, m = jstep(state, jbatch, jax.random.PRNGKey(1))
            jmetrics.append({k: float(v) for k, v in m.items()})
            jgrads.append(state.opt_state[1])

    tdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
    tbatch = _torch_batch(*data)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
    try:
        step = train.build_train_step(cfg, model, K, device="cpu", draw_points=tdraw)
        first_metrics, grads = step_with_grads(step, tbatch, torch.Generator())
        metrics = [first_metrics, step(tbatch, torch.Generator())]
        ckpt = str(tmp_path_factory.mktemp("sgd") / "ckpt")
        save_checkpoint(ckpt, step.state.step, step.state.state_dict())
        metrics.append(step(tbatch, torch.Generator()))
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        # another init restored from the checkpoint of step 2, the third step
        resumed = train.build_train_step(
            cfg, init_params(train.build_model(cfg, device="cpu"), seed=1), K, device="cpu",
            draw_points=tdraw)
        restore_checkpoint(ckpt, resumed.state)
        restored_trace = {n: t.clone() for n, t in resumed.state.opt.trace.items()}
        resumed(tbatch, torch.Generator())
    finally:
        torch.backends.mkldnn.enabled = prev
    yield {"cfg": cfg, "start": start, "step": step, "metrics": metrics, "jmetrics": jmetrics,
            "grads": dict(flat(flax_from_state_dict(grads))),
            "jgrads": [dict(flat(jax.tree.map(np.asarray, g))) for g in jgrads],
            "jparams": dict(flat(jax.tree.map(np.asarray, state.params))),
            "resumed": resumed, "restored_trace": restored_trace, "ckpt": ckpt}
    shutil.rmtree(ckpt)  # ~190 MB of parameters and trace


def test_three_sgd_steps_match_jax(runs):
    jm, m = runs["jmetrics"], runs["metrics"]
    for i in range(STEPS):
        for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"):
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(m[i][k], jm[i][k], rtol=rtol, err_msg=(i, k))
    ref, got = runs["jgrads"][0], runs["grads"]
    trainable = {k for k, v in ref.items() if np.abs(v).max() > 0}
    assert trainable <= set(got) and len(trainable) > 100
    assert "segmenter/pixel_decoder/enc_attn1/self_attn/q_proj/kernel" in trainable
    for k in got:
        if k.endswith("k_proj/bias"):  # exactly 0: softmax is shift-invariant
            assert np.abs(got[k]).max() < 1e-5 and np.abs(ref[k]).max() < 1e-5, k
            continue
        err = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert err <= GRAD_REL_NORM, (k, err)
    model = runs["step"].state.model
    after = dict(flat(flax_from_state_dict(model.state_dict())))
    before = dict(flat(flax_from_state_dict(runs["start"])))
    labels = config_labels(runs["cfg"], model)
    moved = 0
    for k, v in runs["jparams"].items():
        np.testing.assert_allclose(after[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
        moved += int(not np.array_equal(after[k], before[k]))
    assert moved > 100
    for n, p in model.named_parameters():
        if labels[n] == "frozen":
            assert torch.equal(p.detach(), runs["start"][n]) and not p.requires_grad, n
    frozen = {n for n, g in labels.items() if g == "frozen"}
    assert {"segmenter.backbone.stem_conv1.weight",
            "segmenter.backbone.res4_block5.conv3.weight"} <= frozen
    assert set(runs["step"].state.opt.trace) == {n for n, g in labels.items() if g != "frozen"}
    # the ResNet's convolutions have no bias and its norms are frozen: no
    # backbone_nodecay
    assert {labels[n] for n in runs["step"].state.opt.hyper} == {
        "main", "nodecay", "embed", "backbone"}


def test_sgd_on_jax_gradients_matches_optax(runs):
    """The port's SGD fed the JAX step's own gradients, three steps from the
    same start, lands on JAX's parameters: the clip, the decay groups, the
    trace, the multipliers and the schedule, to f32 rounding."""
    cfg = runs["cfg"]
    model = train.build_model(cfg, device="cpu")
    model.load_state_dict(runs["start"])
    labels = config_labels(cfg, model)
    stop_frozen_gradients(model, labels)
    params = dict(model.named_parameters())
    opt = SGD(cfg, params, labels)
    for g in runs["jgrads"]:
        g = params_from_flax(_unflat(g))
        opt.step(params, {n: g[n] for n in opt.hyper})
    assert opt.count == STEPS and opt.lr(0) == pytest.approx(0.05)
    assert opt.lr(1) == pytest.approx(0.1) and opt.lr(2) == pytest.approx(0.01)
    got = dict(flat(flax_from_state_dict(model.state_dict())))
    for k, ref in runs["jparams"].items():
        np.testing.assert_allclose(got[k], ref, rtol=OPTAX_RTOL, atol=OPTAX_ATOL, err_msg=k)


def _unflat(flat_tree):
    tree = {}
    for key, v in flat_tree.items():
        *mods, leaf = key.split("/")
        node = tree
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = v
    return tree


def test_sgd_checkpoint_resumes_like_an_uninterrupted_run(runs):
    """2 steps, a checkpoint, another init restored, 1 step: the trace and
    the count come back, and the parameters equal 3 uninterrupted steps.
    An SGD checkpoint under AdamW, and an AdamW one under SGD, raise."""
    sd = load_checkpoint(runs["ckpt"])
    assert set(sd) == {"step", "params", "trace", "count"} and sd["count"] == STEPS - 1
    assert all(torch.equal(runs["restored_trace"][n], t) for n, t in sd["trace"].items())
    assert any(t.any() for t in sd["trace"].values())
    a = runs["step"].state.model.state_dict()
    b = runs["resumed"].state.model.state_dict()
    for n, p in a.items():
        assert (b[n] - p).abs().max().item() <= RESUME_REL * p.abs().max().item(), n
    assert runs["resumed"].state.opt.count == runs["step"].state.opt.count == STEPS
    state = runs["resumed"].state
    adamw = AdamW(runs["cfg"], dict(state.model.named_parameters()), config_labels(
        runs["cfg"], state.model))
    with pytest.raises(ValueError, match="sgd state.*adamw"):
        adamw.load_state_dict(sd)
    with pytest.raises(ValueError, match="adamw state.*sgd"):
        state.opt.load_state_dict(adamw.state_dict())


def test_cli_trains_resumes_and_evaluates_with_sgd(cli_root, tmp_path):  # noqa: F811
    """The CLI with ``model.pixel_decoder.name=transformer_enc
    solver.optimizer=sgd``: 2 steps and a checkpoint, ``--resume`` for a
    third that continues the restored trace (against the same resume from
    the checkpoint with its trace zeroed); ``--eval-only`` from the
    checkpoint and from a ``.msgpack`` of its weights give the same
    predictions; a d2 checkpoint for this decoder raises, naming why."""
    root, cfg_path = cli_root

    def run(*flags, **opts):
        over = {"model.pixel_decoder.name": "transformer_enc", "solver.optimizer": "sgd",
                "solver.base_lr": 0.1, **opts}
        train_net_torch.main(["--config-file", cfg_path, "--device", "cpu", *flags,
                              *(f"{k.replace('__', '.')}={v}" for k, v in over.items())])

    out, zeroed = str(tmp_path / "out"), str(tmp_path / "zeroed")
    ckpt = os.path.join(out, "checkpoints")
    run(output_dir=out)
    first = load_checkpoint(ckpt)
    assert latest_step(ckpt) == 2 and set(first) == {"step", "params", "trace", "count"}
    assert "segmenter.pixel_decoder.enc_attn0.self_attn.q_proj.weight" in first["params"]
    # the same checkpoint with its trace zeroed: the third step sees the same
    # batch and points, so the two traces differ by 0.9 x the restored one
    save_checkpoint(os.path.join(zeroed, "checkpoints"), 2, dict(
        first, trace={n: torch.zeros_like(t) for n, t in first["trace"].items()}))
    for o in (out, zeroed):
        run("--resume", output_dir=o, solver__max_iter=3)
    resumed, restarted = load_checkpoint(ckpt), load_checkpoint(os.path.join(zeroed,
                                                                             "checkpoints"))
    assert resumed["count"] == restarted["count"] == 3
    for n, t in first["trace"].items():
        carried = resumed["trace"][n] - restarted["trace"][n]
        tol = RESUME_REL * resumed["trace"][n].abs().max().item()
        assert (carried - 0.9 * t).abs().max().item() <= tol, n
    assert any(t.any() for t in first["trace"].values())

    results = []
    msgpack = str(tmp_path / "model.msgpack")
    with open(msgpack, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(flax_from_state_dict(resumed["params"])))
    for weights in (ckpt, msgpack):
        run("--eval-only", "--weights", weights, output_dir=out)
        with open(os.path.join(out, "results_torch_port_cli_eval.json")) as f:
            results.append(json.load(f))
    assert results[0] and results[0] == results[1]
    with open(tmp_path / "m2f.pkl", "wb") as f:
        f.write(b"")
    with pytest.raises(ValueError, match="no reader of a d2 checkpoint.*transformer_enc"):
        run("--eval-only", "--weights", str(tmp_path / "m2f.pkl"))
    # the checkpoints and the .msgpack: ~1 GB the tier-1 run's workers share
    shutil.rmtree(tmp_path)
