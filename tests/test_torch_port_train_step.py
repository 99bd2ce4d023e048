"""PyTorch port: one f32 train step of SimpleBaselineOnline at a tiny size
(64x96 frames, 2 encoder and 2 decoder layers, Q=8, hidden 64, N=3, 32
points) against the JAX package's ``make_loss_fn`` + ``make_optimizer`` +
``make_train_step``: losses, grad norm, every gradient, every parameter after
the AdamW update, the parameter groups, and the frozen parameters.

Both sides start from the same weights and draw the same points.  The
weights are the port's seeded init with random norm affines and sampling-
offset kernels: the init's zero offset kernels put every encoder sample on a
pixel centre, a kink of the bilinear form, where an ulp of rounding picks the
slope.  PyTorch's oneDNN CPU convolution is switched off: its f32 weight
gradient was measured off a float64 run by up to 1.5 % of the largest
element in one ResNet layer, where PyTorch's own CPU convolution agrees with
float64 to 1e-5.  JAX's own f32 gradients on this CPU are off a float64 run
of the port by up to 2.8e-3 in relative norm (1.1e-2 of the largest element)
in the ResNet's stage-4 layers, where the port's f32 gradients are off by
1e-6 (3e-6 of the largest element).  That sets the gradient and update
tolerances against JAX; the port's gradients are also held tightly to its
own float64 run, and its optimizer to optax on the same gradients.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.parallel.train_step import (
    TrainState,
    label_params,
    make_optimizer,
    make_train_step,
)
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    params_from_flax,
)
from openvis_tpu_torch.models.backbone.resnet import FrozenAffine
from openvis_tpu_torch.parallel.train_step import (
    AdamW,
    config_labels,
    stop_frozen_gradients,
)
from openvis_tpu_torch.parallel.train_step import label_params as port_label_params
from openvis_tpu_torch.structures import ClipTargets
from torch_port_common import one_thread_fixture, step_with_grads

one_thread = one_thread_fixture()

K, D, T, H, W, HID, Q, N, POINTS = 5, 32, 2, 64, 96, 64, 8, 3, 32


def tiny_config(cls, amp: bool, freeze_at: int = 0):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K,
        backbone=dataclasses.replace(cfg.model.backbone, freeze_at=freeze_at),
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, hidden_dim=HID, num_queries=Q, nheads=4,
            dim_feedforward=128, dec_layers=2, mask_dim=HID, clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=amp))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def unflat(flat_tree):
    tree = {}
    for key, v in flat_tree.items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_both(amp: bool):
    """One train step on each side from the same weights, batch and points."""
    rng = np.random.RandomState(0)
    cfg, jcfg = tiny_config(Config, amp), tiny_config(JaxConfig, amp)
    model = init_params(train.build_model(cfg, device="cpu"), seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))

    pixels = rng.randn(1, T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    labels, masks = rng.randint(0, K, (1, N)), rng.rand(1, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]], -1).astype(np.float32)
        return table[(b, p)]

    jbatch = {"pixels": jnp.asarray(pixels), "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((1, N, T), bool))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
        jm = jax_train.build_model(jcfg)
        loss_fn = jax_train.make_loss_fn(jcfg, jm, K)
        tx = make_optimizer(jcfg, params)
        # the optimizer, keeping in its state the gradients the step hands
        # it: one differentiation gives the gradients and the update
        keep = optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)),
            lambda g, s, p=None: (lambda u, new: (u, (new, g)))(*tx.update(g, s[0], p)))

        def step_and_grads(state, batch, key):
            new_state, metrics = make_train_step(loss_fn, keep)(state, batch, key)
            return new_state.opt_state[1], new_state.params, metrics

        # the state made inside the jit: its zero moments compile once there
        j_grads, j_params, j_metrics = jax.jit(
            lambda p, b, k: step_and_grads(TrainState.create(p, keep), b, k))(
            params, jbatch, jax.random.PRNGKey(1))

    tbatch = {"pixels": torch.from_numpy(pixels), "text_feats": torch.from_numpy(text),
              "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                     torch.from_numpy(valid),
                                     torch.ones(1, N, T, dtype=torch.bool))}
    port_draw = lambda g, batch, p: torch.from_numpy(draw(batch[0], p))
    frozen = {f"{mn}.{pn}": p.detach().clone() for mn, m in model.named_modules()
              if isinstance(m, FrozenAffine) for pn, p in m.named_parameters()}
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        step = train.build_train_step(cfg, model, K, device="cpu", draw_points=port_draw)
        grads64 = {}
        if not amp:  # the same loss in float64, from the weights before the step
            model64 = copy.deepcopy(model).double()
            named64 = {n: p for n, p in model64.named_parameters() if p.requires_grad}
            batch64 = dict(tbatch, pixels=tbatch["pixels"].double(),
                           text_feats=tbatch["text_feats"].double())
            loss64, _ = train.make_loss_fn(cfg, model64, K, port_draw)(
                dict(model64.named_parameters()), batch64, torch.Generator())
            grads64 = dict(zip(named64, torch.autograd.grad(loss64, list(named64.values()))))
        # the step's own gradients and its update
        metrics, grads = step_with_grads(step, tbatch, torch.Generator())
    finally:
        torch.backends.mkldnn.enabled = prev
    return {
        "jax_metrics": {k: float(v) for k, v in j_metrics.items()},
        "jax_grads": jax_flat(j_grads), "jax_params": jax_flat(j_params),
        "jax_params_before": jax_flat(params),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": dict(flat(flax_from_state_dict(grads))),
        "grads64": dict(flat(flax_from_state_dict(grads64))),
        "params": dict(flat(flax_from_state_dict(model.state_dict()))),
        "frozen_before": frozen, "model": model,
    }


@pytest.fixture(scope="module")
def f32_step():
    return run_both(amp=False)


def test_losses_and_grad_norm_match_jax(f32_step):
    # f32 on both sides, same weights, points and assignments; the sums run
    # in other orders through ~60 layers
    for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"):
        np.testing.assert_allclose(f32_step["metrics"][k], f32_step["jax_metrics"][k],
                                   rtol=1e-5, err_msg=k)


def test_every_gradient_matches_jax(f32_step):
    ref, got = f32_step["jax_grads"], f32_step["grads"]
    trainable = {k for k, v in ref.items() if np.abs(v).max() > 0}
    assert trainable <= set(got) and len(trainable) > 100
    for k in got:
        if k.endswith("k_proj/bias"):
            # the exact gradient is 0 (softmax is shift-invariant): both
            # sides compute rounding noise
            assert np.abs(got[k]).max() < 1e-5 and np.abs(ref[k]).max() < 1e-5, k
            continue
        # 1e-2 in relative norm, 4x JAX's own f32 error (see above)
        err = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert err <= 1e-2, (k, err)


def test_every_gradient_matches_float64(f32_step):
    """The port's f32 gradients against the same loss in float64 (the plain
    kernels run in f32 inside, so the float64 run is exact to ~1e-7)."""
    ref, got = f32_step["grads64"], f32_step["grads"]
    assert set(ref) == set(got)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-5 * np.abs(ref[k]).max() + 1e-5, err_msg=k)


def test_every_parameter_after_adamw_matches_jax(f32_step):
    ref, got, before = f32_step["jax_params"], f32_step["params"], f32_step["jax_params_before"]
    assert set(ref) == set(got)
    moved = 0
    for k in ref:
        # an element moves by ~lr * multiplier (Adam's normalized step plus
        # decay; lr = 1e-4, x0.1 in the backbone); where its clipped gradient
        # is within a few eps of 0 the step follows the gradient's relative
        # error (JAX's, above), so the sides agree to 20 % of lr; the
        # optimizer alone is held to 1e-6 relative below
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(got[k], before[k]))
    assert moved > 100


def test_adamw_matches_optax_on_the_same_gradients(f32_step):
    """The port's AdamW fed the JAX step's own gradients lands on the JAX
    step's parameters: clip, Adam moments, bias correction, decay groups and
    learning-rate multipliers, to f32 rounding."""
    cfg = tiny_config(Config, amp=False)
    model = train.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(unflat(f32_step["jax_params_before"])))
    labels = config_labels(cfg, model)
    stop_frozen_gradients(model, labels)
    params = dict(model.named_parameters())
    grads = params_from_flax(unflat(f32_step["jax_grads"]))
    opt = AdamW(cfg, params, labels)
    opt.step(params, {n: grads[n] for n in opt.hyper})
    got = dict(flat(flax_from_state_dict(model.state_dict())))
    for k, ref in f32_step["jax_params"].items():
        np.testing.assert_allclose(got[k], ref, rtol=1e-6, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("freeze_at", [0, 2])
def test_parameter_groups_match_jax_label_params(freeze_at):
    cfg = tiny_config(Config, amp=False, freeze_at=freeze_at)
    model = train.build_model(cfg, device="cpu")
    tree = flax_from_state_dict(model.state_dict())
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): v for path, v in
           jax.tree_util.tree_flatten_with_path(label_params(tree, freeze_at=freeze_at))[0]}
    got = port_label_params(model.named_parameters(), freeze_at=freeze_at)
    got = {"/".join(flax_path(n, p.dim())): got[n] for n, p in model.named_parameters()}
    assert got == ref
    # the trap: a LayerNorm weight is flax's "scale", a no-decay parameter
    assert got["segmenter/predictor/ffn0/norm/scale"] == "nodecay"
    assert got["segmenter/backbone/res2_block0/norm1/scale"] == "frozen"


def test_frozen_parameters_stay_fixed(f32_step):
    model = f32_step["model"]
    assert len(f32_step["frozen_before"]) > 50
    params = dict(model.named_parameters())
    for name, before in f32_step["frozen_before"].items():
        assert not params[name].requires_grad, name
        assert torch.equal(params[name].detach(), before), name
