"""PyTorch port: the set criterion (matcher + losses over the decoder layers)
against the JAX package's ``set_criterion`` and ``jax.grad``.

Both sides get the same points: the port through its ``draw_points``
argument, the JAX side through ``sorted_uniform_points`` patched to return the
same numpy arrays, keyed by (batch, points).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.losses.criterion as jcrit
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch.losses import criterion
from openvis_tpu_torch.structures import ClipTargets

L, B, Q, C, N = 3, 2, 8, 5, 3
H, W, TH, TW = 16, 24, 64, 96
POINTS = 32


def _points():
    rng = np.random.RandomState(7)
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]], -1).astype(np.float32)
        return table[(b, p)]

    return draw


def _inputs(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(L, B, Q, C + 1) * 2).astype(np.float32)
    masks = (rng.randn(L, B, Q, 1, H, W) * 3).astype(np.float32)
    labels = rng.randint(0, C, (B, N))
    tmasks = rng.rand(B, N, 1, TH, TW) > 0.6
    valid = np.array([[True, True, True], [True, False, True]])
    return logits, masks, labels, tmasks, valid


def _run_jax(monkeypatch, draw, logits, masks, labels, tmasks, valid, deep):
    monkeypatch.setattr(jcrit, "sorted_uniform_points",
                        lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
    s = jcrit.CriterionSettings(num_classes=C, num_points=POINTS, deep_supervision=deep)
    targets = JaxTargets(labels=jnp.asarray(labels, jnp.int32), masks=jnp.asarray(tmasks),
                         valid=jnp.asarray(valid), frame_valid=jnp.ones((B, N, 1), bool))

    def total(lg, mk):
        losses, _ = jcrit.set_criterion(jax.random.PRNGKey(0), lg, mk, targets, s)
        return losses["total"], losses

    (tot, losses), grads = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(masks).astype(masks.dtype))
    return losses, grads


def _run_port(draw, logits, masks, labels, tmasks, valid, deep, mask_dtype=torch.float32):
    s = criterion.CriterionSettings(num_classes=C, num_points=POINTS, deep_supervision=deep)
    targets = ClipTargets(torch.from_numpy(labels), torch.from_numpy(tmasks),
                          torch.from_numpy(valid), torch.ones(B, N, 1, dtype=torch.bool))
    lg = torch.from_numpy(logits).requires_grad_()
    mk = torch.from_numpy(masks).to(mask_dtype).requires_grad_()
    losses, _ = criterion.set_criterion(
        torch.Generator(), lg, mk, targets, s,
        draw_points=lambda g, batch, p: torch.from_numpy(draw(batch[0], p)))
    losses["total"].backward()
    return losses, (lg.grad, mk.grad)


@pytest.mark.parametrize("deep", [True, False])
def test_set_criterion_losses_and_grads_match_jax(monkeypatch, deep):
    inputs = _inputs(0)
    draw = _points()
    ref, (dl_ref, dm_ref) = _run_jax(monkeypatch, draw, *inputs, deep)
    got, (dl, dm) = _run_port(draw, *inputs, deep)
    # f32 on both sides, the same points and assignments: sums in other orders
    for k in ("loss_ce", "loss_mask", "loss_dice", "total"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dm.numpy(), np.asarray(dm_ref), rtol=1e-4, atol=1e-6)


def test_bf16_mask_stack_matches_jax(monkeypatch):
    """A bf16 mask stack (the AMP train step) is sampled under the f32
    policy on both sides; only the mask gradient's bf16 rounding differs."""
    logits, masks, labels, tmasks, valid = _inputs(1)
    masks_bf16 = np.asarray(jnp.asarray(masks).astype(jnp.bfloat16))
    draw = _points()
    ref, (_, dm_ref) = _run_jax(monkeypatch, draw, logits, masks_bf16, labels, tmasks,
                                valid, True)
    masks_f32 = masks_bf16.astype(np.float32)
    got, (_, dm) = _run_port(draw, logits, masks_f32, labels, tmasks, valid, True,
                             mask_dtype=torch.bfloat16)
    assert dm.dtype == torch.bfloat16
    np.testing.assert_allclose(got["total"].item(), float(ref["total"]), rtol=1e-5)
    np.testing.assert_allclose(dm.float().numpy(), np.asarray(dm_ref, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_match_and_normalizer_match_jax(monkeypatch):
    logits, masks, labels, tmasks, valid = _inputs(2)
    draw = _points()
    monkeypatch.setattr(jcrit, "sorted_uniform_points",
                        lambda key, batch, p: jnp.asarray(draw(batch[0], p)))
    s_j = jcrit.CriterionSettings(num_classes=C, num_points=POINTS)
    s_t = criterion.CriterionSettings(num_classes=C, num_points=POINTS)
    jt = JaxTargets(labels=jnp.asarray(labels, jnp.int32), masks=jnp.asarray(tmasks),
                    valid=jnp.asarray(valid), frame_valid=jnp.ones((B, N, 1), bool))
    tt = ClipTargets(torch.from_numpy(labels), torch.from_numpy(tmasks),
                     torch.from_numpy(valid), torch.ones(B, N, 1, dtype=torch.bool))
    port_draw = lambda b, p: torch.from_numpy(draw(b, p))
    cost_ref = np.asarray(jcrit.match_costs(jax.random.PRNGKey(0), jnp.asarray(logits[0]),
                                            jnp.asarray(masks[0]), jt, s_j))
    cost = criterion.match_costs(port_draw, torch.from_numpy(logits[0]),
                                 torch.from_numpy(masks[0]), tt, s_t)
    np.testing.assert_allclose(cost.numpy(), cost_ref, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jcrit.match(jax.random.PRNGKey(0), jnp.asarray(logits[0]),
                                 jnp.asarray(masks[0]), jt, s_j))
    got = criterion.match(port_draw, torch.from_numpy(logits[0]), torch.from_numpy(masks[0]),
                          tt, s_t).numpy()
    rows = np.arange(N)
    for b in range(B):  # ties may resolve otherwise: compare total costs
        assert abs(cost_ref[b][rows, got[b]].sum() - cost_ref[b][rows, ref[b]].sum()) < 1e-5
    assert float(criterion.num_masks_normalizer(tt)) == float(jcrit.num_masks_normalizer(jt))
