"""Set-prediction matcher and criterion (Mask2Former style).

Port of ``openvis_tpu/losses/criterion.py``: ``CriterionSettings``,
``target_rows_t`` (plain layout), ``match_costs``, ``match``,
``tracking_match``, ``_loss_labels``, ``_loss_masks``,
``num_masks_normalizer`` and ``set_criterion`` (with BriVIS's
``fixed_assignment``).

  * matching cost = ``w_class * (-p[target])`` + ``w_mask * point sigmoid-CE``
    + ``w_dice * point dice`` on ``num_points`` shared random points per batch
    item; the assignment comes from the exact Hungarian solver
    (``ops/hungarian.py``, kernel K4 on the card);
  * losses: weighted CE over classes with the ``eos_coef`` no-object weight,
    and point-sampled sigmoid-CE / dice mask losses on a 3x oversampled
    candidate pool shared by the rows of a batch item, of which the 0.75
    most uncertain per row are kept, plus fresh random points;
  * every decoder layer is matched anew (deep supervision), unless a
    ``fixed_assignment`` is given: then no cost is drawn or solved and every
    layer reuses it.

The points come from an explicit ``torch.Generator`` through one argument,
``draw_points(generator, batch, p) -> (*batch, p, 2)`` (default
``sorted_uniform_points``), so a test can hand both packages the same points.
The L layers' cost matrices are solved in ONE Hungarian call of (L*B, N, Q)
problems.

Global-batch semantics under a process group (``parallel/dist.py``), as the
JAX step computes the loss of the global array: each process holds B of the
global batch's world * B items; every process draws the points of all world *
B items from the same stream and keeps its own slice; ``num_masks`` and the
CE loss's weight sum are sums over the processes (not averages over them, as
the reference's Mask2Former takes).  Each process's losses are then its share
of the global batch's, and their sum over the processes is the global loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from openvis_tpu_torch.ops.hungarian import batched_hungarian
from openvis_tpu_torch.ops.point_sample import (
    sample_maps_shared,
    sample_maps_shared_t,
    sorted_uniform_points,
)
from openvis_tpu_torch.ops.select import kth_largest
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.structures import ClipTargets

# (B, P) -> (B, P, 2) points on the device of the maps
Draw = Callable[[int, int], torch.Tensor]


@dataclass(frozen=True)
class CriterionSettings:
    num_classes: int
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    eos_coef: float = 0.1
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    deep_supervision: bool = True
    use_class_loss: bool = True
    # criterion.bf16_masks: sample bf16 mask logits in bf16 (no kernel yet)
    bf16_sampling: bool = False


def target_rows_t(targets: ClipTargets, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, TH*TW, N*T) contiguous target-mask rows, built once per step for
    every layer's shared-point sampling; 0/1 masks are exact in bf16."""
    b, n, t, th, tw = targets.masks.shape
    flat = targets.masks.to(dtype).reshape(b, n * t, th * tw)
    return flat.transpose(1, 2).contiguous()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _sampling_masks(pred_masks: torch.Tensor, s: CriterionSettings) -> torch.Tensor:
    """f32 sampling policy unless bf16 sampling is opted in; a bf16 stack
    stays bf16 and the sampler widens it exactly."""
    if s.bf16_sampling:
        return pred_masks.to(torch.bfloat16)
    return pred_masks if pred_masks.dtype == torch.bfloat16 else pred_masks.float()


def match_costs(
    draw: Draw,
    pred_logits: Optional[torch.Tensor],  # (B, Q, C+1)
    pred_masks: torch.Tensor,             # (B, Q, T, H, W)
    targets: ClipTargets,
    s: CriterionSettings,
    tgt_t: Optional[torch.Tensor] = None,  # (B, TH*TW, N*T) from target_rows_t
) -> torch.Tensor:
    """(B, N, Q) cost matrix (rows = targets), zero rows for invalid slots."""
    b, q, t, h, w = pred_masks.shape
    n = targets.labels.shape[1]
    p = s.num_points
    th, tw = targets.masks.shape[-2:]
    coords = draw(b, p)
    f32p = not s.bf16_sampling
    pm = _sampling_masks(pred_masks, s).reshape(b, q * t, h, w)
    out_pts = sample_maps_shared(pm, coords, f32_policy=f32p).float()
    if tgt_t is None:
        tgt_t = target_rows_t(targets)
    tgt_pts = sample_maps_shared_t(tgt_t, th, tw, coords, f32_policy=f32p).float()
    out_pts = out_pts.reshape(b, q, t * p)
    tgt_pts = tgt_pts.reshape(b, n, t * p)

    pos = _softplus(-out_pts)
    neg = _softplus(out_pts)
    cost_mask = (torch.einsum("bqp,bnp->bqn", pos, tgt_pts)
                 + torch.einsum("bqp,bnp->bqn", neg, 1.0 - tgt_pts)) / (t * p)
    sig = torch.sigmoid(out_pts)
    numer = 2.0 * torch.einsum("bqp,bnp->bqn", sig, tgt_pts)
    denom = sig.sum(-1)[:, :, None] + tgt_pts.sum(-1)[:, None, :]
    cost_dice = 1.0 - (numer + 1.0) / (denom + 1.0)

    cost = s.mask_weight * cost_mask + s.dice_weight * cost_dice
    if pred_logits is not None and s.use_class_loss:
        prob = torch.softmax(pred_logits.float(), dim=-1)
        labels = targets.labels.clamp(0, prob.shape[-1] - 1)
        cost_class = -torch.gather(prob, 2, labels[:, None, :].expand(b, q, n))
        cost = cost + s.class_weight * cost_class
    cost = cost.transpose(1, 2)                               # (B, N, Q)
    return torch.where(targets.valid[:, :, None], cost, torch.zeros((), device=cost.device))


def match(draw: Draw, pred_logits, pred_masks, targets: ClipTargets,
          s: CriterionSettings, tgt_t=None) -> torch.Tensor:
    """(B, N) int64 query index per target slot."""
    with torch.no_grad():
        cost = match_costs(draw, pred_logits, pred_masks, targets, s, tgt_t)
    return batched_hungarian(cost)


def process_draw(generator: torch.Generator, draw_points, device) -> Draw:
    """draw(batch, p) -> (batch, p, 2) points on ``device``: the global
    batch's points from ``generator``, of which this process keeps its
    slice."""
    rank, world = dist.rank(), dist.world()

    def draw(batch: int, p: int) -> torch.Tensor:
        pts = draw_points(generator, (batch * world,), p)
        return pts[rank * batch:(rank + 1) * batch].to(device)

    return draw


def tracking_match(
    generator: torch.Generator,
    pred_logits: Optional[torch.Tensor],  # (B, T, Q, C+1) per-frame logits
    pred_masks: torch.Tensor,             # (B, Q, T, H, W)
    targets: ClipTargets,
    s: CriterionSettings,
    draw_points=sorted_uniform_points,
) -> torch.Tensor:
    """``VideoHungarianTrackingMatcher`` (JAX ``criterion.py:222-296``): each
    target is matched in its first-appearance frame only, queries claimed in
    earlier frames excluded (cost + 1e6), and the assignment holds for every
    frame.  The per-frame costs come from one batched pass; then one
    Hungarian call a frame commits the rows that first appear in it.
    Returns (B, N) int64 query per slot."""
    b, q, t, h, w = pred_masks.shape
    n = targets.labels.shape[1]
    dev = pred_masks.device
    first = torch.argmax(targets.frame_valid.to(torch.int8), dim=-1)      # (B, N)
    th, tw = targets.masks.shape[-2:]
    tgt_bt = ClipTargets(
        labels=targets.labels[:, None].expand(b, t, n).reshape(b * t, n),
        masks=targets.masks.transpose(1, 2).reshape(b * t, n, 1, th, tw),
        valid=targets.valid[:, None].expand(b, t, n).reshape(b * t, n),
        frame_valid=torch.ones(b * t, n, 1, dtype=torch.bool, device=dev))
    logits_bt = None if pred_logits is None else pred_logits.reshape(b * t, q, -1)
    masks_bt = pred_masks.transpose(1, 2).reshape(b * t, q, 1, h, w)
    with torch.no_grad():
        cost = match_costs(process_draw(generator, draw_points, dev), logits_bt, masks_bt,
                           tgt_bt, s).view(b, t, n, q)
        assignment = torch.zeros(b, n, dtype=torch.int64, device=dev)
        used = torch.zeros(b, q, device=dev)
        for f in range(t):
            commit = targets.valid & (first == f)                           # (B, N)
            cost_f = torch.where(commit[:, :, None], cost[:, f] + used[:, None, :] * 1e6,
                                 torch.zeros((), device=dev))
            cols = batched_hungarian(cost_f)
            assignment = torch.where(commit, cols, assignment)
            hit = torch.zeros(b, q + 1, device=dev).scatter_add_(
                1, torch.where(commit, cols, q), torch.ones(b, n, device=dev))[:, :q]
            used = torch.clamp(used + hit, max=1.0)
    return assignment


def _class_targets(pred_logits: torch.Tensor, assignment: torch.Tensor,
                   targets: ClipTargets, s: CriterionSettings
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Q) target class of every query and its CE weight."""
    b, q, c1 = pred_logits.shape
    no_object = c1 - 1
    # matched queries get their target's class; invalid slots write into a
    # dropped column q
    tc = torch.full((b, q + 1), no_object, dtype=torch.int64, device=pred_logits.device)
    upd = torch.where(targets.valid, assignment, torch.full_like(assignment, q))
    tc = tc.scatter(1, upd, targets.labels.to(torch.int64))[:, :q]
    return tc, torch.where(tc == no_object, s.eos_coef, 1.0)


def _loss_labels(pred_logits: torch.Tensor, assignment: torch.Tensor,
                 targets: ClipTargets, s: CriterionSettings,
                 weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted CE over the classes, divided by ``weight_sum`` (default: the
    sum of this batch's weights)."""
    tc, wgt = _class_targets(pred_logits, assignment, targets, s)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, tc[..., None])[..., 0]
    return (wgt * nll).sum() / (wgt.sum() if weight_sum is None else weight_sum)


def _loss_masks(
    draw: Draw,
    pred_masks: torch.Tensor,     # (B, Q, T, H, W)
    assignment: torch.Tensor,     # (B, N)
    targets: ClipTargets,
    num_masks: torch.Tensor,
    s: CriterionSettings,
    tgt_t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-sampled sigmoid-CE and dice with uncertainty importance
    sampling; the candidate pool is shared by the rows of a batch item, the
    per-row selection is a threshold at the k-th most uncertain candidate."""
    b, q, t, h, w = pred_masks.shape
    n = targets.labels.shape[1]
    f32p = not s.bf16_sampling
    pred_masks = _sampling_masks(pred_masks, s)
    src = pred_masks[torch.arange(b, device=pred_masks.device)[:, None], assignment]
    rows = src.reshape(b, n * t, h, w)                        # (B, N*T, H, W)
    th, tw = targets.masks.shape[-2:]
    if tgt_t is None:
        tgt_t = target_rows_t(targets)
    row_w = targets.valid[:, :, None].expand(b, n, t).reshape(-1).float()

    def sample_tgt(c):
        with torch.no_grad():
            return sample_maps_shared_t(tgt_t, th, tw, c, f32_policy=f32p).float()

    n_sampled = int(s.num_points * s.oversample_ratio)
    n_uncertain = int(s.importance_sample_ratio * s.num_points)
    n_random = s.num_points - n_uncertain
    cand = draw(b, n_sampled)
    cand_logits = sample_maps_shared(rows, cand, f32_policy=f32p).float()  # (B, NT, S)
    cand_labels = sample_tgt(cand)
    key_unc = -cand_logits.detach().abs()
    if n_uncertain > 0:
        kth = kth_largest(key_unc, n_uncertain)[..., None]
        sel = (key_unc >= kth).float()
    else:
        sel = torch.zeros_like(key_unc)
    n_sel = sel.sum(-1)                                       # (B, NT)

    def losses_over(logits, labels, weight):
        ce = _softplus(logits) - logits * labels
        sig = torch.sigmoid(logits)
        return ((ce * weight).sum(-1), (sig * labels * weight).sum(-1),
                (sig * weight).sum(-1), (labels * weight).sum(-1))

    ce_s, num_s, sig_s, lab_s = losses_over(cand_logits, cand_labels, sel)
    if n_random > 0:
        rnd = draw(b, n_random)
        rnd_logits = sample_maps_shared(rows, rnd, f32_policy=f32p).float()
        rnd_labels = sample_tgt(rnd)
        ce_r, num_r, sig_r, lab_r = losses_over(rnd_logits, rnd_labels, 1.0)
        ce_s, num_s = ce_s + ce_r, num_s + num_r
        sig_s, lab_s = sig_s + sig_r, lab_s + lab_r
    total_pts = n_sel + n_random

    loss_mask = ((ce_s / total_pts).reshape(-1) * row_w).sum() / num_masks
    dice = 1.0 - (2.0 * num_s + 1.0) / (sig_s + lab_s + 1.0)
    loss_dice = (dice.reshape(-1) * row_w).sum() / num_masks
    return loss_mask, loss_dice


def num_masks_normalizer(targets: ClipTargets) -> torch.Tensor:
    """Valid-instance count of the global batch (summed over the processes),
    clamped >= 1."""
    return dist.all_reduce_sum(targets.valid.float().sum()).clamp(min=1.0)


def set_criterion(
    generator: torch.Generator,
    pred_logits_all: Optional[torch.Tensor],  # (L, B, Q, C+1) or None
    pred_masks_all: Sequence[torch.Tensor],   # (L, B, Q, T, H, W) or L such tensors
    targets: ClipTargets,
    s: CriterionSettings,
    draw_points=sorted_uniform_points,
    fixed_assignment: Optional[torch.Tensor] = None,  # (B, N), reused by every layer
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns ``(losses, last_assignment)``: losses ``loss_ce``,
    ``loss_mask``, ``loss_dice`` of shape (L,) and the scalar ``total``;
    layer L-1 is the final decoder output.  The layers' masks may differ in
    dtype when given as a sequence."""
    num_layers = len(pred_masks_all)
    b, n = targets.labels.shape
    dev = pred_masks_all[0].device
    draw = process_draw(generator, draw_points, dev)
    nm = num_masks_normalizer(targets)
    tgt_t = target_rows_t(targets)

    def layer_inputs(i):
        logits = None if pred_logits_all is None else pred_logits_all[i].float()
        return logits, pred_masks_all[i]

    if fixed_assignment is not None:
        assignments = fixed_assignment[None].expand(num_layers, b, n)
    else:
        # all layers' costs first, then one Hungarian call for the L*B problems
        with torch.no_grad():
            costs = [match_costs(draw, *layer_inputs(i), targets, s, tgt_t)
                     for i in range(num_layers)]
        assignments = batched_hungarian(torch.cat(costs)).view(num_layers, b, n)
    class_loss = pred_logits_all is not None and s.use_class_loss
    weight_sums = [None] * num_layers
    if class_loss and dist.initialized():
        # the global batch's CE weight sums, all layers in one reduction
        weight_sums = dist.all_reduce_sum(torch.stack(
            [_class_targets(layer_inputs(i)[0], assignments[i], targets, s)[1].sum()
             for i in range(num_layers)])).unbind()

    lcs, lms, lds = [], [], []
    for i in range(num_layers):
        logits, masks = layer_inputs(i)
        lm, ld = _loss_masks(draw, masks, assignments[i], targets, nm, s, tgt_t)
        if class_loss:
            lc = _loss_labels(logits, assignments[i], targets, s, weight_sums[i])
        else:
            lc = torch.zeros((), device=dev)
        lcs.append(lc)
        lms.append(lm)
        lds.append(ld)
    losses = {"loss_ce": torch.stack(lcs), "loss_mask": torch.stack(lms),
              "loss_dice": torch.stack(lds)}
    pick = (lambda v: v.sum()) if s.deep_supervision else (lambda v: v[-1])
    losses["total"] = (s.class_weight * pick(losses["loss_ce"])
                       + s.mask_weight * pick(losses["loss_mask"])
                       + s.dice_weight * pick(losses["loss_dice"]))
    return losses, assignments[-1]
