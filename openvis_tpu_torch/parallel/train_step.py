"""Optimizer and train step.

Port of ``openvis_tpu/parallel/train_step.py`` for one process:

  * ``label_params``: each parameter's group, by the JAX package's rules read
    off its flax path (``convert.flax_path``: the port's ``weight`` is flax's
    ``kernel`` or norm ``scale``, so a rule reading ``scale`` or ``bias``
    must see the flax name);
  * ``frozen`` parameters get ``requires_grad=False`` (``stop_frozen_gradients``),
    so they have no gradient and no share of the clip norm;
  * ``make_lr_schedule``: optax's warmup joined to a step schedule;
  * ``AdamW``: optax's ``clip_by_global_norm`` (divides by the norm, not by
    norm + 1e-6 as ``torch.nn.utils.clip_grad_norm_`` does), then per group
    ``scale_by_adam`` -> ``add_decayed_weights`` -> ``-lr * multiplier``
    (backbone x0.1; weight decay 0 for norms, biases and embeddings);
  * ``make_train_step``: loss, gradients, update; returns the metrics.

The update runs in place on the f32 master parameters.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import flax_path


def _backbone_stage(segment: str) -> Optional[int]:
    if segment.startswith(("stem", "patch_embed", "patch_norm", "ape")):
        return 1
    m = re.match(r"res(\d)_", segment)
    if m:
        return int(m.group(1))
    m = re.match(r"(?:stage|downsample|out_norm)(\d+)", segment)
    if m:
        return int(m.group(1)) + 2
    return None


def label_path(path: str, freeze_prefixes=(), freeze_at: int = 0) -> str:
    """The group of the parameter at flax ``path`` ("a/b/kernel"), by the
    rules of ``openvis_tpu/parallel/train_step.py::label_params``."""
    p = path.lower()
    last = p.split("/")[-1]
    for pref in freeze_prefixes:
        if p.startswith(pref.lower()):
            return "frozen"
    if "clip_adapter/visual/" in f"/{p}/":
        return "frozen"
    in_backbone = "/backbone/" in f"/{p}/"
    if freeze_at > 0 and in_backbone:
        stage = _backbone_stage(p.split("backbone/", 1)[1].split("/", 1)[0])
        if stage is not None and stage <= freeze_at:
            return "frozen"
    frozen_affine = "norm" in p and ("scale" in last or last == "bias")
    if in_backbone and frozen_affine:
        return "frozen"
    embed = ("embedding" in p or "embed" in last
             or last in ("query_feat", "query_embed", "level_embed",
                         "positional_embedding", "class_embedding", "logit_scale",
                         "non_object_embedding", "relative_position_bias_table"))
    nodecay = p.endswith("bias") or "scale" in last or "/ln" in p or "layernorm" in p
    if in_backbone:
        if embed:
            return "backbone_embed"
        return "backbone_nodecay" if nodecay else "backbone"
    if embed:
        return "embed"
    return "nodecay" if nodecay else "main"


def label_params(named: Iterable[Tuple[str, torch.Tensor]], freeze_prefixes=(),
                 freeze_at: int = 0) -> Dict[str, str]:
    """{port parameter name: group} for (name, tensor) pairs."""
    return {name: label_path("/".join(flax_path(name, t.dim())), freeze_prefixes, freeze_at)
            for name, t in named}


def config_labels(cfg: Config, model: nn.Module) -> Dict[str, str]:
    freeze_prefixes = ("segmenter", "clip_adapter") if cfg.model.freeze_segmenter else ()
    return label_params(model.named_parameters(), freeze_prefixes,
                        freeze_at=cfg.model.backbone.freeze_at)


def stop_frozen_gradients(model: nn.Module, labels: Dict[str, str]) -> None:
    """``requires_grad=False`` on every 'frozen' parameter."""
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """optax ``join_schedules([linear warmup, piecewise constant])``: the
    step schedule counts from the end of the warmup."""
    s = cfg.solver

    def base(step: int) -> float:
        v = s.base_lr
        for b in sorted(int(x) for x in s.steps):
            if step >= b:
                v *= s.gamma
        return v

    if s.warmup_iters > 0 and s.warmup_factor < 1.0:
        start = s.base_lr * s.warmup_factor

        def schedule(step: int) -> float:
            if step < s.warmup_iters:
                return start + (s.base_lr - start) * step / s.warmup_iters
            return base(step - s.warmup_iters)

        return schedule
    return base


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class AdamW:
    """The JAX package's optimizer (``make_optimizer``) over named f32
    parameters; the frozen ones are left out."""

    def __init__(self, cfg: Config, params: Dict[str, torch.Tensor], labels: Dict[str, str]):
        s = cfg.solver
        if s.optimizer.lower() != "adamw":
            raise NotImplementedError(f"solver.optimizer={s.optimizer!r} is not ported yet")
        self.lr = make_lr_schedule(cfg)
        self.clip = s.clip_value if s.clip_gradients else None
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        hyper = {
            "main": (1.0, s.weight_decay),
            "nodecay": (1.0, s.weight_decay_norm),
            "embed": (1.0, s.weight_decay_embed),
            "backbone": (s.backbone_multiplier, s.weight_decay),
            "backbone_nodecay": (s.backbone_multiplier, s.weight_decay_norm),
            "backbone_embed": (s.backbone_multiplier, s.weight_decay_embed),
        }
        self.hyper = {n: hyper[labels[n]] for n in params if labels[n] != "frozen"}
        self.mu = {n: torch.zeros_like(params[n]) for n in self.hyper}
        self.nu = {n: torch.zeros_like(params[n]) for n in self.hyper}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        """One update in place.  ``grads`` holds every non-frozen name."""
        if self.clip is not None:
            g_norm = global_norm(grads.values())
            keep = g_norm < self.clip
            grads = {n: torch.where(keep, g, (g / g_norm) * self.clip)
                     for n, g in grads.items()}
        lr = self.lr(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for n, (mult, wd) in self.hyper.items():
            g, p = grads[n], params[n]
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if wd:
                u = u + wd * p
            p.add_(u, alpha=-(lr * mult))


def make_train_step(loss_fn: Callable, model: nn.Module, opt: AdamW) -> Callable:
    """loss_fn(params, batch, generator) -> (total_loss, metrics).  The step
    returns the metrics with ``total_loss`` and the pre-clip ``grad_norm``."""

    def step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(params, batch, generator)
        names = list(opt.hyper)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                 for n, g in zip(names, grads)}
        grad_norm = global_norm(grads.values())
        opt.step(params, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return step
