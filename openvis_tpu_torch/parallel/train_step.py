"""Optimizer and train step.

Port of ``openvis_tpu/parallel/train_step.py``:

  * ``label_params``: each parameter's group, by the JAX package's rules read
    off its flax path (``convert.flax_path``: the port's ``weight`` is flax's
    ``kernel`` or norm ``scale``, so a rule reading ``scale`` or ``bias``
    must see the flax name);
  * ``frozen`` parameters get ``requires_grad=False`` (``stop_frozen_gradients``),
    so they have no gradient and no share of the clip norm;
  * ``make_lr_schedule``: optax's warmup joined to a step schedule;
  * ``make_optimizer``: ``AdamW`` or ``SGD`` by ``solver.optimizer``, each
    optax's ``clip_by_global_norm`` (divides by the norm, not by norm + 1e-6
    as ``torch.nn.utils.clip_grad_norm_`` does) over all groups, then per
    group (backbone x0.1; weight decay 0 for norms, biases and embeddings)
    ``scale_by_adam`` -> ``add_decayed_weights`` -> ``-lr * multiplier``, or
    ``add_decayed_weights`` -> ``trace(decay=0.9)`` -> ``-lr * multiplier``
    (d2's SGD: L2 folded in before the momentum, no dampening, no Nesterov);
    the ``frozen`` group keeps no state and does not move;
  * ``TrainState``: the step, the f32 master parameters and the optimizer's
    state, with ``state_dict`` / ``load_state_dict`` for checkpoints;
  * ``TrainStep``: loss, gradients, their sum over the processes
    (``parallel/dist.py``), the global gradient norm (once), the update;
    returns the metrics of the global batch.

The update runs in place on the f32 master parameters.  Under a process group
each process computes its share of the global batch's loss (the criterion
normalises by global counts), so the gradients and the metrics are SUMMED over
the processes: the JAX step differentiates the global batch's loss
(``__graft_entry__.py:151-160``: N devices give the loss of 1).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import flax_path
from openvis_tpu_torch.parallel import dist


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


class _Optimizer:
    """What AdamW and SGD share: the group table of the non-frozen names
    (multiplier, weight decay), the learning-rate schedule read at the
    optimizer's own count, and the global-norm clip."""

    name = ""
    slots: Tuple[str, ...] = ()

    def __init__(self, cfg: Config, params: Dict[str, torch.Tensor], labels: Dict[str, str]):
        s = cfg.solver
        self.lr = make_lr_schedule(cfg)
        self.clip = s.clip_value if s.clip_gradients else None
        hyper = {
            "main": (1.0, s.weight_decay),
            "nodecay": (1.0, s.weight_decay_norm),
            "embed": (1.0, s.weight_decay_embed),
            "backbone": (s.backbone_multiplier, s.weight_decay),
            "backbone_nodecay": (s.backbone_multiplier, s.weight_decay_norm),
            "backbone_embed": (s.backbone_multiplier, s.weight_decay_embed),
        }
        self.hyper = {n: hyper[labels[n]] for n in params if labels[n] != "frozen"}
        for slot in self.slots:
            setattr(self, slot, {n: torch.zeros_like(params[n]) for n in self.hyper})
        self.count = 0

    def _clipped(self, grads: Dict[str, torch.Tensor],
                 grad_norm: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.clip is None:
            return grads
        g_norm = global_norm(grads.values()) if grad_norm is None else grad_norm
        keep = g_norm < self.clip
        return {n: torch.where(keep, g, (g / g_norm) * self.clip) for n, g in grads.items()}

    def state_dict(self) -> Dict:
        return {**{k: dict(getattr(self, k)) for k in self.slots}, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        saved = next((o.name for o in _OPTIMIZERS.values() if o.slots[0] in state), "no")
        if saved != self.name:
            raise ValueError(f"the checkpoint holds {saved} state; this run's optimizer is "
                             f"{self.name} (solver.optimizer)")
        for name in self.slots:
            mine, theirs = getattr(self, name), state[name]
            if set(mine) != set(theirs):
                raise KeyError(f"{self.name} {name}: {sorted(set(mine) ^ set(theirs))[:3]} differ")
            for n, t in mine.items():
                t.copy_(theirs[n])
        self.count = int(state["count"])


class AdamW(_Optimizer):
    """The JAX package's AdamW (``make_optimizer``) over named f32
    parameters; the frozen ones are left out."""

    name, slots = "adamw", ("mu", "nu")
    b1, b2, eps = 0.9, 0.999, 1e-8

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update in place.  ``grads`` holds every non-frozen name;
        ``grad_norm``: their global norm, if the caller has it."""
        grads = self._clipped(grads, grad_norm)
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


class SGD(_Optimizer):
    """The JAX package's SGD (``make_optimizer``, optax's
    ``add_decayed_weights`` -> ``trace(decay=0.9)`` per group): the trace
    t <- (g + wd * p) + 0.9 * t, so the first step's trace is the decayed
    gradient, then p <- p - lr(count) * multiplier * t."""

    name, slots = "sgd", ("trace",)
    momentum = 0.9

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update in place, as ``AdamW.step``."""
        grads = self._clipped(grads, grad_norm)
        lr = self.lr(self.count)
        self.count += 1
        for n, (mult, wd) in self.hyper.items():
            g, p, t = grads[n], params[n], self.trace[n]
            t.mul_(self.momentum).add_(g + wd * p if wd else g)
            p.add_(t, alpha=-(lr * mult))


_OPTIMIZERS = {"adamw": AdamW, "sgd": SGD}


def make_optimizer(cfg: Config, params: Dict[str, torch.Tensor],
                   labels: Dict[str, str]) -> _Optimizer:
    """``solver.optimizer``'s optimizer over ``params`` with the groups
    ``labels`` (JAX ``make_optimizer``)."""
    name = cfg.solver.optimizer.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(f"solver.optimizer={cfg.solver.optimizer!r}: expected 'adamw' or 'sgd'")
    return _OPTIMIZERS[name](cfg, params, labels)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s random stream: a function of (seed, step)
    only, as JAX's ``fold_in(rng, state.step)``, so a resumed run draws what
    an uninterrupted one draws."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class TrainState:
    """The step, the model's f32 master parameters (frozen ones included) and
    the optimizer's state; updated in place by the step."""

    def __init__(self, model: nn.Module, opt: _Optimizer, step: int = 0):
        self.model, self.opt, self.step = model, opt, step

    def state_dict(self) -> Dict:
        """References to the live tensors: copy before the next step."""
        return {"step": self.step,
                "params": {n: p.detach() for n, p in self.model.named_parameters()},
                **self.opt.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        params = dict(self.model.named_parameters())
        if set(params) != set(state["params"]):
            raise KeyError(f"params: {sorted(set(params) ^ set(state['params']))[:3]} differ")
        for n, p in params.items():
            p.copy_(state["params"][n])
        self.opt.load_state_dict(state)
        self.step = int(state["step"])


class TrainStep:
    """``step(batch, generator=None) -> metrics``: one update of ``state``.
    Without a generator the step's points come from a stream seeded by
    (``seed``, ``state.step``) on the parameters' device."""

    def __init__(self, loss_fn: Callable, state: TrainState, seed: int):
        self.loss_fn, self.state, self.seed = loss_fn, state, seed

    def __call__(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        model, opt = self.state.model, self.state.opt
        params = dict(model.named_parameters())
        if generator is None:
            dev = next(iter(params.values())).device
            generator = torch.Generator(device=dev).manual_seed(
                step_seed(self.seed, self.state.step))
        loss, metrics = self.loss_fn(params, batch, generator)
        names = list(opt.hyper)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
        keys = list(metrics)
        scalars = [loss.detach(), *(metrics[k].detach() for k in keys)]
        # one flat buffer: the gradients and the metrics summed over the
        # processes together
        *grads, scalars = dist.all_reduce_grads([*grads, torch.stack(scalars)])
        grads = dict(zip(names, grads))
        grad_norm = global_norm(grads.values())
        opt.step(params, grads, grad_norm)
        self.state.step += 1
        out = dict(zip(keys, scalars[1:]))
        out["total_loss"] = scalars[0]
        out["grad_norm"] = grad_norm
        return out
