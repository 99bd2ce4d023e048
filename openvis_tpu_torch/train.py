"""Model assembly, the train step and the windowed video eval entry point.

Port of ``openvis_tpu/train.py`` for SimpleBaseline(Online): ``build_model``
(``:25``), the loss closure ``make_loss_fn`` with its AMP rule (``:70-174``),
the train step of ``openvis_tpu/parallel/train_step.py`` (``build_train_step``,
one process or one of several over ``torch.distributed``)
and ``make_eval_fn`` (``:177-203``).

The entry points run on the card: ``device`` defaults to ``"cuda"``, and
without a CUDA device they raise unless the caller passes ``device="cpu"``
(the plain versions of the kernels).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import flax_path
from openvis_tpu_torch.models.meta.simple_baseline import (
    SimpleBaselineModel,
    eval_scores,
    simple_baseline_loss,
)
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.parallel.train_step import (
    AdamW,
    TrainState,
    TrainStep,
    config_labels,
    stop_frozen_gradients,
)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to "
            "run the plain versions of its kernels on the CPU"
        )
    return device


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def build_model(cfg: Config, device="cuda") -> SimpleBaselineModel:
    """The module for ``cfg`` on ``device`` with zero-filled parameters: load
    them with ``convert.load_flax_params`` or draw them with
    ``convert.init_params``."""
    device = resolve_device(device)
    name = cfg.model.meta_architecture
    if name in ("SimpleBaseline", "SimpleBaselineOnline"):
        return SimpleBaselineModel(cfg.model).to(device)
    raise NotImplementedError(
        f"meta architecture {name!r} is not ported yet (ROADMAP.md, queue 1)"
    )


def is_online(cfg: Config) -> bool:
    return cfg.model.transformer_decoder.name.startswith(("frame", "side_adapter_frame"))


def _keeps_f32(path) -> bool:
    """The AMP rule's exception: a path component containing ``norm`` or
    starting with ``ln`` (norm scales and biases stay f32)."""
    return any("norm" in c.lower() or c.lower().startswith("ln") for c in path)


def make_loss_fn(cfg: Config, model: SimpleBaselineModel, num_text_classes: int,
                 draw_points=sorted_uniform_points) -> Callable:
    """Returns loss_fn(params, batch, generator) -> (total, metrics).

    ``params`` maps the model's parameter names to f32 master tensors;
    ``batch`` holds ``pixels`` (B, T, H, W, 3), ``targets`` (ClipTargets)
    and ``text_feats`` (K, D).  Under ``solver.amp`` the frames run in bf16
    and every f32 parameter is cast to bf16 at use, except the norms'; the
    cast is differentiable, so the gradients come back f32.  Outputs return
    to f32, except the mask-logit stack, which stays bf16 and is sampled
    under the f32 policy."""
    name = cfg.model.meta_architecture
    if name not in ("SimpleBaseline", "SimpleBaselineOnline"):
        raise NotImplementedError(f"the {name!r} loss is not ported yet (ROADMAP.md)")
    online = is_online(cfg)
    amp = cfg.solver.amp
    to_bf16 = {n for n, p in model.named_parameters()
               if p.dtype == torch.float32 and not _keeps_f32(flax_path(n, p.dim()))}

    def loss_fn(params: Dict[str, torch.Tensor], batch, generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pixels = batch["pixels"]
        b, t, h, w, _ = pixels.shape
        frames = pixels.reshape(b * t, h, w, 3)
        apply = params
        if amp:
            frames = frames.to(torch.bfloat16)
            apply = {n: (p.to(torch.bfloat16) if n in to_bf16 else p)
                     for n, p in params.items()}
        out = torch.func.functional_call(model, apply, (frames, t, batch["text_feats"]))
        out = {k: (v if (amp and "masks_all" in k) else v.float())
               for k, v in out.items()}
        losses = simple_baseline_loss(generator, out, batch["targets"], cfg.model,
                                      num_text_classes, online, draw_points)
        metrics = {k: losses[k].sum() for k in ("loss_ce", "loss_mask", "loss_dice")}
        return losses["total"], metrics

    return loss_fn


def build_train_step(cfg: Config, model: SimpleBaselineModel, num_text_classes: int,
                     device="cuda", draw_points=sorted_uniform_points) -> TrainStep:
    """Returns step(batch, generator=None) -> metrics (``total_loss``,
    ``loss_ce``, ``loss_mask``, ``loss_dice``, ``grad_norm``).

    The step's ``state`` (``TrainState``: the step count, the model's f32
    parameters as masters and the AdamW state) is updated in place; frozen
    parameters get ``requires_grad=False`` and stay fixed.  Without a
    generator the points come from a stream seeded by (``cfg.seed``, step).
    Under a process group the batch is this process's slice of the global
    batch and the metrics are the global batch's.  The model is moved to
    ``device``; the batch must lie there too."""
    device = resolve_device(device)
    model.to(device).train()
    labels = config_labels(cfg, model)
    stop_frozen_gradients(model, labels)
    params = dict(model.named_parameters())
    bad = [n for n, p in params.items() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"the train step needs f32 master parameters, got {bad[:3]}")
    opt = AdamW(cfg, params, labels)
    loss_fn = make_loss_fn(cfg, model, num_text_classes, draw_points)
    return TrainStep(loss_fn, TrainState(model, opt), cfg.seed)


def make_eval_fn(cfg: Config, model: SimpleBaselineModel) -> Callable:
    """Returns f(frames (T, H, W, 3), text_feats (K, D)) -> top-k dict for one
    video window (B = 1).  Runs on the model's device; the inputs are moved
    there.  Online (frame-decoder) eval: ``build_model`` refuses the video
    decoder."""
    topk = cfg.model.test.topk_per_video

    @torch.inference_mode()
    def eval_fn(frames: torch.Tensor, text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        dev = _model_device(model)
        frames, text_feats = frames.to(dev), text_feats.to(dev)
        t = frames.shape[0]
        out = model(frames, t, text_feats)
        # align logits only; masks are aligned inside the top-k gather
        indices = track_by_embeds(out["pred_embeds"])
        logits = apply_track_indices(out["pred_logits"], indices)
        scores = eval_scores(logits)[0]                        # (Q, K)
        return inference_video_topk(scores, out["pred_masks"][0], topk,
                                    track_indices=indices[0])

    return eval_fn
