"""Model assembly, the train step and the windowed video eval entry point.

Port of ``openvis_tpu/train.py`` for SimpleBaseline(Online), OpenVIS(Online),
SAN(Online), BriVIS, VideoMaskFormer, MinVIS, MasQCLIP and OV2Seg(Online):
``build_model`` (``:25``), the loss closure ``make_loss_fn`` with its AMP
rule (``:70-174``), the train step of
``openvis_tpu/parallel/train_step.py`` (``build_train_step``, one process or
one of several over ``torch.distributed``) and ``make_eval_fn``
(``:177-203``; OpenVISOnline evaluates through the engine's CLIP crops).  The
offline archs (the video decoder) train clip-level; offline SAN's loss raises
(``meta/san.py``), so it only evaluates.  BriVIS's loss
takes its assignment from the frozen image outputs or, with
``brivis_image_matcher=False`` (the second half of training), from the
resampler's last layer.  The train loss runs the forward inside
``swin.dropout_generator``: a Swin trunk's stochastic depth draws from the
step's generator there, and nowhere else (eval never enters it).

The entry points run on the card: ``device`` defaults to ``"cuda"``, and
without a CUDA device they raise unless the caller passes ``device="cpu"``
(the plain versions of the kernels).
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import flax_path
from openvis_tpu_torch.models.backbone.swin import dropout_generator
from openvis_tpu_torch.models.meta.brivis import BriVISModel, brivis_loss
from openvis_tpu_torch.models.meta.masqclip import (
    MasQCLIPModel,
    masqclip_eval_scores,
    masqclip_loss,
)
from openvis_tpu_torch.models.meta.openvis import OpenVISModel, openvis_loss
from openvis_tpu_torch.models.meta.ov2seg import OV2SegModel, ov2seg_loss
from openvis_tpu_torch.models.meta.san import SANModel, offline_san_loss_error, san_loss
from openvis_tpu_torch.models.meta.simple_baseline import (
    SimpleBaselineModel,
    eval_scores,
    simple_baseline_loss,
)
from openvis_tpu_torch.models.meta.video_maskformer import (
    VideoMaskFormerModel,
    video_maskformer_loss,
)
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.tracking import apply_track_indices, track_by_embeds
from openvis_tpu_torch.ops.point_sample import sorted_uniform_points
from openvis_tpu_torch.parallel.train_step import (
    TrainState,
    TrainStep,
    config_labels,
    make_optimizer,
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


# the architectures: their module and their loss (JAX ``train.py:25-60``, ``:70-113``)
_ARCHS = {"SimpleBaseline": (SimpleBaselineModel, simple_baseline_loss),
          "SimpleBaselineOnline": (SimpleBaselineModel, simple_baseline_loss),
          "OpenVIS": (OpenVISModel, openvis_loss),
          "OpenVISOnline": (OpenVISModel, openvis_loss),
          "SAN": (SANModel, san_loss),
          "SANOnline": (SANModel, san_loss),
          "BriVIS": (BriVISModel, brivis_loss),
          "VideoMaskFormer": (VideoMaskFormerModel, video_maskformer_loss),
          "MinVIS": (VideoMaskFormerModel, video_maskformer_loss),
          "MasQCLIP": (MasQCLIPModel, masqclip_loss),
          "OV2Seg": (OV2SegModel, ov2seg_loss),
          "OV2SegOnline": (OV2SegModel, ov2seg_loss)}


def check_arch(name: str) -> None:
    """Raise for a meta architecture that the JAX package does not have."""
    if name not in _ARCHS:
        raise ValueError(f"unknown meta architecture {name!r}")


class _NoInitDraws(torch.overrides.TorchFunctionMode):
    """Zeros where the convolutions and linear layers draw their default
    init (kaiming-uniform weights, uniform biases; on an 8-core CPU 3.7 s of
    the 3.9 s build of a Swin-B model with a ViT-L tower), which loading or
    ``convert.init_params`` overwrite.  Fills (norms, ``torch.zeros``)
    run."""

    DRAWS = (nn.init.kaiming_uniform_, nn.init.uniform_)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.DRAWS:  # nn.init's functions pass the tensor by name
            with torch.no_grad():
                return (args[0] if args else kwargs["tensor"]).zero_()
        return func(*args, **kwargs)


def build_model(cfg: Config, device="cuda") -> nn.Module:
    """The module for ``cfg`` on ``device`` with uninitialised parameters (the
    convolutions' and linear layers' zero): load them with
    ``convert.load_flax_params`` or draw them with ``convert.init_params``.
    The parameters are made on ``device``; tensors a module makes from numpy
    are moved after."""
    device = resolve_device(device)
    name = cfg.model.meta_architecture
    check_arch(name)
    with device, _NoInitDraws():
        model = _ARCHS[name][0](cfg.model)
    return model.to(device)


def eval_model(model: nn.Module) -> nn.Module:
    """``model`` as evaluation runs it: SAN and BriVIS without the aux
    layers' CLIP logits (a shallow copy sharing the parameters; JAX ``engine.py:315-317``)."""
    if getattr(model, "supervise_aux_logits", False):
        model = copy.copy(model)
        model.supervise_aux_logits = False
    return model


def is_online(cfg: Config) -> bool:
    return cfg.model.transformer_decoder.name.startswith(("frame", "side_adapter_frame"))


def _keeps_f32(path) -> bool:
    """The AMP rule's exception: a path component containing ``norm`` or
    starting with ``ln`` (norm scales and biases stay f32)."""
    return any("norm" in c.lower() or c.lower().startswith("ln") for c in path)


def make_loss_fn(cfg: Config, model: nn.Module, num_text_classes: int,
                 draw_points=sorted_uniform_points,
                 brivis_image_matcher: bool = True) -> Callable:
    """Returns loss_fn(params, batch, generator) -> (total, metrics).

    ``params`` maps the model's parameter names to f32 master tensors;
    ``batch`` holds ``pixels`` (B, T, H, W, 3), ``targets`` (ClipTargets)
    and ``text_feats`` (K, D).  Under ``solver.amp`` the frames run in bf16
    and every f32 parameter is cast to bf16 at use, except the norms'; the
    cast is differentiable, so the gradients come back f32.  Output tensors
    return to f32, except the mask-logit stack, which stays bf16 and is
    sampled under the f32 policy; other outputs pass through.  BriVIS's
    metrics add ``bc_loss`` and ``htm_loss``; ``brivis_image_matcher``
    picks its matcher's source.  Offline SAN raises
    (``meta.san.offline_san_loss_error``)."""
    name = cfg.model.meta_architecture
    check_arch(name)
    online = is_online(cfg)
    if name == "SAN" and not online:
        raise offline_san_loss_error()
    compute_losses = _ARCHS[name][1]
    extra_metrics = ()
    if name == "BriVIS":
        compute_losses = functools.partial(compute_losses, image_matcher=brivis_image_matcher)
        extra_metrics = ("bc_loss", "htm_loss")
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
        with dropout_generator(generator):
            out = torch.func.functional_call(model, apply, (frames, t, batch["text_feats"]))
        # the frame decoder's mask features feed BriVIS's resampler, no loss:
        # no f32 copy of them
        out = {k: (v.float() if isinstance(v, torch.Tensor) and k != "mask_feats"
                   and not (amp and "masks_all" in k) else v)
               for k, v in out.items()}
        losses = compute_losses(generator, out, batch["targets"], cfg.model,
                                num_text_classes, online, draw_points)
        metrics = {k: losses[k].sum()
                   for k in ("loss_ce", "loss_mask", "loss_dice", *extra_metrics)}
        return losses["total"], metrics

    return loss_fn


def build_train_step(cfg: Config, model: nn.Module, num_text_classes: int,
                     device="cuda", draw_points=sorted_uniform_points) -> TrainStep:
    """Returns step(batch, generator=None) -> metrics (``total_loss``,
    ``loss_ce``, ``loss_mask``, ``loss_dice``, ``grad_norm``; BriVIS's
    ``bc_loss`` and ``htm_loss``).

    The step's ``state`` (``TrainState``: the step count, the model's f32
    parameters as masters and the optimizer's state, AdamW or SGD by
    ``solver.optimizer``) is updated in place; frozen
    parameters get ``requires_grad=False`` and stay fixed.  Without a
    generator the points come from a stream seeded by (``cfg.seed``, step).
    Under a process group the batch is this process's slice of the global
    batch and the metrics are the global batch's.  The model is moved to
    ``device``; the batch must lie there too.  BriVIS's matcher takes the
    frozen image outputs; ``use_brivis_matcher`` switches it.  Offline SAN
    raises (``meta.san.offline_san_loss_error``) before anything moves."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(cfg, model, num_text_classes, draw_points)
    model.to(device).train()
    labels = config_labels(cfg, model)
    stop_frozen_gradients(model, labels)
    params = dict(model.named_parameters())
    bad = [n for n, p in params.items() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"the train step needs f32 master parameters, got {bad[:3]}")
    opt = make_optimizer(cfg, params, labels)
    return TrainStep(loss_fn, TrainState(model, opt), cfg.seed)


def use_brivis_matcher(step: TrainStep, cfg: Config, num_text_classes: int,
                       image_matcher: bool) -> None:
    """Switch a BriVIS step's matcher source: the frozen image outputs, or
    the resampler's last layer (JAX ``train_net.py:292-299``, from half of
    ``solver.max_iter``)."""
    step.loss_fn = make_loss_fn(cfg, step.state.model, num_text_classes,
                                brivis_image_matcher=image_matcher)


def make_eval_fn(cfg: Config, model: nn.Module) -> Callable:
    """Returns f(frames (T, H, W, 3), text_feats (K, D)) -> top-k dict for one
    video window (B = 1).  Runs on the model's device; the inputs are moved
    there.  The frame decoder (online) tracks by the query embeddings and
    averages the aligned logits over the frames; the video decoder (offline)
    scores its clip-level logits (offline SAN: its per-frame logits' mean).  BriVIS's decoder is the frame one, so it
    takes the online branch, as in the JAX package.  OV2Seg's window goes
    through the engine's post-process (``engine.ov2seg_topk``: padded to
    ``_bucket(T)``, the EMA tracker, the gated scores); the JAX package's
    ``make_eval_fn`` cannot run it (its ``is_online`` reads ``ov2seg_frame``
    as a video decoder).  MasQCLIP's clip scores are the engine's single
    shot's, ``masqclip_eval_scores`` (the JAX package's ``make_eval_fn``
    would score its proposal logits)."""
    topk = cfg.model.test.topk_per_video
    online = is_online(cfg)
    model = eval_model(model)
    if cfg.model.meta_architecture.startswith("OV2Seg"):
        from openvis_tpu_torch import engine  # it imports this module

        @torch.inference_mode()
        def ov2seg_fn(frames: torch.Tensor, text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
            dev = _model_device(model)
            frames, text_feats = frames.to(dev), text_feats.to(dev)
            out = model(frames, frames.shape[0], text_feats)
            return engine.ov2seg_topk(out["pred_logits"][0], out["pred_masks"][0],
                                      out["pred_embeds"][0], out["pred_object_logits"][0], topk)

        return ov2seg_fn

    @torch.inference_mode()
    def eval_fn(frames: torch.Tensor, text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        dev = _model_device(model)
        frames, text_feats = frames.to(dev), text_feats.to(dev)
        t = frames.shape[0]
        out = model(frames, t, text_feats)
        if cfg.model.meta_architecture == "MasQCLIP":
            return inference_video_topk(masqclip_eval_scores(out)[0],
                                        out["pred_masks"][0], topk)
        if not online:
            # clip-level logits (B, Q, C); SAN's video decoder gives per-frame
            # CLIP logits (B, T, Q, C): their mean over the frames
            logits = out["pred_logits"]
            scores = eval_scores(logits, online=logits.dim() == 4)[0]     # (Q, K)
            return inference_video_topk(scores, out["pred_masks"][0], topk)
        # align logits only; masks are aligned inside the top-k gather
        indices = track_by_embeds(out["pred_embeds"])
        logits = apply_track_indices(out["pred_logits"], indices)
        scores = eval_scores(logits)[0]                        # (Q, K)
        return inference_video_topk(scores, out["pred_masks"][0], topk,
                                    track_indices=indices[0])

    return eval_fn
