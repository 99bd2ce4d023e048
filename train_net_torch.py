#!/usr/bin/env python
"""Training and evaluation CLI of the PyTorch port (``openvis_tpu_torch``).

Port of ``train_net.py`` (the JAX CLI): the same flags and flow, on one card,
on the CPU (``--device cpu``) or on N processes over ``torch.distributed``
(one process a card, NCCL; gloo on the CPU).

  * pretrained init from ``model.weights``: a checkpoint directory of the
    port (its subtrees grafted: BriVIS's stage 2 takes ``segmenter`` and
    ``clip_adapter`` from a SANOnline run), a reference Mask2Former
    checkpoint (``.pkl``/``.pth``/``.pt``) or the JAX package's flax
    ``.msgpack`` (``tools/convert_weights.py m2f``), both into ``segmenter``;
  * training from ``datasets.train`` (``TrainLoader``; BriVIS's matcher
    switches from the frozen image outputs to the resampler at half of
    ``solver.max_iter``, as ``train_net.py:292-299``), a checkpoint every
    ``solver.checkpoint_period`` steps and at the end, ``metrics.jsonl``
    (``StepTimer``); ``--resume`` restores the latest checkpoint of
    ``--weights`` (default ``<output_dir>/checkpoints``);
  * ``--eval-only`` evaluates ``datasets.test`` from ``--weights`` (a
    checkpoint directory, a reference checkpoint into ``segmenter`` or a flax
    ``.msgpack`` over the whole model) and writes
    ``metrics_<dataset>.json`` beside the engine's ``results_<dataset>.json``;
  * only rank 0 writes checkpoints and metrics; the other processes wait at a
    barrier.

The offline (clip-level) recipes train and evaluate as the online ones:
``simplebsl_R50_bs8_12000st.yaml`` (the video decoder, clip-level loss,
single-shot eval through the CLIP ensemble), the two ``openvis_R50_bs16_6000st.yaml``
(evaluated single-shot on the objectness; the tower is still read, as the
JAX CLI reads it) and, ``--eval-only``, ``san_R50_bs16_6000st.yaml``: offline
SAN's train step raises (``models/meta/san.py``), and ``--weights`` may name a
SANOnline run's checkpoints, whose parameter tree is the same.

The text bank (``build_text_bank``), SAN's frozen tower
(``model.clip_adapter.visual``) and, for the SimpleBaseline CLIP ensemble, the
frozen CLIP visual tower of OpenVIS's mask-crop scoring and of the SimpleBaseline CLIP
ensemble come from ``model.clip_adapter.weights`` (a local OpenAI CLIP
``.pt``: a JIT archive or a state dict; or the JAX package's converted
``.msgpack``) and ``bpe_vocab`` (a local ``bpe_simple_vocab_16e6.txt.gz``).

Usage:
  python train_net_torch.py --config-file configs/openvoc_ytvis_coco/simplebsl_online_R50_bs8_12000st.yaml
  python train_net_torch.py --config-file ... --resume
  python train_net_torch.py --config-file ... --eval-only --weights output/checkpoints
  python train_net_torch.py --config-file ... --device cpu solver.max_iter=100  # overrides
  torchrun --nproc-per-node 8 train_net_torch.py --distributed --config-file ...
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time

import torch

from openvis_tpu_torch import engine
from openvis_tpu_torch.checkpoint import (
    load_params_from_checkpoint,
    merge_pretrained,
    restore_checkpoint,
    save_checkpoint,
)
from openvis_tpu_torch.clip_towers import build_clip_visual
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params, params_from_flax
from openvis_tpu_torch.data import catalog
from openvis_tpu_torch.data.loader import TrainLoader
from openvis_tpu_torch.models.clip.build import build_clip_params
from openvis_tpu_torch.models.clip.model import text_tower
from openvis_tpu_torch.models.clip.prompts import get_templates
from openvis_tpu_torch.models.clip.text_bank import TextEmbeddingBank
from openvis_tpu_torch.models.clip.tokenizer import SimpleTokenizer
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.train import (
    build_model,
    build_train_step,
    resolve_device,
    use_brivis_matcher,
)
from openvis_tpu_torch.utils.flax_msgpack import read_msgpack
from openvis_tpu_torch.utils.profiling import StepTimer, trace
from openvis_tpu_torch.weights import segmenter_state

logger = logging.getLogger("openvis_tpu_torch")

LOG_PERIOD = 20  # steps between metrics.jsonl flushes (train_net.py's log period)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--weights", default="",
                   help="a checkpoint directory of the port, a reference .pkl/.pth/.pt or "
                        "a flax .msgpack of the JAX package")
    p.add_argument("--max-videos", type=int, default=None, help="eval video cap")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of train steps 10-12 here")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group (torchrun's environment "
                        "or the flags below)")
    p.add_argument("--coordinator", default="", help="rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("opts", nargs="*", help="dotted config overrides a.b=c")
    return p.parse_args(argv)


def read_clip(cfg):
    """The CLIP checkpoint ``model.clip_adapter.weights`` as the tree
    ``{visual, text, logit_scale}``."""
    ca = cfg.model.clip_adapter
    if not ca.weights:
        raise SystemExit("model.clip_adapter.weights must point to a CLIP checkpoint (.pt: "
                         "an OpenAI JIT archive or a state dict)")
    return build_clip_params(ca.weights)


def build_text_bank(cfg, device, clip_tree=None) -> TextEmbeddingBank:
    """The prompt-ensembled text bank of ``clip_adapter`` on ``device`` (JAX
    ``train_net.py:64-87``), from ``clip_tree`` (``read_clip``'s) or the
    checkpoint."""
    ca = cfg.model.clip_adapter
    text = (clip_tree or read_clip(cfg))["text"]
    vocab = text["token_embedding"]["embedding"].shape[0]
    enc = text_tower(ca.clip_model_name, vocab, text["positional_embedding"].shape[0])
    enc.load_state_dict(params_from_flax(text), strict=True)
    templates = get_templates(ca.prompt_name, ca.predefined_templates)
    return TextEmbeddingBank(enc, SimpleTokenizer(ca.bpe_vocab), templates, device)


def _load_into(model, pretrained, subtree: str = "") -> None:
    params = {n: p.detach() for n, p in model.named_parameters()}
    model.load_state_dict(merge_pretrained(params, pretrained, subtree), strict=True)


def load_flax_tree(model, path: str, subtree: str = "") -> None:
    """The flax ``.msgpack`` ``path`` over the model's parameters, under
    ``subtree``: the keys the model has override, the others are left out
    (logged; flax's apply leaves them out too), a misshapen key raises, and a
    tree that holds none of the model's tensors is refused."""
    prefix = f"{subtree}." if subtree else ""
    state = params_from_flax(read_msgpack(path))
    names = {n for n, _ in model.named_parameters()}
    known = {k: v for k, v in state.items() if prefix + k in names}
    if not known:
        raise SystemExit(f"{path}: no tensor of this flax tree is the model's "
                         f"{subtree or 'top level'} — refusing to run on random params")
    if len(known) < len(state):
        left = sorted(set(state) - set(known))
        logger.warning("%d tensors of the tree are not the model's, left out: %s%s",
                       len(left), left[:5], " ..." if len(left) > 5 else "")
    _load_into(model, known, subtree)
    logger.info("loaded %d tensors of the flax tree %s into %s", len(known), path,
                subtree or "the model")


def load_weights_file(model, path: str, cfg) -> None:
    """``--weights`` naming a file: a flax ``.msgpack`` over the whole model
    (JAX ``train_net.py:223-231``) or a reference Mask2Former checkpoint into
    ``segmenter``."""
    if path.endswith(".msgpack"):
        load_flax_tree(model, path)
        return
    _load_into(model, segmenter_state(path, cfg), "segmenter")
    logger.info("loaded reference weights from %s", path)


def pretrained_init(cfg, model) -> None:
    """``model.weights``: a port checkpoint directory (its subtrees that the
    model has are grafted), a reference Mask2Former checkpoint or a flax
    ``.msgpack`` of the JAX package (both into ``segmenter``, JAX
    ``train_net.py:207-212``).  A ``.msgpack`` that does not exist (BriVIS's
    recipe default, which neither CLI writes) raises."""
    w = cfg.model.weights
    if w and w.endswith(".msgpack"):
        if not os.path.isfile(w):
            raise SystemExit(
                f"model.weights={w}: no such flax .msgpack (the JAX package's converted "
                "weights). Set model.weights to a checkpoint directory of the port (e.g. a "
                "SANOnline run's <output_dir>/checkpoints for BriVIS's stage 2), a reference "
                ".pkl/.pth or an existing .msgpack")
        load_flax_tree(model, w, "segmenter")
    elif w and os.path.isdir(w):
        pre = load_params_from_checkpoint(w)
        if pre is None:
            raise SystemExit(f"model.weights dir {w} has no checkpoint")
        tops = {n.split(".", 1)[0] for n, _ in model.named_parameters()}
        graft = {k: v for k, v in pre.items() if k.split(".", 1)[0] in tops}
        _load_into(model, graft)
        logger.info("grafted %s from checkpoint %s",
                    sorted({k.split(".", 1)[0] for k in graft}), w)
    elif w and os.path.exists(w):
        _load_into(model, segmenter_state(w, cfg), "segmenter")
        logger.info("loaded pretrained segmenter init from %s", w)


def load_clip_visual(model, clip_tree) -> None:
    """SAN's frozen tower ``clip_adapter.visual`` from the CLIP checkpoint (JAX
    ``train_net.py:213-218``)."""
    model.clip_adapter.visual.load_state_dict(params_from_flax(clip_tree["visual"]), strict=True)
    logger.info("loaded the CLIP visual weights into clip_adapter.visual")


def evaluate(args, cfg, model, bank, device, ckpt_dir) -> None:
    arch = cfg.model.meta_architecture
    clip_visual_apply = None
    # the frozen CLIP visual tower of the mask-crop paths (train_net.py:246-277)
    if arch.startswith("OpenVIS") or (cfg.model.clip_adapter.clip_ensemble
                                      and arch.startswith("SimpleBaseline")):
        if not cfg.model.clip_adapter.weights:
            raise SystemExit(
                "this eval needs the frozen CLIP visual tower (OpenVIS mask-crop scoring / "
                "SimpleBaseline clip_ensemble): set model.clip_adapter.weights to a CLIP "
                "checkpoint, or disable model.clip_adapter.clip_ensemble")
        clip_visual_apply = build_clip_visual(cfg, device)
    src = args.weights or ckpt_dir
    if os.path.isfile(src):
        load_weights_file(model, src, cfg)
    else:
        params = load_params_from_checkpoint(src)
        if params is not None:
            model.load_state_dict(params, strict=True)
            logger.info("loaded checkpoint params for eval from %s", src)
        elif args.weights:
            raise SystemExit(f"--eval-only --weights {src}: no checkpoint found (expected a "
                             "checkpoint dir, a reference .pkl/.pth/.pt or a .msgpack) — "
                             "refusing to evaluate random params")
    all_ok = True
    for ds in cfg.datasets.test:
        names = list(catalog.get(ds).thing_classes)
        metrics = engine.evaluate_dataset(cfg, model, ds, bank.encode(names), args.max_videos,
                                          clip_visual_apply=clip_visual_apply, device=device)
        if dist.rank() == 0:
            logger.info("%s: %s", ds, json.dumps(metrics))
            with open(os.path.join(cfg.output_dir, f"metrics_{ds}.json"), "w") as f:
                json.dump(metrics, f)
            all_ok &= engine.verify_expected_results(cfg.model.test.expected_results, ds,
                                                     metrics)
    if not all_ok:  # reference verify_results (train_net.py:295)
        raise SystemExit("evaluation results differ from expected_results")


def train(args, cfg, model, text_feats, device, ckpt_dir) -> None:
    solver = cfg.solver
    step = build_train_step(cfg, model, text_feats.shape[0], device)
    if args.resume:
        src = args.weights or ckpt_dir
        if os.path.isfile(src):
            load_weights_file(model, src, cfg)
        elif restore_checkpoint(src, step.state) is not None:
            logger.info("resumed at step %d", step.state.step)
    rank = dist.rank()
    # each process loads its slice of the global batch, from its own seed
    loader_cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        solver, ims_per_batch=dist.per_process_batch(solver.ims_per_batch)))
    loader = TrainLoader(loader_cfg, seed=cfg.seed + rank, device=device)
    text = text_feats.to(device)
    timer = StepTimer(os.path.join(cfg.output_dir, "metrics.jsonl") if rank == 0 else None,
                      device)
    start = step.state.step
    brivis = cfg.model.meta_architecture == "BriVIS"
    # a trace of steady steps (past the warm-up) when the run is long enough
    trace_at = start + (10 if solver.max_iter - start > 13 else 0)
    tracing = contextlib.ExitStack()
    try:
        for it in range(start, solver.max_iter):
            if args.profile_dir and it == trace_at:
                tracing.enter_context(trace(args.profile_dir, device, f"trace_rank{rank}"))
            if it == trace_at + 3:
                tracing.close()
            if brivis and it == max(start, solver.max_iter // 2):
                # the matcher's source from half of training on
                use_brivis_matcher(step, cfg, text_feats.shape[0], image_matcher=False)
                logger.info("BriVIS matcher: the resampler's last layer from step %d", it)
            t0 = time.perf_counter()
            batch = next(loader)
            wait = time.perf_counter() - t0
            batch["text_feats"] = text
            timer.start()
            metrics = step(batch)
            timer.tick(it + 1, metrics, wait)
            done = it + 1
            save = done % solver.checkpoint_period == 0 or done == solver.max_iter
            if done % LOG_PERIOD == 0 or save:
                recs = timer.flush()
                logger.info("iter %d: %s", done, json.dumps(recs[-1]))
            if save:
                if rank == 0:
                    t0 = time.perf_counter()
                    path = save_checkpoint(ckpt_dir, done, step.state.state_dict())
                    logger.info("saved checkpoint at %d (%.3f s, %d bytes)", done,
                                time.perf_counter() - t0, os.path.getsize(path))
                dist.barrier()
    finally:
        tracing.close()
        timer.close()
        loader.close()


def run(args, device) -> None:
    cfg = load_config(args.config_file, args.opts)
    if dist.rank() == 0:
        os.makedirs(cfg.output_dir, exist_ok=True)
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    # class names of the training taxonomy (simplebsl.py:50-57)
    class_names = list(catalog.get(cfg.datasets.train[0]).thing_classes)
    clip_tree = read_clip(cfg)
    bank = build_text_bank(cfg, device, clip_tree)
    model = init_params(build_model(cfg, device), seed=cfg.seed)
    pretrained_init(cfg, model)
    if hasattr(model, "clip_adapter"):
        load_clip_visual(model, clip_tree)
    del clip_tree
    if args.eval_only:
        evaluate(args, cfg, model, bank, device, ckpt_dir)
    else:
        text_feats = torch.as_tensor(bank.encode(class_names), dtype=torch.float32)
        train(args, cfg, model, text_feats, device, ckpt_dir)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    joined = args.distributed or bool(args.coordinator)
    if joined:
        dist.init_distributed(args.coordinator or None, args.num_processes, args.process_id,
                              device)
    try:
        run(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
