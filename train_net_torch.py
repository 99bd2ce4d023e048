#!/usr/bin/env python
"""Training and evaluation CLI of the PyTorch port (``openvis_tpu_torch``).

Port of ``train_net.py`` (the JAX CLI): the same flags and flow, on one card,
on the CPU (``--device cpu``) or on N processes over ``torch.distributed``
(one process a card, NCCL; gloo on the CPU).

  * pretrained init from ``model.weights``: a checkpoint directory of the
    port (its subtrees grafted) or a reference Mask2Former checkpoint
    (``.pkl``/``.pth``/``.pt``, into ``segmenter``);
  * training from ``datasets.train`` (``TrainLoader``), a checkpoint every
    ``solver.checkpoint_period`` steps and at the end, ``metrics.jsonl``
    (``StepTimer``); ``--resume`` restores the latest checkpoint of
    ``--weights`` (default ``<output_dir>/checkpoints``);
  * ``--eval-only`` evaluates ``datasets.test`` from ``--weights`` (a
    checkpoint directory or a reference checkpoint) and writes
    ``metrics_<dataset>.json`` beside the engine's ``results_<dataset>.json``;
  * only rank 0 writes checkpoints and metrics; the other processes wait at a
    barrier.

The text bank needs the CLIP text tower, which is not ported yet
(``build_text_bank`` raises; tests replace it).

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
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog
from openvis_tpu_torch.data.loader import TrainLoader
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.train import build_model, build_train_step, resolve_device
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
                   help="a checkpoint directory of the port or a reference .pkl/.pth/.pt")
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


def build_text_bank(cfg):
    raise NotImplementedError(
        "the CLIP text tower and its text bank are not ported yet (ROADMAP.md, queue 1 item 4)")


def _load_into(model, pretrained, subtree: str = "") -> None:
    params = {n: p.detach() for n, p in model.named_parameters()}
    model.load_state_dict(merge_pretrained(params, pretrained, subtree), strict=True)


def pretrained_init(cfg, model) -> None:
    """``model.weights``: a port checkpoint directory (its subtrees that the
    model has are grafted) or a reference Mask2Former checkpoint (into
    ``segmenter``)."""
    w = cfg.model.weights
    if w and os.path.isdir(w):
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


def evaluate(args, cfg, model, bank, device, ckpt_dir) -> None:
    arch = cfg.model.meta_architecture
    if arch.startswith("OpenVIS") or (cfg.model.clip_adapter.clip_ensemble
                                      and arch.startswith("SimpleBaseline")):
        engine.build_clip_visual(cfg)  # raises: not ported yet
    src = args.weights or ckpt_dir
    if os.path.isfile(src):
        _load_into(model, segmenter_state(src, cfg), "segmenter")
        logger.info("loaded reference weights for eval from %s", src)
    else:
        params = load_params_from_checkpoint(src)
        if params is not None:
            model.load_state_dict(params, strict=True)
            logger.info("loaded checkpoint params for eval from %s", src)
        elif args.weights:
            raise SystemExit(f"--eval-only --weights {src}: no checkpoint found (expected a "
                             "checkpoint dir or a reference .pkl/.pth/.pt) — refusing to "
                             "evaluate random params")
    all_ok = True
    for ds in cfg.datasets.test:
        names = list(catalog.get(ds).thing_classes)
        metrics = engine.evaluate_dataset(cfg, model, ds, bank.encode(names), args.max_videos,
                                          device=device)
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
            _load_into(model, segmenter_state(src, cfg), "segmenter")
            logger.info("loaded reference weights from %s", src)
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
    # a trace of steady steps (past the warm-up) when the run is long enough
    trace_at = start + (10 if solver.max_iter - start > 13 else 0)
    tracing = contextlib.ExitStack()
    try:
        for it in range(start, solver.max_iter):
            if args.profile_dir and it == trace_at:
                tracing.enter_context(trace(args.profile_dir, device, f"trace_rank{rank}"))
            if it == trace_at + 3:
                tracing.close()
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
    bank = build_text_bank(cfg)
    model = init_params(build_model(cfg, device), seed=cfg.seed)
    pretrained_init(cfg, model)
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
