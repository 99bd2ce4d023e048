"""PyTorch port, offline SAN's forward against the JAX package on the CPU (its
loss raises, as the JAX package's fails), and the offline SimpleBaseline
recipe through the CLI.  Shapes and helpers: ``tests/test_torch_port_offline.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import flax_from_state_dict
from openvis_tpu_torch.models.meta import san
from openvis_tpu_torch.structures import ClipTargets

from test_torch_port_cli import cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_offline import (  # noqa: F401  (fixtures and helpers)
    B,
    CLIP_HEADS,
    D,
    FORWARD_REL_TO_MAX,
    K,
    N,
    OFFLINE_YAML,
    Q,
    T,
    _port_model,
    _rel,
    batch,
    offline_san_cfg,
    tiny_clip,
)


def test_offline_san_forward_matches_jax_and_its_loss_raises(batch):
    """Offline SAN's forward (the video decoder's per-frame biases through the
    biased CLIP post-encode) with and without the aux layers' CLIP logits;
    its loss, train step and loss closure raise the named error."""
    frames, text, labels, masks, valid, _ = batch
    cfg, jcfg = offline_san_cfg(Config), offline_san_cfg(JaxConfig)
    model = _port_model(cfg, seed=11)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    jm = jax_train.build_model(jcfg)
    keys = ("pred_logits_all", "pred_masks_all", "class_attn_biases_all")

    def ref_fn(p, x, txt):
        out = jm.apply({"params": p}, x, T, txt)
        return {k: out[k] for k in keys}

    ref = jax.jit(ref_fn)(params, jnp.asarray(frames), jnp.asarray(text))
    with torch.no_grad():
        out = model(torch.from_numpy(frames), T, torch.from_numpy(text))
        last = train.eval_model(model)(torch.from_numpy(frames), T, torch.from_numpy(text))
    l = 2 + 1
    assert out["class_attn_biases_all"].shape == (l, B, T, CLIP_HEADS, Q, 4, 6)
    assert out["pred_logits_all"].shape == (l, B, T, Q, K + 1)
    assert out["pred_masks_all"].shape == (l, B, Q, T, 16, 24)
    for k in keys:
        assert _rel(out[k], ref[k]) <= FORWARD_REL_TO_MAX, k
    # evaluation's model: the last layer's CLIP logits only
    assert _rel(last["pred_logits"], ref["pred_logits_all"][-1]) <= FORWARD_REL_TO_MAX

    targets = ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                          torch.from_numpy(valid), torch.ones(B, N, T, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match=r"criterion\.py:290.*ROADMAP\.md §3"):
        san.san_loss(torch.Generator(), out, targets, cfg.model, K, online=False)
    with pytest.raises(NotImplementedError, match="offline SAN"):
        train.build_train_step(cfg, model, K, device="cpu")
    with pytest.raises(NotImplementedError, match="offline SAN"):
        train.make_loss_fn(cfg, model, K)


def test_cli_trains_and_evaluates_offline_simple_baseline(cli_root):  # noqa: F811
    """Two clip-level steps and a checkpoint of an offline SimpleBaseline
    yaml, then ``--eval-only`` through the CLIP ensemble: the eval video's 5
    frames run as one shot of 8."""
    root, _ = cli_root
    path = os.path.join(root, "offline.yaml")
    with open(path, "w") as f:
        f.write(OFFLINE_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                    eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_offline")
    run = ["--config-file", path, "--device", "cpu", f"output_dir={out}"]
    train_net_torch.main(run)
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r[k]) for r in lines for k in ("total_loss", "loss_ce", "grad_norm"))
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(out, "results_torch_port_cli_eval.json")) as f:
        preds = json.load(f)
    assert preds and {p["category_id"] for p in preds} <= {1, 2}
    assert all(len(p["segmentations"]) == 5 for p in preds)
