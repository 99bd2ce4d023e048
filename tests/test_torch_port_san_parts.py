"""PyTorch port, SANOnline's adaptive max pool against the JAX package on the
CPU (exact), and a SAN yaml through the CLI.  Shapes and helpers:
``tests/test_torch_port_san.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_net_torch
from openvis_tpu.models import side_adapter as jax_sa
from openvis_tpu_torch.checkpoint import load_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import params_from_flax
from openvis_tpu_torch.models import side_adapter
from openvis_tpu_torch.weights import convert_clip

from test_torch_port_cli import cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import D, SAN_YAML, tiny_clip  # noqa: F401  (fixtures and helpers)


@pytest.mark.parametrize("src", [(30, 54), (31, 45), (14, 14)], ids=["train", "odd", "same"])
def test_adaptive_max_pool_matches_jax(src):
    """Exact: both take the maximum of the same window."""
    x = np.random.RandomState(2).randn(2, 3, 5, *src).astype(np.float32)
    ref = np.asarray(jax.jit(jax_sa.adaptive_max_pool, static_argnums=1)(jnp.asarray(x),
                                                                         (14, 14)))
    got = side_adapter.adaptive_max_pool(torch.from_numpy(x), (14, 14)).numpy()
    assert got.shape == (2, 3, 5, 14, 14)
    np.testing.assert_array_equal(got, ref)


def test_cli_trains_and_evaluates_san(cli_root):  # noqa: F811
    """One step and an eval of a SAN yaml; the tower's state is the CLIP
    checkpoint's, converted, and it stays so."""
    root, _ = cli_root
    path = os.path.join(root, "san.yaml")
    with open(path, "w") as f:
        f.write(SAN_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_san")
    loaded = {}
    load = train_net_torch.load_clip_visual

    def recording(model, tree):
        load(model, tree)
        loaded.update({k: v.clone() for k, v in model.clip_adapter.visual.state_dict().items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch, "load_clip_visual", recording)
        run = ["--config-file", path, "--device", "cpu", f"output_dir={out}",
               "solver.max_iter=1", "solver.checkpoint_period=1"]
        train_net_torch.main(run)
        train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    cfg = load_config(path)
    want = params_from_flax(convert_clip({k: v.numpy() for k, v in torch.load(
        cfg.model.clip_adapter.weights).items()})["visual"])
    assert set(loaded) == set(want)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    params = load_checkpoint(os.path.join(out, "checkpoints"))["params"]
    for k, v in want.items():
        assert torch.equal(params[f"clip_adapter.visual.{k}"], v), k
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert np.isfinite(json.loads(f.readline())["total_loss"])
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
