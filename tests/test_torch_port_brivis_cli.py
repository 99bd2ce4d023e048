"""PyTorch port, BriVIS through the CLI on the CPU: stage 2 from a SANOnline
checkpoint of the CLI, and the recipe's flax weights refused when the file
is not there.  Shapes and helpers: ``tests/test_torch_port_brivis.py``."""

import json
import os

import numpy as np
import pytest
import torch

import train_net_torch
from openvis_tpu_torch import train
from openvis_tpu_torch.checkpoint import load_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params

from test_torch_port_cli import cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import SAN_YAML
from test_torch_port_brivis import (  # noqa: F401  (fixtures and helpers)
    BRIVIS_YAML,
    D,
    brivis,
    tiny_clip,
)


def test_cli_stage2_from_a_san_checkpoint(cli_root):  # noqa: F811
    """SANOnline trains a step and saves; BriVIS grafts its segmenter and
    clip_adapter, trains 2 steps across the matcher switch and evaluates;
    the grafted subtrees stay the SAN checkpoint's bit for bit."""
    root, _ = cli_root
    paths = {}
    for name, text in (("san", SAN_YAML), ("brivis", BRIVIS_YAML)):
        paths[name] = os.path.join(root, f"stage_{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(text.format(d=D, root=root, train="torch_port_cli_train",
                                eval="torch_port_cli_eval"))
    san_out, out = os.path.join(root, "stage1"), os.path.join(root, "stage2")
    san_ckpt = os.path.join(san_out, "checkpoints")
    train_net_torch.main(["--config-file", paths["san"], "--device", "cpu",
                          f"output_dir={san_out}", "solver.max_iter=1"])
    switched = []
    use = train_net_torch.use_brivis_matcher

    def recording(step, cfg, num_text_classes, image_matcher):
        switched.append((step.state.step, image_matcher))
        use(step, cfg, num_text_classes, image_matcher)

    run = ["--config-file", paths["brivis"], "--device", "cpu", f"output_dir={out}",
           f"model.weights={san_ckpt}", "solver.max_iter=2", "input.sampling_frame_num=3"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch, "use_brivis_matcher", recording)
        train_net_torch.main(run)
    assert switched == [(1, False)]  # at half of max_iter
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    san, brivis = (load_checkpoint(d)["params"] for d in (san_ckpt, os.path.join(out,
                                                                                  "checkpoints")))
    grafted = [k for k in brivis if k.startswith(("segmenter.", "clip_adapter."))]
    assert grafted and set(grafted) == set(san)
    for k in grafted:
        assert torch.equal(brivis[k], san[k]), k
    fresh = init_params(train.build_model(load_config(paths["brivis"]), device="cpu"), seed=0)
    moved = [k for k, v in fresh.state_dict().items() if k.startswith("resampler.")
             and not torch.equal(v, brivis[k])]
    assert moved
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r[k]) for r in lines for k in ("total_loss", "bc_loss", "htm_loss"))
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())


def test_cli_refuses_the_recipes_flax_weights(cli_root):  # noqa: F811
    root, _ = cli_root
    path = os.path.join(root, "stage_msgpack.yaml")
    with open(path, "w") as f:
        f.write(BRIVIS_YAML.format(d=D, root=root, train="torch_port_cli_train",
                                   eval="torch_port_cli_eval"))
    with pytest.raises(SystemExit, match="msgpack"):
        train_net_torch.main(["--config-file", path, "--device", "cpu",
                              f"output_dir={os.path.join(root, 'never')}",
                              "model.weights=work_dirs/san/model_final.msgpack"])
