"""PyTorch port, the CLI: ``train_net_torch.py`` on the CPU (``--device
cpu``) over the synthetic YTVIS data of ``tests/test_train_net_cli.py``
(``cli_root``, registered in the port's catalog): train 2 steps with a
checkpoint and a profiler trace, ``--resume`` to step 4, ``--eval-only
--weights <checkpoint dir>``.  The text bank is replaced, as the JAX CLI's test
replaces it (the CLIP text tower is not ported yet)."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import train_net_torch
from openvis_tpu_torch.checkpoint import latest_step, load_checkpoint
from openvis_tpu_torch.data import catalog, rle

D = 32
TRAIN, EVAL = "torch_port_cli_train", "torch_port_cli_eval"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(root: Path, name, h, w, t):
    img_dir = root / "vids" / "JPEGImages" / name
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    fns = []
    for f in range(t):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(img_dir / f"{f:05d}.jpg")
        fns.append(f"{name}/{f:05d}.jpg")
    return fns


def _ytvis_json(h, w, t, fns):
    m = np.zeros((h, w), np.uint8)
    m[10:30, 10:40] = 1
    return {
        "videos": [{"id": 1, "height": h, "width": w, "length": t, "file_names": fns}],
        "annotations": [{"id": 1, "video_id": 1, "category_id": 1,
                         "segmentations": [rle.encode(m)] * t,
                         "bboxes": [[10, 10, 30, 20]] * t, "iscrowd": 0}],
        "categories": [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}],
    }


CFG_YAML = """
model:
  meta_architecture: SimpleBaselineOnline
  num_classes: 2
  backbone: {{name: resnet, depth: 50}}
  pixel_decoder:
    conv_dim: 64
    mask_dim: 64
    transformer_enc_layers: 1
    dim_feedforward: 128
    num_heads: 4
  transformer_decoder:
    name: frame_embedding
    hidden_dim: 64
    num_queries: 8
    nheads: 4
    dim_feedforward: 128
    dec_layers: 2
    mask_dim: 64
    clip_embed_dim: {d}
  criterion: {{train_num_points: 128}}
  clip_adapter: {{clip_ensemble: false}}
  test: {{window_inference: true, window_size: 4, topk_per_video: 5}}
solver:
  ims_per_batch: 1
  max_iter: 2
  checkpoint_period: 2
  amp: false
  warmup_iters: 0
input:
  min_size_train: [48]
  max_size_train: 96
  min_size_test: 48
  max_size_test: 96
  pad_size: [64, 96]
  sampling_frame_num: 2
  max_instances: 4
  crop_enabled: false
datasets:
  root: {root}
  train: [{train}]
  test: [{eval}]
  dataset_ratio: [1.0]
dataloader: {{num_workers: 1}}
output_dir: {root}/out
seed: 3
"""


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    h, w = 48, 64
    for name, js, t in (("tr1", "train.json", 4), ("ev1", "eval.json", 5)):
        fns = _write_video(root, name, h, w, t)
        with open(root / js, "w") as f:
            json.dump(_ytvis_json(h, w, t, fns), f)
    for name, js in ((TRAIN, "train.json"), (EVAL, "eval.json")):
        catalog.register(catalog.DatasetInfo(
            name=name, image_root="vids/JPEGImages", json_file=js,
            thing_classes=("c1", "c2"), id_map={1: 0, 2: 1}))
    cfg_path = root / "cli.yaml"
    cfg_path.write_text(CFG_YAML.format(d=D, root=root, train=TRAIN, eval=EVAL))
    return str(root), str(cfg_path)


class _FakeBank:
    def encode(self, names):
        rng = np.random.RandomState(7)
        t = rng.randn(len(names), D).astype(np.float32)
        return t / np.linalg.norm(t, axis=-1, keepdims=True)


@pytest.fixture(autouse=True)
def fake_bank(monkeypatch):
    monkeypatch.setattr(train_net_torch, "build_text_bank", lambda cfg: _FakeBank())


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_train_resume_then_eval(cli_root):
    root, cfg_path = cli_root
    out = os.path.join(root, "out")
    ckpt_dir = os.path.join(out, "checkpoints")
    trace_dir = os.path.join(root, "trace")
    train_net_torch.main(["--config-file", cfg_path, "--device", "cpu",
                          "--profile-dir", trace_dir])
    assert latest_step(ckpt_dir) == 2
    first = load_checkpoint(ckpt_dir)
    assert first["step"] == first["count"] == 2 and set(first) == {"step", "params", "mu",
                                                                    "nu", "count"}
    assert os.path.exists(os.path.join(trace_dir, "trace_rank0.json"))
    lines = _lines(os.path.join(out, "metrics.jsonl"))
    assert [r["step"] for r in lines] == [1, 2]
    for r in lines:
        assert {"total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm", "step_s",
                "data_wait_s"} <= set(r) and np.isfinite(r["total_loss"])

    train_net_torch.main(["--config-file", cfg_path, "--device", "cpu", "--resume",
                          "solver.max_iter=4"])
    assert latest_step(ckpt_dir) == 4
    assert [r["step"] for r in _lines(os.path.join(out, "metrics.jsonl"))] == [1, 2, 3, 4]
    resumed = load_checkpoint(ckpt_dir)
    assert resumed["count"] == 4
    moved = [n for n, p in resumed["params"].items() if not torch.equal(p, first["params"][n])]
    assert len(moved) > 100

    train_net_torch.main(["--config-file", cfg_path, "--device", "cpu", "--eval-only",
                          "--weights", ckpt_dir])
    with open(os.path.join(out, f"metrics_{EVAL}.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(out, f"results_{EVAL}.json")) as f:
        assert json.load(f), "no predictions"


def test_eval_only_refuses_a_missing_checkpoint(cli_root):
    _, cfg_path = cli_root
    with pytest.raises(SystemExit, match="refusing to evaluate random"):
        train_net_torch.main(["--config-file", cfg_path, "--device", "cpu", "--eval-only",
                              "--weights", os.path.join(cli_root[0], "nope")])


def test_unported_towers_raise_their_roadmap_item(cli_root, monkeypatch):
    _, cfg_path = cli_root
    monkeypatch.undo()  # the real text bank
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        train_net_torch.main(["--config-file", cfg_path, "--device", "cpu"])
    monkeypatch.setattr(train_net_torch, "build_text_bank", lambda cfg: _FakeBank())
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        train_net_torch.main(["--config-file", cfg_path, "--device", "cpu", "--eval-only",
                              "model.clip_adapter.clip_ensemble=true"])
