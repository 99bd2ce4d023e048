"""PyTorch port, the CLI: ``train_net_torch.py`` on the CPU (``--device
cpu``) over the synthetic YTVIS data of ``tests/test_train_net_cli.py``
(``cli_root``, registered in the port's catalog): train 2 steps with a
checkpoint and a profiler trace, ``--resume`` to step 4, ``--eval-only
--weights <checkpoint dir>`` with the recipe's CLIP ensemble (``bg_clip``).
The text bank and the CLIP tower are real, at the ``test-tiny`` CLIP shape:
random weights in OpenAI's layout and a tiny BPE merge file written by the
fixture (``models/clip/synthetic.py``)."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import train_net_torch
from openvis_tpu_torch import clip_towers, engine, train
from openvis_tpu_torch.checkpoint import latest_step, load_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog, rle
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic

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
  clip_adapter:
    name: bg_clip
    prompt_name: vild
    clip_model_name: test-tiny
    clip_ensemble: true
    clip_ensemble_weight: 0.5
    weights: {root}/clip_tiny.pt
    bpe_vocab: {root}/bpe.txt.gz
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
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=5,
                                                vocab_size=clip_synthetic.bpe_vocab_size()),
               root / "clip_tiny.pt")
    clip_synthetic.write_bpe(str(root / "bpe.txt.gz"))
    cfg_path = root / "cli.yaml"
    cfg_path.write_text(CFG_YAML.format(d=D, root=root, train=TRAIN, eval=EVAL))
    return str(root), str(cfg_path)


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


def test_unported_towers_raise_their_roadmap_item(cli_root):
    """``--eval-only`` with the ``bg_adapted`` tower (queue 1 item 8.6b, ported)
    writes the engine's own predictions for that tower (the mask-prompted
    ViT, whose features differ from the plain tower's where a crop's mask
    leaves patches empty); fetching weights by name still raises."""
    root, cfg_path = cli_root
    run = ["--config-file", cfg_path, "--device", "cpu", "--eval-only"]
    out = os.path.join(root, "out_bg_adapted")
    opts = ["model.clip_adapter.name=bg_adapted", f"output_dir={out}"]
    train_net_torch.main(run + opts)
    with open(os.path.join(out, f"results_{EVAL}.json")) as f:
        cli_preds = json.load(f)
    # the same model (its seeded init: no checkpoint under ``out``), bank and tower
    cfg = load_config(cfg_path, opts[:1] + [f"output_dir={out}_engine"])
    model = init_params(train.build_model(cfg, device="cpu"), seed=cfg.seed)
    text = train_net_torch.build_text_bank(cfg, "cpu").encode(["c1", "c2"])
    tower = clip_towers.build_clip_visual(cfg, "cpu")
    engine.evaluate_dataset(cfg, model, EVAL, text, clip_visual_apply=tower, device="cpu")
    with open(os.path.join(cfg.output_dir, f"results_{EVAL}.json")) as f:
        assert cli_preds == json.load(f) and cli_preds
    dtype = engine.eval_dtype(cfg)  # the towers run in the eval dtype
    crops = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(dtype)
    masks = torch.ones(2, 64, 64, dtype=dtype)
    masks[1, :, 32:] = 0.0
    plain = clip_towers.build_clip_visual(load_config(cfg_path), "cpu")(crops)
    prompted = tower(crops, masks)
    assert torch.equal(prompted[0], plain[0])  # every patch marked: no prompt
    assert (prompted[1] - plain[1]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="queue 1 item 8"):
        train_net_torch.main(run + ["model.clip_adapter.weights=ViT-B/16"])
    # no CLIP weights: the CLI stops, it does not drop the bank or the ensemble
    with pytest.raises(SystemExit, match="clip_adapter.weights"):
        train_net_torch.main(run + ["model.clip_adapter.weights="])


def test_text_bank_is_the_clip_text_tower(cli_root):
    root, cfg_path = cli_root
    cfg = load_config(cfg_path)
    bank = train_net_torch.build_text_bank(cfg, "cpu")
    emb = bank.encode(["c1", "c2"])
    assert emb.shape == (2, D) and emb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-6)
    assert len(bank.templates) == 14 and bank.encoder.context_length == 77
