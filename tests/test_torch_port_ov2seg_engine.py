"""PyTorch port, the eval engine with OV2Seg against the JAX engine on the CPU
in f32, and the OV2Seg recipe through the CLI.

The engine runs over a synthetic YTVIS dataset of two videos (13 frames at
48x64, 3 at 72x96) in windows of 4 with the shapes of
``tests/test_torch_port_ov2seg.py``.  A video of 13 frames pads to 16: the
JAX engine pads logits, objectness, embeddings and masks to ``_bucket(t)``
with the last frame, tracks the 16 by the EMA chain and averages the logits
over all 16; the port follows it, and a run with the padding switched off
(the mean over the 13 real frames) differs.  The CLI trains and evaluates a
yaml based on ``configs/openvoc_ytvis_coco/ov2seg_online_R50.yaml`` at
``tests/test_torch_port_cli.py``'s tiny shapes."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
import train_net_torch
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu_torch import engine
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.checkpoint import latest_step
from openvis_tpu_torch.data import catalog, synthetic
from test_torch_port_cli import CFG_YAML, D as CLI_D, cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_ov2seg import D, ov2seg_cfg
from torch_port_common import one_thread_fixture, seeded_model

DATASET = "torch_port_ov2seg_engine_synth"
VIDEOS = [(48, 64, 13, 2), (72, 96, 3, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 3, "name": "c3"}]
K = len(CATEGORIES)
# f32, the same arithmetic in another order: the scores are a few elementwise
# operations on the model's logits (1.8e-7 apart here), a mean over the 13
# real frames alone moves them by 1.4e-4; tests/test_torch_port_engine.py's
# mask bound (a few boundary pixels may flip at the > 0 threshold)
SCORE_ATOL = 1e-5
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

one_thread = one_thread_fixture()


def _cfg(mod, root: str, out: str):
    cfg = ov2seg_cfg(mod.Config)
    test = dataclasses.replace(cfg.model.test, window_inference=True, window_size=4,
                               max_frames=16, amp=False)
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_classes=K, test=test), input=inp,
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(DATASET,)),
        output_dir=os.path.join(root, out))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks(pred):
    return np.stack([jax_rle.decode(s) for s in pred["segmentations"]])


def test_ov2seg_engine_matches_jax_with_its_bucket_padding(tmp_path):
    root = str(tmp_path)
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    pcfg, jcfg = _cfg(port_config, root, "port"), _cfg(jax_config, root, "jax")
    model, tree = seeded_model(pcfg, 1)
    params = jax.tree.map(jnp.asarray, tree)
    jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, DATASET, text)
    pmet = engine.evaluate_dataset(pcfg, model, DATASET, text, device="cpu")
    jpred, ppred = _predictions(jcfg), _predictions(pcfg)
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    assert 0 < len(ppred) <= 10 * len(VIDEOS)
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert (_masks(p) == _masks(j)).mean() >= MASK_AGREE
    assert len(ppred[0]["segmentations"]) == VIDEOS[0][2]
    assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k

    # the mean over the 13 real frames alone: the first video's scores leave
    # the bound
    real = dataclasses.replace(pcfg, output_dir=os.path.join(root, "real_frames"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "_bucket", lambda n, step=8: n)
        engine.evaluate_dataset(real, model, DATASET, text, device="cpu")
    first = [p["score"] for p in _predictions(real) if p["video_id"] == 1]
    jfirst = [p["score"] for p in jpred if p["video_id"] == 1]
    assert max(abs(a - b) for a, b in zip(sorted(first), sorted(jfirst))) > SCORE_ATOL


OV2SEG_YAML = ("_BASE_: {repo}/configs/openvoc_ytvis_coco/ov2seg_online_R50.yaml\n"
               + CFG_YAML.replace("meta_architecture: SimpleBaselineOnline",
                                  "meta_architecture: OV2Seg").replace(
                   "name: frame_embedding", "name: ov2seg_frame").replace(
                   "name: bg_clip", "name: clip").replace("clip_ensemble: true",
                                                          "clip_ensemble: false"))


def test_cli_trains_and_evaluates_ov2seg(cli_root):  # noqa: F811
    """Two steps with a checkpoint, then ``--eval-only``, of the OV2Seg recipe
    at tiny shapes (its ``vild`` text bank, the test-tiny CLIP)."""
    root, _ = cli_root
    path = os.path.join(root, "ov2seg.yaml")
    with open(path, "w") as f:
        f.write(OV2SEG_YAML.format(repo=REPO, d=CLI_D, root=root, train="torch_port_cli_train",
                                   eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_ov2seg")
    run = ["--config-file", path, "--device", "cpu", f"output_dir={out}"]
    train_net_torch.main(run)
    assert latest_step(os.path.join(out, "checkpoints")) == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    cfg = port_config.load_config(path)
    assert cfg.model.meta_architecture == "OV2Seg"
    assert cfg.model.clip_adapter.prompt_name == "vild"
