"""PyTorch port, the eval engine with MasQCLIP against the JAX engine on the
CPU in f32, and MasQCLIP through the CLI.

The engine runs over a synthetic YTVIS dataset of two videos at the shapes
of ``tests/test_torch_port_masqclip.py`` with ``test.max_frames`` 16 and
windows of 4: 13 frames at 48x64 go in one shot padded to 16 (the model's
means over T include the 3 padded frames, in both packages: with the padding
switched off the scores leave the bound), and 19 at 72x96 take the windowed
path (5 windows of 4, the tail of 3 padded; the windows' fused probabilities
summed by their real frames, divided by T, no softmax).  The dataset's three
class rows are the text as JAX's engine passes them: the last one is the
background, and no prediction names its category.  The CLI trains and
evaluates a yaml based on ``configs/openvoc_ytvis_coco/simplebsl_R50_bs8_12000st.yaml``
with ``model.meta_architecture: MasQCLIP`` over ``video_proposal`` at
``tests/test_torch_port_cli.py``'s tiny shapes."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
import train_net_torch
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu_torch import engine, train
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.checkpoint import latest_step
from openvis_tpu_torch.convert import init_params, params_from_flax
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.models.clip.build import build_clip_params
from test_torch_port_cli import CFG_YAML, D as CLI_D, cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_masqclip import D, masq_cfg
from torch_port_common import one_thread_fixture, seeded_model

DATASET = "torch_port_masqclip_engine_synth"
VIDEOS = [(48, 64, 13, 2), (72, 96, 19, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 3, "name": "c3"}]
K = len(CATEGORIES)
# f32, the same arithmetic in another order: the scores are a few elementwise
# operations on the model's logits; the mean over the 13 real frames alone
# moves them by more; tests/test_torch_port_engine.py's mask bound (a few
# boundary pixels may flip at the > 0 threshold)
SCORE_ATOL = 1e-5
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

one_thread = one_thread_fixture()


def _cfg(mod, root: str, out: str):
    cfg = masq_cfg(mod.Config)
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


def test_masqclip_engine_matches_jax_single_shot_and_windowed(tmp_path):
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
    assert len(ppred) == 10 * len(VIDEOS)
    # the last class row is the background: never a prediction's category
    assert {p["category_id"] for p in ppred} <= {c["id"] for c in CATEGORIES[:-1]}
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert (_masks(p) == _masks(j)).mean() >= MASK_AGREE
    assert [len(p["segmentations"]) for p in ppred[::10]] == [v[2] for v in VIDEOS]
    assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k

    # the shot over the 13 real frames alone: the first video's scores leave
    # the bound
    real = dataclasses.replace(pcfg, output_dir=os.path.join(root, "real_frames"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "_bucket", lambda n, step=8: n)
        engine.evaluate_dataset(real, model, DATASET, text, max_videos=1, device="cpu")
    first = [p["score"] for p in _predictions(real)]
    jfirst = [p["score"] for p in jpred if p["video_id"] == 1]
    assert max(abs(a - b) for a, b in zip(sorted(first), sorted(jfirst))) > SCORE_ATOL


MASQ_YAML = ("_BASE_: {repo}/configs/openvoc_ytvis_coco/simplebsl_R50_bs8_12000st.yaml\n"
             + CFG_YAML.replace("meta_architecture: SimpleBaselineOnline",
                                "meta_architecture: MasQCLIP").replace(
                 "name: frame_embedding", "name: video_proposal"))


def test_cli_trains_and_evaluates_masqclip(cli_root, monkeypatch):  # noqa: F811
    """Two steps with a checkpoint, then ``--eval-only``, as JAX's CLI runs
    MasQCLIP: the CLIP file's visual weights do not reach the MasQ tower
    (after the graft it equals its seeded init), and the eval builds no crop
    tower although the recipe keeps ``clip_ensemble``."""
    root, _ = cli_root
    path = os.path.join(root, "masqclip.yaml")
    with open(path, "w") as f:
        f.write(MASQ_YAML.format(repo=REPO, d=CLI_D, root=root, train="torch_port_cli_train",
                                 eval="torch_port_cli_eval"))
    out = os.path.join(root, "out_masqclip")
    run = ["--config-file", path, "--device", "cpu", f"output_dir={out}"]
    cfg = port_config.load_config(path, run[4:])
    assert cfg.model.meta_architecture == "MasQCLIP" and cfg.model.clip_adapter.clip_ensemble
    grafted = []
    load = train_net_torch.load_clip_visual

    def keep(model, clip_tree):
        load(model, clip_tree)
        grafted.append({n: p.detach().clone() for n, p in model.clip_adapter.named_parameters()})

    monkeypatch.setattr(train_net_torch, "load_clip_visual", keep)
    train_net_torch.main(run)
    init = init_params(train.build_model(cfg, device="cpu"), seed=cfg.seed).clip_adapter
    for n, p in init.named_parameters():
        assert torch.equal(grafted[0][n], p), n
    clip_visual = params_from_flax(build_clip_params(cfg.model.clip_adapter.weights)["visual"])
    assert not torch.equal(grafted[0]["conv1.weight"], clip_visual["conv1.weight"])
    assert latest_step(os.path.join(out, "checkpoints")) == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    assert all(r["loss_mask"] == 0 and r["loss_dice"] == 0 for r in lines)

    def no_tower(*a, **kw):
        raise AssertionError("MasQCLIP's eval builds no crop tower")

    monkeypatch.setattr(train_net_torch, "build_clip_visual", no_tower)
    train_net_torch.main(run + ["--eval-only", "--weights", os.path.join(out, "checkpoints")])
    with open(os.path.join(out, "metrics_torch_port_cli_eval.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
