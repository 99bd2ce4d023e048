"""PyTorch port, the eval engine with OpenVISOnline: ``engine.evaluate_dataset``
with mask-crop CLIP scoring against the JAX engine on the CPU in f32, over a
synthetic YTVIS dataset of two videos (11 frames at 48x64, 3 at 72x96), in
windows of 4 (the first video's last window a 3-frame tail; JAX pads it and
the time axis to 16 frames, the port runs the real ones), with the
``test-tiny`` CLIP tower (``clip``: the text rows without a no-object row)
read by both packages from one ``.pt``; the shapes are
``tests/test_torch_port_openvis.py``'s."""

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
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import rle as jax_rle
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu_torch import clip_towers, engine, train
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from test_torch_port_openvis import openvis_cfg

DATASET = "torch_port_openvis_engine_synth"
VIDEOS = [(48, 64, 11, 2), (72, 96, 3, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 3, "name": "c3"}]
K, D = len(CATEGORIES), 32  # one text row a category; the tiny tower's width
# tests/test_torch_port_engine.py's f32 bounds: the same arithmetic in another
# order, so a few boundary pixels may flip at the > 0 threshold
SCORE_ATOL = 2e-3
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, root: str, out: str):
    cfg = openvis_cfg(mod.Config)
    test = dataclasses.replace(cfg.model.test, window_inference=True, window_size=4,
                               max_frames=16, amp=False)
    clip = dataclasses.replace(cfg.model.clip_adapter, name="clip", clip_model_name="test-tiny",
                               weights=os.path.join(root, "clip_tiny.pt"))
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, test=test, clip_adapter=clip), input=inp,
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(DATASET,)),
        output_dir=os.path.join(root, out))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks(pred):
    return np.stack([jax_rle.decode(s) for s in pred["segmentations"]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("openvis_engine"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=1, dtype=torch.float32),
               os.path.join(root, "clip_tiny.pt"))
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    pcfg, jcfg = _cfg(port_config, root, "port"), _cfg(jax_config, root, "jax")
    model = init_params(train.build_model(pcfg, device="cpu"), seed=1)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    jvis, _ = jax_engine.build_clip_visual(jcfg)
    pvis = clip_towers.build_clip_visual(pcfg, "cpu")
    jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, DATASET, text,
                                       clip_visual_apply=jvis)
    pmet = engine.evaluate_dataset(pcfg, model, DATASET, text, clip_visual_apply=pvis,
                                   device="cpu")
    return jmet, _predictions(jcfg), pmet, _predictions(pcfg), model, pcfg, text


def test_openvis_engine_matches_jax_f32(runs):
    jmet, jpred, pmet, ppred, *_ = runs
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    # 10 a video, less the queries valid in no frame (score 0)
    assert 0 < len(ppred) <= 10 * len(VIDEOS)
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert (_masks(p) == _masks(j)).mean() >= MASK_AGREE
    assert len(ppred[0]["segmentations"]) == VIDEOS[0][2]
    assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k


def test_openvis_engine_needs_the_tower(runs):
    *_, model, pcfg, text = runs
    with pytest.raises(ValueError, match="clip_visual_apply"):
        engine.evaluate_dataset(pcfg, model, DATASET, text, device="cpu")
