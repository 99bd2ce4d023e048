"""PyTorch port, the eval engine with BriVIS: ``engine.evaluate_dataset``
against the JAX engine on the CPU in f32 for the temporal, decoupled and raw
resamplers, over a synthetic YTVIS dataset of two videos (11 frames at 48x64,
3 at 72x96: neither a multiple of the JAX engine's time bucket of 8, so the
resampler's padding to 16 and 8 frames shows), in windows of 4 (the first
video's third window a 3-frame tail), from one set of weights a resampler.
The shapes are ``tests/test_torch_port_brivis.py``'s."""

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
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import engine, train
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.models.clip import model as clip_model
from test_torch_port_brivis import RESAMPLERS, brivis_cfg
from test_torch_port_san import TINY, TINY_CLIP
from test_torch_port_san_engine import CATEGORIES, MASK_AGREE, METRIC_ATOL, SCORE_ATOL

DATASET = "torch_port_brivis_engine_synth"
VIDEOS = [(48, 64, 11, 2), (72, 96, 3, 1)]  # (height, width, frames, instances)
K = len(CATEGORIES)


@pytest.fixture(scope="module", autouse=True)
def tiny_clip():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip._MODEL_SHAPES, TINY, TINY_CLIP)
        mp.setitem(clip_model._MODEL_SHAPES, TINY, TINY_CLIP)
        yield
    torch.set_num_threads(threads)


def _cfg(mod, name: str, root: str, out: str):
    cfg = brivis_cfg(mod.Config, name)
    test = dataclasses.replace(cfg.model.test, window_inference=True, window_size=4,
                               max_frames=16, amp=False)
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, test=test), input=inp,
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(DATASET,)),
        output_dir=os.path.join(root, out))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks(pred):
    return np.stack([jax_rle.decode(s) for s in pred["segmentations"]])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("brivis_engine"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    text = np.random.RandomState(0).randn(K, TINY_CLIP["embed_dim"]).astype(np.float32)
    return root, text / np.linalg.norm(text, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", RESAMPLERS)
def test_brivis_engine_matches_jax_f32(dataset, name):
    root, text = dataset
    pcfg, jcfg = _cfg(port_config, name, root, f"port_{name}"), _cfg(jax_config, name, root,
                                                                     f"jax_{name}")
    model = init_params(train.build_model(pcfg, device="cpu"), seed=1)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, DATASET, text)
    pmet = engine.evaluate_dataset(pcfg, model, DATASET, text, device="cpu")
    jpred, ppred = _predictions(jcfg), _predictions(pcfg)
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    assert len(ppred) == 10 * len(VIDEOS)
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert len(p["segmentations"]) in (3, 11)
        assert (_masks(p) == _masks(j)).mean() >= MASK_AGREE
    assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k
    assert model.supervise_aux_logits  # the engine evaluated a copy
