"""PyTorch port, the eval engine with the offline (clip-level) archs:
``engine.evaluate_dataset`` against the JAX engine on the CPU in f32, over a
synthetic YTVIS dataset of two videos with ``test.max_frames`` lowered to 8
and ``test.window_inference`` off (the shipped offline recipes' setting): 5
frames at 48x64, one single shot padded to 8 with its last frame, and 11 at
72x96, windowed (a window of 8 and a 3-frame tail padded to 8).  Offline
SimpleBaseline through the CLIP ensemble (the ``test-tiny`` tower, ``bg_clip``),
offline OpenVIS on its objectness (no tower), offline SAN (its per-frame CLIP
logits averaged over the real frames) and MinVIS (the windowed online path,
the no-object column dropped), each from one set of weights in both
packages; the shapes are ``tests/test_torch_port_offline.py``'s."""

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
from openvis_tpu_torch import clip_towers, engine, train
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from test_torch_port_offline import Q, arch_cfg, offline_san_cfg
from test_torch_port_san import TINY, TINY_CLIP

DATASET = "torch_port_offline_engine_synth"
VIDEOS = [(48, 64, 5, 2), (72, 96, 11, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 3, "name": "c3"}]
K, D = len(CATEGORIES), 32  # one text row a category; the tiny towers' width
MAX_FRAMES = 8
# tests/test_torch_port_engine.py's f32 bounds: the same arithmetic in another
# order, so a few boundary pixels may flip at the > 0 threshold
SCORE_ATOL = 2e-3
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6
ARCHS = ("simple_baseline_ensemble", "openvis", "san", "minvis")


@pytest.fixture(scope="module", autouse=True)
def tiny_clip():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip._MODEL_SHAPES, TINY, TINY_CLIP)
        mp.setitem(clip_model._MODEL_SHAPES, TINY, TINY_CLIP)
        yield
    torch.set_num_threads(threads)


def _cfg(mod, arch_id: str, root: str, out: str):
    cls = mod.Config
    if arch_id == "san":
        cfg = offline_san_cfg(cls)
    elif arch_id == "openvis":
        cfg = arch_cfg(cls, "OpenVIS", "video_proposal", 1)
    elif arch_id == "minvis":
        cfg = arch_cfg(cls, "MinVIS", "frame", K)
    else:
        cfg = arch_cfg(cls, "SimpleBaseline", "video_embedding", K)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, clip_adapter=dataclasses.replace(
                cfg.model.clip_adapter, name="bg_clip", clip_model_name="test-tiny",
                clip_ensemble=True, clip_ensemble_weight=0.5,
                weights=os.path.join(root, "clip_tiny.pt"))))
    test = dataclasses.replace(cfg.model.test, window_inference=False, max_frames=MAX_FRAMES,
                               amp=False)
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, test=test), input=inp,
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(DATASET,)),
        output_dir=os.path.join(root, f"{arch_id}_{out}"))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks(pred):
    return np.stack([jax_rle.decode(s) for s in pred["segmentations"]])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("offline_engine"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=1, dtype=torch.float32),
               os.path.join(root, "clip_tiny.pt"))
    return root


@pytest.fixture(scope="module")
def runs(root):
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    res = {}
    for i, arch_id in enumerate(ARCHS):
        pcfg, jcfg = _cfg(port_config, arch_id, root, "port"), _cfg(jax_config, arch_id, root,
                                                                     "jax")
        model = init_params(train.build_model(pcfg, device="cpu"), seed=i + 1)
        params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
        jvis = pvis = None
        if arch_id == "simple_baseline_ensemble":
            jvis, _ = jax_engine.build_clip_visual(jcfg)
            pvis = clip_towers.build_clip_visual(pcfg, "cpu")
        jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, DATASET, text,
                                           clip_visual_apply=jvis)
        pmet = engine.evaluate_dataset(pcfg, model, DATASET, text, clip_visual_apply=pvis,
                                       device="cpu")
        res[arch_id] = (jmet, _predictions(jcfg), pmet, _predictions(pcfg))
    return res


@pytest.mark.parametrize("arch_id", ARCHS)
def test_offline_engine_matches_jax_f32(runs, arch_id):
    jmet, jpred, pmet, ppred = runs[arch_id]
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    if arch_id == "openvis":  # one class, the objectness: a prediction a query
        assert {p["category_id"] for p in ppred} == {1}
        assert len(ppred) == Q * len(VIDEOS)
    else:
        assert len(ppred) == 10 * len(VIDEOS)
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert (_masks(p) == _masks(j)).mean() >= MASK_AGREE
    # each video's real frames, no padded one
    assert sorted({len(p["segmentations"]) for p in ppred}) == sorted(v[2] for v in VIDEOS)
    assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k


def test_single_shot_pads_as_the_jax_engine(root):
    """The video decoder's attention over the clip is not masked: the 5-frame
    video's single shot of 8 (its last frame repeated) differs from a shot of
    its 5 real frames, so the engine must pad as the JAX engine does."""
    cfg = _cfg(port_config, "openvis", root, "pad")
    model = init_params(train.build_model(cfg, device="cpu"), seed=2)
    params = {n: p.detach() for n, p in model.named_parameters()}
    fn = engine.make_single_shot_fn(cfg, model, pre_topk=True)
    frames = torch.from_numpy(np.random.RandomState(3).randn(5, 64, 96, 3).astype(np.float32))
    with torch.inference_mode():
        probs5, masks5 = fn(params, frames, torch.zeros(K, D), torch.ones(5, dtype=torch.bool))
        padded = torch.cat([frames, frames[-1:].expand(3, -1, -1, -1)])
        probs8, masks8 = fn(params, padded, torch.zeros(K, D), torch.arange(8) < 5)
    assert masks8.shape[1] == 8 and probs8.shape == probs5.shape == (8, 1)
    assert not torch.allclose(masks8[:, :5], masks5, atol=1e-4)
