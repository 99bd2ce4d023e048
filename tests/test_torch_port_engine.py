"""PyTorch port, the eval engine: ``openvis_tpu_torch.engine.evaluate_dataset``
against ``openvis_tpu.engine.evaluate_dataset`` on the CPU over a synthetic
YTVIS dataset, with one set of parameters loaded into both packages.

The dataset has two videos: 10 frames at 48x64 and 7 frames at 72x96, which
the test mapper resizes to 48x64 (so the evaluator resizes both ways: 1/4
resolution to the 64x96 canvas, and the crop back up to 72x96).  Settings:
windows of 4 (three windows for the first video, the last a 2-frame tail)
and the whole video (``window_inference: false``, ``max_frames`` 16), in f32;
the whole video under AMP (bf16).  The JAX engine pads windows and the time
axis; the port runs the real frames only, which must not change a result.
The engine's API checks (the caller's parameters, what it refuses, a run
without JAX) are in ``tests/test_torch_port_engine_api.py``."""

import dataclasses
import json
import os
from pathlib import Path

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
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import engine, train
from openvis_tpu_torch.convert import load_flax_params
from openvis_tpu_torch.data import catalog, synthetic
from torch_port_common import one_thread_fixture

REPO = Path(__file__).resolve().parent.parent
K, D = 2, 32
DATASET = "torch_port_engine_synth"
VIDEOS = [(48, 64, 10, 2), (72, 96, 7, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}]
SETTINGS = {  # name -> (window_inference, amp)
    "windowed_f32": (True, False),
    "whole_f32": (False, False),
    "whole_amp": (False, True),
}
# f32: the same arithmetic in another order (XLA vs ATen; the JAX evaluator
# resizes with weight matrices, f64 on the host, the port with F.interpolate
# in f32), so a few boundary pixels may flip at the > 0 threshold
F32_SCORE_ATOL = 2e-3
F32_MASK_AGREE = 0.999
METRIC_ATOL = 1e-6
# bf16 (tests/test_torch_port_slice.py): the frameworks round at different
# places and near-tied top-k entries may swap; the sorted top-k scores of a
# video shift by at most 0.1, and every prediction has one in the other run
# (same video and category, score within that bound) that agrees on 98 % of
# its pixels (observed: 0.074 and 99.4 % at worst)
BF16_SCORE_ATOL = 0.1
BF16_MASK_AGREE = 0.98

one_thread = one_thread_fixture()


def _cfg(mod, root: str, window_inference: bool, amp: bool, out: str):
    cfg = mod.Config()
    m = dataclasses.replace(
        cfg.model,
        num_classes=K,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=64, mask_dim=64,
            transformer_enc_layers=1, dim_feedforward=128, num_heads=4,
        ),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, hidden_dim=64, num_queries=8,
            nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=64, clip_embed_dim=D,
        ),
        test=dataclasses.replace(cfg.model.test, window_inference=window_inference,
                                 window_size=4, max_frames=16, amp=amp),
    )
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    ds = dataclasses.replace(cfg.datasets, root=root, test=(DATASET,))
    return dataclasses.replace(cfg, model=m, input=inp, datasets=ds,
                               output_dir=os.path.join(root, out))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks(pred):
    return np.stack([jax_rle.decode(s) for s in pred["segmentations"]])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("engine"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    # JAX's init under one jit: the same weights, bit for bit, as the eager
    # ``openvis_tpu.train.init_model`` (33 s against 12 s on an 8-core CPU)
    jm = jax_build_model(_cfg(jax_config, root, True, False, "unused"))
    params = jax.jit(lambda f, x: jm.init(jax.random.PRNGKey(0), f, 2, x))(
        jnp.zeros((2, 64, 96, 3), jnp.float32), jnp.asarray(text))["params"]
    pm = load_flax_params(train.build_model(_cfg(port_config, root, True, False, "unused"),
                                            device="cpu"),
                          jax.tree.map(np.asarray, params))
    return root, text, jm, params, pm


@pytest.fixture(scope="module")
def runs(setup):
    """Each setting evaluated once by each package: (metrics, predictions)."""
    root, text, jm, params, pm = setup
    out = {}
    for name, (windowed, amp) in SETTINGS.items():
        jcfg = _cfg(jax_config, root, windowed, amp, f"jax_{name}")
        pcfg = _cfg(port_config, root, windowed, amp, f"port_{name}")
        jmet = jax_engine.evaluate_dataset(jcfg, jm, params, DATASET, text)
        pmet = engine.evaluate_dataset(pcfg, pm, DATASET, text, device="cpu")
        out[name] = (jmet, _predictions(jcfg), pmet, _predictions(pcfg))
    return out


@pytest.mark.parametrize("name", ["windowed_f32", "whole_f32"])
def test_engine_matches_jax_f32(runs, name):
    jmet, jpred, pmet, ppred = runs[name]
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    assert len(ppred) == 10 * len(VIDEOS)
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= F32_SCORE_ATOL
        assert [s["size"] for s in p["segmentations"]] == [s["size"] for s in j["segmentations"]]
        assert (_masks(p) == _masks(j)).mean() >= F32_MASK_AGREE
    assert set(pmet) == set(jmet)
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, k


def test_windowed_and_whole_video_agree(runs):
    """The online arch makes the windowing invisible: the port's two f32 runs
    agree (within the f32 bounds), as the JAX engine's do."""
    _, _, met_w, pred_w = runs["windowed_f32"]
    _, _, met_v, pred_v = runs["whole_f32"]
    assert [(p["video_id"], p["category_id"]) for p in pred_w] == \
        [(p["video_id"], p["category_id"]) for p in pred_v]
    for a, b in zip(pred_w, pred_v):
        assert abs(a["score"] - b["score"]) <= F32_SCORE_ATOL
        assert (_masks(a) == _masks(b)).mean() >= F32_MASK_AGREE
    assert met_w == pytest.approx(met_v, abs=METRIC_ATOL)


def test_engine_matches_jax_amp(runs):
    jmet, jpred, pmet, ppred = runs["whole_amp"]
    assert len(ppred) == len(jpred) == 10 * len(VIDEOS)
    for vid in range(1, len(VIDEOS) + 1):
        ps = sorted(p["score"] for p in ppred if p["video_id"] == vid)
        js = sorted(p["score"] for p in jpred if p["video_id"] == vid)
        np.testing.assert_allclose(ps, js, atol=BF16_SCORE_ATOL)
    for p in ppred:
        cands = [j for j in jpred if j["video_id"] == p["video_id"]
                 and j["category_id"] == p["category_id"]
                 and abs(j["score"] - p["score"]) <= BF16_SCORE_ATOL]
        agree = max(((_masks(p) == _masks(j)).mean() for j in cands), default=0.0)
        assert agree >= BF16_MASK_AGREE, (p["video_id"], p["category_id"], p["score"])
    assert set(pmet) == set(jmet)
    for v in pmet.values():
        assert np.isfinite(v)
