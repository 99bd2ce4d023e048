"""PyTorch port, SimpleBaselineOnline's mask-crop CLIP ensemble against the
JAX package on the CPU in f32: ``mask_square_boxes``, ``roi_crop`` (against
JAX and against the numpy ``roi_align`` oracle of
``tests/test_clip_adapters.py``), ``clip_crop_classify``, both
``frame_average_scores`` modes, ``apply_clip_ensemble``,
``crop_text_with_bg``, ``clip_crop_scores`` with masks padded past the real
frames, and the whole ``engine.evaluate_dataset`` with a ``bg_clip`` tower at
weight 0.8 against the JAX engine's.

The CLIP tower is ``test-tiny`` (64x64 crops), random, in OpenAI's key
layout (``models/clip/synthetic.py``), read by both packages from one
``.pt``; the dataset is ``tests/test_torch_port_engine.py``'s two synthetic
videos on the 64x96 canvas (masks at 16x24, crops of the frame at 4x the
mask boxes)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.clip_towers as jax_towers
import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
import openvis_tpu.train as jax_train
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.models import clip_adapter as jax_adapter
from openvis_tpu_torch import clip_towers, engine, train
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.data import catalog, rle, synthetic
from openvis_tpu_torch.models import clip_adapter
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from test_clip_adapters import _np_roi_align

K, D = 2, 32
DATASET = "torch_port_clip_ensemble_synth"
VIDEOS = [(48, 64, 10, 2), (72, 96, 7, 1)]  # (height, width, frames, instances)
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}]
# f32, the same arithmetic in another order (XLA against ATen), observed on
# the CPU: 100 x cosine logits of magnitude ~27 agree to 1.6e-5, the
# probabilities and the ensemble's scores to 6e-8, the engine's scores to
# 1.0e-9 (its masks and metrics equal); roi_crop to 2.4e-7
LOGIT_ATOL = 1e-4
SCORE_ATOL = 1e-5
ORACLE_ATOL = 1e-5  # tests/test_clip_adapters.py's bound against the oracle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny towers' many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _cfg(mod, root: str, out: str, **clip):
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
        test=dataclasses.replace(cfg.model.test, window_inference=True, window_size=4,
                                 max_frames=16, amp=False),
        clip_adapter=dataclasses.replace(
            cfg.model.clip_adapter, name="bg_clip", clip_model_name="test-tiny",
            weights=os.path.join(root, "clip_tiny.pt"), clip_ensemble=True,
            clip_ensemble_weight=0.8, **clip),
    )
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                              pad_size=(64, 96), max_instances=6)
    ds = dataclasses.replace(cfg.datasets, root=root, test=(DATASET,))
    return dataclasses.replace(cfg, model=m, input=inp, datasets=ds,
                               output_dir=os.path.join(root, out))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset, one CLIP checkpoint, both towers, both segmenters."""
    root = str(tmp_path_factory.mktemp("clip_ensemble"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=1, dtype=torch.float32),
               os.path.join(root, "clip_tiny.pt"))
    jcfg, pcfg = _cfg(jax_config, root, "jax"), _cfg(port_config, root, "port")
    jvis, _ = jax_engine.build_clip_visual(jcfg)
    pvis = clip_towers.build_clip_visual(pcfg, "cpu")
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    # the port's seeded init carried into the JAX model (no JAX init compile)
    pm = init_params(train.build_model(pcfg, device="cpu"), seed=0)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(pm.state_dict()))
    return root, text, jcfg, pcfg, jvis, pvis, jax_train.build_model(jcfg), params, pm


def _masks(rng, t, q, h, w):
    """Soft masks: a rectangle per slot, one slot empty (no pixel above 0.5)
    and one touching the far corner."""
    m = rng.rand(t, q, h, w).astype(np.float32) * 0.4
    for i in range(t):
        for j in range(q - 1):
            y0, x0 = rng.randint(0, h - 2), rng.randint(0, w - 2)
            m[i, j, y0:y0 + rng.randint(2, h), x0:x0 + rng.randint(2, w)] = 0.9
        m[i, 1, h - 3:, w - 5:] = 0.95
    return m


def test_mask_square_boxes_match_jax():
    m = _masks(np.random.RandomState(1), 1, 5, 16, 24)[0]
    boxes, valid = clip_adapter.mask_square_boxes(torch.from_numpy(m))
    jb, jv = jax.jit(jax_adapter.mask_square_boxes)(jnp.asarray(m))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert valid.tolist() == [True] * 4 + [False]
    assert boxes[4].tolist() == [0.0, 0.0, 1.0, 1.0] and boxes.dtype == torch.float32


@pytest.mark.parametrize("sr", [1, 2])
def test_roi_crop_matches_jax_and_the_oracle(sr):
    rng = np.random.RandomState(1)
    img = rng.randn(1, 24, 36, 3).astype(np.float32)
    boxes = np.asarray([[4.0, 2.0, 28.0, 20.0],      # partly out of bounds (x)
                        [0.0, 0.0, 36.0, 24.0],      # the whole image
                        [10.5, 3.25, 19.5, 12.25],   # fractional, inside
                        [-6.0, -4.0, 10.0, 12.0],    # out of bounds (negative)
                        [-5.0, -8.0, 31.0, 28.0],    # a side of max(h, w)
                        [3.0, 20.0, 39.0, 56.0]],    # the same, far out at the bottom
                       np.float32)
    got = clip_adapter.roi_crop(torch.from_numpy(img), torch.from_numpy(boxes), 8, sr).numpy()
    jroi = jax.jit(jax_adapter.roi_crop, static_argnums=(2, 3))
    ref = np.asarray(jroi(jnp.asarray(img), jnp.asarray(boxes), 8, sr))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ORACLE_ATOL)
    for box, crop in zip(boxes, got):
        np.testing.assert_allclose(crop, _np_roi_align(img[0], box, 8, sr), rtol=1e-4,
                                   atol=ORACLE_ATOL)
    # one image a region (the mask crops)
    per = rng.randn(len(boxes), 24, 36, 1).astype(np.float32)
    got = clip_adapter.roi_crop(torch.from_numpy(per), torch.from_numpy(boxes), 8, sr).numpy()
    ref = np.asarray(jroi(jnp.asarray(per), jnp.asarray(boxes), 8, sr))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ORACLE_ATOL)
    for i, box in enumerate(boxes):
        np.testing.assert_allclose(got[i], _np_roi_align(per[i], box, 8, sr), rtol=1e-4,
                                   atol=ORACLE_ATOL)


def test_clip_crop_classify_matches_jax(setup):
    _, _, _, _, jvis, pvis, *_ = setup
    rng = np.random.RandomState(2)
    frames = rng.rand(2, 64, 96, 3).astype(np.float32) * 255
    masks = _masks(rng, 2, 4, 16, 24)
    text = rng.randn(3, 32).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    kw = dict(input_resolution=64, mask_stride=4, sampling_ratio=2)
    lg, vd = clip_adapter.clip_crop_classify(pvis, torch.from_numpy(frames),
                                             torch.from_numpy(masks), torch.from_numpy(text), **kw)
    jlg, jvd = jax.jit(lambda f, m, x: jax_adapter.clip_crop_classify(jvis, f, m, x, **kw))(
        jnp.asarray(frames), jnp.asarray(masks), jnp.asarray(text))
    assert lg.shape == (2, 4, 3) and vd.tolist() == [[True] * 3 + [False]] * 2
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=LOGIT_ATOL)


def _clip_outputs(rng, t=4, q=5, k=4):
    logits = (rng.randn(t, q, k) * 5).astype(np.float32)
    valid = rng.rand(t, q) > 0.3
    valid[:, 0] = False  # a query valid in no frame
    valid[0, 1] = True
    return logits, valid


@pytest.mark.parametrize("mode", ["logits_then_softmax", "softmax_then_mean"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_frame_average_scores_match_jax(mode, drop_last):
    logits, valid = _clip_outputs(np.random.RandomState(3))
    got = clip_adapter.frame_average_scores(torch.from_numpy(logits), torch.from_numpy(valid),
                                            mode, drop_last)
    ref = jax_adapter.frame_average_scores(jnp.asarray(logits), jnp.asarray(valid), mode,
                                           drop_last)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("weight", [0.0, 0.8])
@pytest.mark.parametrize("drop_last", [False, True])
def test_apply_clip_ensemble_matches_jax(weight, drop_last):
    rng = np.random.RandomState(4)
    logits, valid = _clip_outputs(rng, k=4 if drop_last else 3)
    scores = rng.dirichlet(np.ones(3), 5).astype(np.float32)
    got = clip_towers.apply_clip_ensemble(torch.from_numpy(scores), torch.from_numpy(logits),
                                          torch.from_numpy(valid), weight, drop_last).numpy()
    ref = np.asarray(jax_towers.apply_clip_ensemble(jnp.asarray(scores), jnp.asarray(logits),
                                                    jnp.asarray(valid), weight, drop_last))
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)
    # valid in no frame: CLIP's factor is 1
    np.testing.assert_allclose(got[0], scores[0] ** (1.0 - weight if weight > 0 else 1.0),
                               rtol=1e-6)


def test_crop_text_with_bg_matches_jax(setup):
    _, text, jcfg, pcfg, *_, params, pm = setup
    pparams = {n: p.detach() for n, p in pm.named_parameters()}
    for name in ("bg_clip", "clip"):
        jc = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, clip_adapter=dataclasses.replace(jcfg.model.clip_adapter, name=name)))
        pc = dataclasses.replace(pcfg, model=dataclasses.replace(
            pcfg.model, clip_adapter=dataclasses.replace(pcfg.model.clip_adapter, name=name)))
        rows, has_bg = clip_towers.crop_text_with_bg(pc, pparams, torch.from_numpy(text))
        jrows, jhas = jax_towers.crop_text_with_bg(jc, params, jnp.asarray(text))
        assert has_bg == jhas == (name == "bg_clip") and rows.shape == (K + has_bg, D)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=0, atol=1e-7)


def test_clip_crop_scores_over_the_real_frames(setup):
    """Masks padded past the ``t`` real frames (as the JAX engine's buckets
    pad them): each chunk pairs a mask with its own frame, and only the real
    frames come back."""
    _, _, jcfg, pcfg, jvis, pvis, *_ = setup
    rng = np.random.RandomState(5)
    t, tb, window = 5, 8, 2
    pixels = rng.randn(t, 64, 96, 3).astype(np.float32)
    mask_logits = (_masks(rng, tb, 4, 16, 24) - 0.5) * 8
    text = rng.randn(3, 32).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    score_fn = clip_towers.make_openvis_score_fn(pcfg, pvis)
    lg, vd = clip_towers.clip_crop_scores(pcfg, score_fn, pixels, torch.from_numpy(mask_logits),
                                          torch.from_numpy(text), window, t)
    jfn = jax.jit(jax_towers.make_openvis_score_fn(jcfg, jvis))
    jlg, jvd = jax_towers.clip_crop_scores(jfn, jax_towers.raw_frames(jcfg, pixels), mask_logits,
                                           jnp.asarray(text), window, t)
    assert lg.shape == (t, 4, 3)
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=LOGIT_ATOL)
    raw = clip_towers.raw_frames(pcfg, pixels, "cpu").numpy()
    np.testing.assert_array_equal(raw, jax_towers.raw_frames(jcfg, pixels))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def _masks_of(pred):
    return np.stack([rle.decode(s) for s in pred["segmentations"]])


def test_evaluate_dataset_with_the_ensemble_matches_jax(setup):
    root, text, jcfg, pcfg, jvis, pvis, jm, params, pm = setup
    jmet = jax_engine.evaluate_dataset(jcfg, jm, params, DATASET, text, clip_visual_apply=jvis)
    pmet = engine.evaluate_dataset(pcfg, pm, DATASET, text, clip_visual_apply=pvis,
                                   device="cpu")
    jpred, ppred = _predictions(jcfg), _predictions(pcfg)
    assert len(ppred) == 10 * len(VIDEOS)
    assert [(p["video_id"], p["category_id"]) for p in ppred] == \
        [(p["video_id"], p["category_id"]) for p in jpred]
    for p, j in zip(ppred, jpred):
        assert abs(p["score"] - j["score"]) <= SCORE_ATOL
        assert (_masks_of(p) == _masks_of(j)).mean() >= 0.999  # test_torch_port_engine's bound
    assert set(pmet) == set(jmet)
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= 1e-6, k

    # the ensemble moves the scores (the port's run without the tower)
    plain = dataclasses.replace(pcfg, output_dir=os.path.join(root, "port_plain"))
    engine.evaluate_dataset(plain, pm, DATASET, text, device="cpu")
    assert sorted(round(p["score"], 6) for p in _predictions(plain)) != \
        sorted(round(p["score"], 6) for p in ppred)


def test_unported_towers_raise_their_roadmap_item(setup):
    """The towers queue 1 item 8.6 once refused now build: a plain OpenAI
    ViT file grafts into the ``adapted``/``bg_adapted`` tower with a zero
    ``mask_embedding`` (no prompt where every patch is marked, the zero
    token where the mask is 0), a ModifiedResNet name builds the RN tower;
    an empty weights path still stops."""
    root, _, _, pcfg, _, pvis, *_ = setup
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 64, 64, 3).astype(np.float32))
    m = torch.from_numpy(rng.rand(3, 64, 64).astype(np.float32) * 0.9 + 0.05)
    m[1, :, 32:] = 0.0
    plain = pvis(x)
    for name in ("adapted", "bg_adapted"):
        cfg = dataclasses.replace(pcfg, model=dataclasses.replace(
            pcfg.model, clip_adapter=dataclasses.replace(pcfg.model.clip_adapter, name=name)))
        vis = clip_towers.build_clip_visual(cfg, "cpu")
        torch.testing.assert_close(vis(x), plain, rtol=0, atol=0)
        got = vis(x, m)
        torch.testing.assert_close(got[[0, 2]], plain[[0, 2]], rtol=0, atol=1e-5)
        assert (got[1] - plain[1]).abs().max() > 1e-3
    rn_path = os.path.join(root, "clip_tiny_rn.pt")
    torch.save(clip_synthetic.openai_state_dict("test-tiny-rn", seed=1, dtype=torch.float32),
               rn_path)
    rn = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, clip_adapter=dataclasses.replace(pcfg.model.clip_adapter,
                                                     clip_model_name="test-tiny-rn",
                                                     weights=rn_path)))
    feats = clip_towers.build_clip_visual(rn, "cpu")(x)
    assert feats.shape == (3, D) and torch.isfinite(feats).all()
    empty = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, clip_adapter=dataclasses.replace(pcfg.model.clip_adapter, weights="")))
    with pytest.raises(ValueError, match="weights is empty"):
        clip_towers.build_clip_visual(empty, "cpu")
