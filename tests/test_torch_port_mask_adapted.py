"""PyTorch port, the mask-adapted CLIP towers against the JAX package on the
CPU: ``MaskAdaptedVisual`` (the mask-prompted ViT) at ``test-tiny``,
``MaskAdaptedModifiedResNet`` at ``test-tiny-rn`` with the ModifiedResNet
weight reader and text tower, the adapted crop classifier
(``clip_towers.make_openvis_score_fn``) for both towers, and the whole
``engine.evaluate_dataset`` with an ``adapted`` ViT under OpenVISOnline and a
``bg_adapted`` ModifiedResNet under SimpleBaselineOnline's ensemble.

Every CLIP file is random, in OpenAI's key layout
(``models/clip/synthetic.py``), read by both packages from one ``.pt``
(the ViT's with a nonzero ``visual.mask_embedding``, as a mask-adapted
fine-tune carries).  The ModifiedResNet's all-covered crops mask every key
of its attention pool: both packages give NaN features there, in the same
rows (ROADMAP.md §3)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import openvis_tpu.clip_towers as jax_towers
import openvis_tpu.config as jax_config
import openvis_tpu.engine as jax_engine
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.models import clip_mask_adapted as jax_adapted
from openvis_tpu.models import postprocess as jax_post
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu.train import build_model as jax_build_model
from openvis_tpu_torch import clip_towers, engine, train, weights
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, params_from_flax
from openvis_tpu_torch.data import catalog, rle, synthetic
from openvis_tpu_torch.models import clip_adapter, clip_mask_adapted, postprocess
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from test_torch_port_clip_ensemble import _cfg as ensemble_cfg
from test_torch_port_clip_ensemble import _masks
from test_torch_port_openvis import openvis_cfg
from tools import convert_weights as tool
from torch_port_common import one_thread_fixture, rel

one_thread = one_thread_fixture()

DEPTH = 3            # the ViT file's prompt table; the towers take its first `depth` rows
DATASET = "torch_port_mask_adapted_synth"
# (height, width, frames, instances); 11 frames, no multiple of 8
VIDEOS = [(48, 64, 11, 2), (72, 96, 3, 1)]
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}, {"id": 3, "name": "c3"}]
K, D = len(CATEGORIES), 32  # the tiny towers' embed width
# f32, the same arithmetic in another order (XLA against ATen), observed on
# the CPU: the towers' features within 4e-7 (ViT), 1.1e-6 (ModifiedResNet) and
# 7e-7 (RN text tower) of their largest, the 100 x cosine logits (~34 at most)
# within 1.6e-5, the engines' scores within 1.3e-6
FEAT_REL_TO_MAX = 1e-5
LOGIT_ATOL = 1e-4
# bf16 under amp_cast: both packages round the folded BatchNorms' scales and
# biases to bf16 and run the convs in bf16 with f32 affines; observed 9.0e-3 of
# the largest feature
BF16_REL_TO_MAX = 5e-2
# tests/test_torch_port_engine.py's f32 bounds for the engine
SCORE_ATOL = 2e-3
MASK_AGREE = 0.999
METRIC_ATOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The ViT CLIP with prompt tables of depth 3 and 2, and the
    ModifiedResNet, each read by the port's and the tool's readers."""
    root = str(tmp_path_factory.mktemp("mask_adapted"))
    out = {"root": root}
    for key, name, depth in (("test-tiny", "test-tiny", DEPTH), ("test-tiny-d2", "test-tiny", 2),
                             ("test-tiny-rn", "test-tiny-rn", 0)):
        state = clip_synthetic.openai_state_dict(name, seed=2, dtype=torch.float32,
                                                 mask_prompt_depth=depth)
        path = os.path.join(root, f"{key}.pt")
        torch.save(state, path)
        d = {k: v.numpy() for k, v in state.items()}
        out[key] = (path, weights.convert_clip(d), tool.convert_clip(d))
    return out


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def _vit(depth):
    s = clip_model.model_shape("test-tiny")
    args = (s["vision_patch"], s["vision_width"], s["vision_layers"], s["vision_heads"],
            s["embed_dim"], s["image_size"])
    jv = jax_adapted.MaskAdaptedVisual(*args, mask_prompt_depth=depth)
    return clip_mask_adapted.MaskAdaptedVisual(*args, mask_prompt_depth=depth), jv


def test_mask_adapted_vit_matches_jax(files):
    """Soft masks with a zero band (a crop that runs out of the frame), an
    all-zero mask, at prompt depths 1 and 2 on the pretrain grid (64 px: 8x8
    patches) and 3 on another (80 px: 10x10, the table's first token
    broadcast); the prompt moves only the crops it marks, and without a mask
    the tower is the plain ViT."""
    _, tree, _ = files["test-tiny"]
    rng = np.random.RandomState(0)
    for depth, hw in ((1, 64), (2, 64), (3, 80)):
        vtree = dict(tree["visual"], mask_embedding=tree["visual"]["mask_embedding"][:depth])
        pv, jv = _vit(depth)
        pv.load_state_dict(params_from_flax(vtree), strict=True)
        x = rng.randn(3, hw, hw, 3).astype(np.float32)
        m = (0.05 + 0.9 * rng.rand(3, hw, hw)).astype(np.float32)  # sigmoid-like: > 0
        m[1, :, hw // 2:] = 0.0   # out of the frame: background patches
        m[2] = 0.0
        ref = np.asarray(jax.jit(lambda p, x, m: jv.apply({"params": p}, x, m))(vtree, x, m))
        plain = clip_model.vision_tower("test-tiny")
        plain.load_state_dict(params_from_flax(
            {k: v for k, v in vtree.items() if k != "mask_embedding"}), strict=True)
        with torch.no_grad():
            got = pv(torch.from_numpy(x), torch.from_numpy(m)).numpy()
            got_plain = pv(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got_plain, plain(torch.from_numpy(x)).numpy())
        assert rel(got, ref) <= FEAT_REL_TO_MAX, (depth, hw, rel(got, ref))
        # every patch marked: the prompt changes nothing; a band or all of it
        # background: the table's rows replace those patches
        np.testing.assert_allclose(got[0], got_plain[0], rtol=0, atol=1e-5)
        assert np.abs(got[1:] - got_plain[1:]).min(axis=1).max() > 1e-3


def test_modified_resnet_matches_jax(files):
    """The RN tower unmasked, half-masked and all-covered (NaN in the same
    rows), and in bf16 under ``amp_cast``; the port's reader against the
    tool's (the same tree); the RN text tower against JAX's."""
    path, tree, ref_tree = files["test-tiny-rn"]
    _tree_equal(tree, ref_tree)
    s = clip_model.model_shape("test-tiny-rn")
    jv = jax_adapted.MaskAdaptedModifiedResNet(layers=s["vision_layers"], width=s["vision_width"],
                                               embed_dim=s["embed_dim"], heads=s["vision_heads"],
                                               image_size=s["image_size"])
    rng = np.random.RandomState(1)
    x = rng.randn(5, 64, 64, 3).astype(np.float32)
    m = rng.rand(5, 64, 64).astype(np.float32)
    m[0] = 0.0                 # no key masked but the fork's last
    m[1, :, :32] = 0.9         # half the grid
    m[1, :, 32:] = 0.1
    m[2] = 0.9                 # all four cells: every key masked
    m[3, :32] = 0.9            # the top row, patch 0 too: the mean token's key masked
    m[3, 32:] = 0.2
    japply = jax.jit(lambda p, x, m: (jv.apply({"params": p}, x, m), jv.apply({"params": p}, x)))
    cfg = port_config.Config()
    for amp in (False, True):
        ca = dataclasses.replace(cfg.model.clip_adapter, name="bg_adapted",
                                 clip_model_name="test-tiny-rn", weights=path)
        pcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, clip_adapter=ca, test=dataclasses.replace(cfg.model.test, amp=amp)))
        jcfg = jax_config.Config()
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, test=dataclasses.replace(jcfg.model.test, amp=amp)))
        dt, jdt = (torch.bfloat16, jnp.bfloat16) if amp else (torch.float32, jnp.float32)
        # the casts under one jit: eagerly each leaf's shape compiles its own
        vtree = jax.jit(lambda t: jax_towers.amp_cast(jcfg, t))(ref_tree["visual"])
        ref, ref_plain = (np.asarray(a, np.float32) for a in japply(
            vtree, jnp.asarray(x, jdt), jnp.asarray(m, jdt)))
        pvis = clip_towers.build_clip_visual(pcfg, "cpu")
        got = pvis(torch.from_numpy(x).to(dt), torch.from_numpy(m).to(dt)).float().numpy()
        got_plain = pvis(torch.from_numpy(x).to(dt)).float().numpy()
        nan = np.isnan(ref).any(axis=1)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert nan.tolist() == [False, False, True, False, False]
        bound = BF16_REL_TO_MAX if amp else FEAT_REL_TO_MAX
        assert rel(got[~nan], ref[~nan]) <= bound, (amp, rel(got[~nan], ref[~nan]))
        assert rel(got_plain, ref_plain) <= bound, (amp, rel(got_plain, ref_plain))
    # the text tower of an RN CLIP: text width 64, embed 32 (RN50: 512, 1024)
    text = tree["text"]
    vocab = text["token_embedding"]["embedding"].shape[0]
    ctx = text["positional_embedding"].shape[0]
    enc = clip_model.text_tower("test-tiny-rn", vocab, ctx)
    enc.load_state_dict(params_from_flax(text), strict=True)
    jenc = jax_clip.CLIPTextEncoder(vocab_size=vocab, context_length=ctx, width=s["text_width"],
                                    heads=s["text_heads"], layers=s["text_layers"],
                                    embed_dim=s["embed_dim"])
    tokens = rng.randint(1, vocab - 1, size=(4, ctx))
    tokens[np.arange(4), [3, 5, ctx - 1, 1]] = vocab - 1  # the EOT, highest id
    ref = np.asarray(jax.jit(lambda p, t: jenc.apply({"params": p}, t))(ref_tree["text"], tokens))
    with torch.no_grad():
        got = enc(torch.from_numpy(tokens)).numpy()
    assert got.shape == (4, s["embed_dim"]) and rel(got, ref) <= FEAT_REL_TO_MAX


def _score_cfgs(mod, **ca):
    cfg = mod.Config()
    ca = dataclasses.replace(cfg.model.clip_adapter, crop_sampling_ratio=2,
                             mask_prompt_depth=DEPTH, **ca)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, clip_adapter=ca, test=dataclasses.replace(cfg.model.test, amp=False)))


def test_adapted_crop_classifier_matches_jax(files):
    """``make_openvis_score_fn`` through each adapted tower, the prompt
    forwarded and not, mask stride 4, sampling ratio 2, on 64x96 frames
    whose masks' square boxes run out of the frame in some slots: the ViT's
    prompt moves just those crops (in the frame the sigmoid masks mark
    every patch), the ModifiedResNet's moves crops wherever they pass 0.5."""
    rng = np.random.RandomState(2)
    frames = (rng.rand(2, 64, 96, 3) * 255).astype(np.float32)
    masks = _masks(rng, 2, 4, 16, 24)
    logits = np.log(masks) - np.log1p(-masks)       # the score fn takes mask logits
    text = rng.randn(K + 1, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    args = (torch.from_numpy(frames), torch.from_numpy(logits), torch.from_numpy(text))
    for tower in ("test-tiny", "test-tiny-rn"):
        got = {}
        for fwd in (True, False):
            kw = dict(name="adapted", clip_model_name=tower, weights=files[tower][0],
                      mask_prompt_fwd=fwd)
            pcfg, jcfg = _score_cfgs(port_config, **kw), _score_cfgs(jax_config, **kw)
            pvis = clip_towers.build_clip_visual(pcfg, "cpu")
            jvis, adapted = jax_towers.build_clip_visual(jcfg)
            assert adapted
            lg, vd = clip_towers.make_openvis_score_fn(pcfg, pvis)(*args)
            jlg, jvd = jax.jit(jax_towers.make_openvis_score_fn(jcfg, jvis))(
                *(jnp.asarray(a) for a in (frames, logits, text)))
            np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"{tower} mask_prompt_fwd={fwd}")
            got[fwd] = lg.numpy()
        moved = np.abs(got[True] - got[False]).max(axis=-1)    # (T, Q)
        if tower == "test-tiny":
            # the crops with a patch of zeros, out of the frame (8 px patches)
            probs = torch.sigmoid(args[1])
            out = np.stack([(F.avg_pool2d(clip_adapter.roi_crop(
                f[..., None], clip_adapter.mask_square_boxes(f)[0] * 1.0, 64, 2)[..., 0][:, None],
                8, 8).flatten(1) == 0).any(dim=1).numpy() for f in probs])
            assert out.any() and not out.all(), out
            assert (moved[out] > 1e-3).all() and moved[~out].max() <= 1e-4, (moved, out)
        else:
            assert (moved > 1e-3).any(), moved


def _engine_cfg(mod, root, out, arch):
    """OpenVISOnline with the ``adapted`` ViT (prompt depth 2), or
    SimpleBaselineOnline's ensemble with the ``bg_adapted`` ModifiedResNet;
    windows of 4, f32, on the 64x96 canvas."""
    if arch == "openvis":
        cfg = openvis_cfg(mod.Config)
        ca = dataclasses.replace(cfg.model.clip_adapter, name="adapted",
                                 clip_model_name="test-tiny", mask_prompt_depth=2,
                                 weights=os.path.join(root, "test-tiny-d2.pt"))
        test = dataclasses.replace(cfg.model.test, window_inference=True, window_size=4,
                                   max_frames=16, amp=False)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, test=test, clip_adapter=ca),
            input=dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                                      pad_size=(64, 96), max_instances=6))
    else:
        cfg = ensemble_cfg(mod, root, out)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_classes=K, clip_adapter=dataclasses.replace(
                cfg.model.clip_adapter, name="bg_adapted", clip_model_name="test-tiny-rn",
                weights=os.path.join(root, "test-tiny-rn.pt"))))
    return dataclasses.replace(cfg, datasets=dataclasses.replace(cfg.datasets, root=root,
                                                                 test=(DATASET,)),
                               output_dir=os.path.join(root, f"{arch}_{out}"))


def _predictions(cfg):
    with open(os.path.join(cfg.output_dir, f"results_{DATASET}.json")) as f:
        return json.load(f)


def test_evaluate_dataset_with_adapted_towers_matches_jax(files):
    """Both engines, each against JAX's: the predictions (the NaN-scored
    ones, from all-covered ModifiedResNet crops, ranked as JAX ranks them)
    and the metrics.  First the top-k's order itself: ties to the lower
    index, the NaNs the CPU computes below every number."""
    scores = torch.rand(6, 4, generator=torch.Generator().manual_seed(4))
    scores[1] = scores[4, 2]                                         # ties
    scores[[0, 3]] = torch.softmax(torch.full((2, 4), float("-inf")), dim=-1)  # NaN rows
    masks = torch.randn(6, 2, 4, 4)
    got = postprocess.inference_video_topk(scores, masks, 10)
    ref = jax_post.inference_video_topk(jnp.asarray(scores.numpy()), jnp.asarray(masks.numpy()),
                                        10)
    np.testing.assert_array_equal(got["query_idx"].numpy(), np.asarray(ref["query_idx"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))
    assert torch.isnan(postprocess.inference_video_topk(scores, masks, 24)["scores"][-8:]).all()

    root = files["root"]
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    jax_catalog.register(jax_catalog.DatasetInfo(**dataclasses.asdict(info)))
    rng = np.random.RandomState(3)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    nan_scores = 0
    for arch in ("openvis", "simplebsl"):
        pcfg, jcfg = (_engine_cfg(mod, root, out, arch)
                      for mod, out in ((port_config, "port"), (jax_config, "jax")))
        model = init_params(train.build_model(pcfg, device="cpu"), seed=1)
        params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
        jvis, adapted = jax_engine.build_clip_visual(jcfg)
        assert adapted
        pvis = clip_towers.build_clip_visual(pcfg, "cpu")
        jmet = jax_engine.evaluate_dataset(jcfg, jax_build_model(jcfg), params, DATASET, text,
                                           clip_visual_apply=jvis)
        pmet = engine.evaluate_dataset(pcfg, model, DATASET, text, clip_visual_apply=pvis,
                                       device="cpu")
        jpred, ppred = _predictions(jcfg), _predictions(pcfg)
        assert 0 < len(ppred) <= 10 * len(VIDEOS)
        assert [(p["video_id"], p["category_id"]) for p in ppred] == \
            [(p["video_id"], p["category_id"]) for p in jpred], arch
        for p, j in zip(ppred, jpred):
            assert np.isnan(p["score"]) == np.isnan(j["score"]), arch
            assert np.isnan(p["score"]) or abs(p["score"] - j["score"]) <= SCORE_ATOL, arch
            mp = np.stack([rle.decode(s) for s in p["segmentations"]])
            mj = np.stack([rle.decode(s) for s in j["segmentations"]])
            assert (mp == mj).mean() >= MASK_AGREE, arch
            nan_scores += np.isnan(p["score"])
        assert len(ppred[0]["segmentations"]) == VIDEOS[0][2]
        assert set(pmet) == set(jmet) >= {"AP", "AP50", "AR10"}
        for k in jmet:
            assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL or (
                np.isnan(pmet[k]) and np.isnan(jmet[k])), (arch, k)
    assert nan_scores  # the all-covered crops reached the ensemble's scores
