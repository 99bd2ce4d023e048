"""PyTorch port, the reference-weight readers: ``openvis_tpu_torch/weights.py``
against ``tools/convert_weights.py`` on the synthetic d2 Mask2Former state
dict of ``tests/test_convert_weights.py`` (with SimpleBaseline's CLIP
embedding head in place of the COCO class head), the same tree leaf for leaf,
loaded strictly into the port's segmenter; the ``.pkl``/``.pth`` readers, the
legacy-key migration, the video decoder filled strictly, the CLI's pretrained
init, and the readers that are not ported yet."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import train_net_torch
from openvis_tpu_torch import Config, train, weights
from openvis_tpu_torch.convert import _flatten, params_from_flax
from tests.test_convert_weights import _d2_state
from tools.convert_weights import convert_mask2former as tool_convert

HID, D, ENC, DEC = 64, 32, 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_config(weights_path: str = "") -> Config:
    cfg = Config()
    m = dataclasses.replace(
        cfg.model, num_classes=7, weights=weights_path,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=ENC,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="frame_embedding", hidden_dim=HID,
            num_queries=8, nheads=4, dim_feedforward=128, dec_layers=DEC, mask_dim=HID,
            clip_embed_dim=D))
    return dataclasses.replace(cfg, model=m)


@pytest.fixture(scope="module")
def state():
    rng = np.random.RandomState(1)
    d = _d2_state(rng, hidden=HID, enc=ENC, dec=DEC)
    p = "sem_seg_head.predictor.class_embed"
    del d[f"{p}.weight"], d[f"{p}.bias"]
    for i, (o, c) in enumerate(((2 * D, HID), (D, 2 * D))):
        d[f"{p}.layers.{i}.weight"] = (0.05 * rng.randn(o, c)).astype(np.float32)
        d[f"{p}.layers.{i}.bias"] = rng.randn(o).astype(np.float32)
    return d


def _convert(fn, d):
    return fn(d, depth=50, enc_layers=ENC, dec_layers=DEC, head="embedding")


def test_same_tree_as_the_tool_and_a_strict_load(state):
    ref = dict(_flatten(_convert(tool_convert, state)))
    got = dict(_flatten(_convert(weights.convert_mask2former, state)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    model = train.build_model(tiny_config(), device="cpu")
    sd = params_from_flax(_convert(weights.convert_mask2former, state))
    model.segmenter.load_state_dict(sd, strict=True)
    assert any(k.startswith("predictor.heads.class_embed.layer1") for k in sd)


def test_pkl_and_pth_readers_and_legacy_keys(state, tmp_path):
    cfg = tiny_config()
    ref = params_from_flax(_convert(tool_convert, state))
    legacy = {k.replace("sem_seg_head.pixel_decoder.", "sem_seg_head.")
                .replace("predictor.query_feat", "predictor.static_query"): v
              for k, v in state.items()}
    pkl = tmp_path / "m2f.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": legacy, "__author__": "d2"}, f)
    pth = tmp_path / "m2f.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()},
                "iteration": 3}, pth)
    for path in (pkl, pth):
        got = weights.segmenter_state(str(path), cfg)
        assert set(got) == set(ref), path
        for k, v in ref.items():
            assert torch.equal(got[k], v), (path, k)


def test_pkl_reader_fills_the_video_decoder_strictly(state, tmp_path):
    """The video decoder's parameters have the frame decoder's names: a d2
    checkpoint fills offline SimpleBaseline's segmenter strictly."""
    path = tmp_path / "m2f.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": state}, f)
    cfg = tiny_config(str(path))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="SimpleBaseline",
        transformer_decoder=dataclasses.replace(cfg.model.transformer_decoder,
                                                name="video_embedding")))
    model = train.build_model(cfg, device="cpu")
    assert model.segmenter.video
    sd = weights.segmenter_state(str(path), cfg)
    model.segmenter.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.segmenter.state_dict())


def test_cli_pretrained_init_grafts_the_segmenter(state, tmp_path):
    path = tmp_path / "m2f.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": state}, f)
    cfg = tiny_config(str(path))
    model = train.build_model(cfg, device="cpu")
    with torch.no_grad():
        model.non_object_embedding.fill_(0.5)
    train_net_torch.pretrained_init(cfg, model)
    ref = params_from_flax(_convert(tool_convert, state))
    for k, v in ref.items():
        assert torch.equal(model.segmenter.state_dict()[k], v), k
    # outside the segmenter: kept
    assert (model.non_object_embedding == 0.5).all()


def test_unported_readers_raise(tmp_path):
    with pytest.raises(ValueError, match="msgpack"):
        weights.load_torch_state(str(tmp_path / "converted.msgpack"))
    # the Swin and timm ResNet readers are ported (tests/test_torch_port_swin.py):
    # they read the state dict, whose first key is missing here
    with pytest.raises(KeyError, match="backbone.patch_embed.proj.weight"):
        weights.convert_mask2former({}, backbone="swin")
    with pytest.raises(KeyError, match="conv1.weight"):
        weights.convert_timm_resnet({})
    # the ViT and the ModifiedResNet CLIP readers are ported
    # (tests/test_torch_port_clip.py, tests/test_torch_port_mask_adapted.py):
    # an RN state dict is read as an RN tree, whose next key is missing here
    with pytest.raises(KeyError, match="visual.bn1.weight"):
        weights.convert_clip({"visual.layer1.0.conv1.weight": np.zeros((64, 3, 3, 3)),
                              "visual.conv1.weight": np.zeros((32, 3, 3, 3))})
