"""PyTorch port, the reader of the JAX package's flax ``.msgpack`` files
(``utils/flax_msgpack.py``): trees written by ``flax.serialization`` and by
``tools/convert_weights.save_msgpack`` read back bit-equal (f32, bf16, int32,
0-d arrays, numpy scalars, a chunked leaf); truncated and malformed files
refused; a converted Mask2Former tree into the segmenter through the CLI and
a converted CLIP tree into the tower, equal to the ``.pkl`` and ``.pt``
routes; ``--weights x.msgpack`` over the whole model; and, in a fresh
interpreter, a read that imports neither ``msgpack`` nor JAX."""

import dataclasses
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_net_torch
from openvis_tpu_torch import Config, clip_towers, train
from openvis_tpu_torch.convert import flax_from_state_dict, init_params, params_from_flax
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from openvis_tpu_torch.models.clip.build import build_clip_params
from openvis_tpu_torch.utils import flax_msgpack
from tests.test_convert_weights import _d2_state
from test_torch_port_weights import D, DEC, ENC, HID, tiny_config
from tools.convert_weights import convert_clip, convert_mask2former, save_msgpack

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(rng):
    bf16 = np.asarray(jnp.asarray(rng.randn(3, 5), jnp.bfloat16))
    return {  # chunked at a MAX_CHUNK_SIZE of 200 bytes: the two "chunked" leaves
        "dense": {"kernel": rng.randn(4, 6).astype(np.float32),
                  "bias": rng.randn(6).astype(np.float32)},
        "half": {"kernel": bf16, "scale": np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16))},
        "ids": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "logit_scale": np.asarray(4.6, np.float32),            # a 0-d array
        "step": np.int64(12), "temperature": np.float32(0.07),  # numpy scalars
        "chunked": rng.randn(9, 7).astype(np.float32),
        "chunked_bf16": np.asarray(jnp.asarray(rng.randn(40, 3), jnp.bfloat16)),
        **{f"block{i}": {"w": rng.randn(2).astype(np.float16)} for i in range(20)},  # map16
    }


def _equal(got, ref, path=""):
    assert type(got) is dict and set(got) == set(ref), path
    for k, r in ref.items():
        g, p = got[k], f"{path}/{k}"
        if isinstance(r, dict):
            _equal(g, r, p)
        elif r.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16, p
            assert tuple(g.shape) == r.shape, p
            assert np.array_equal(g.view(torch.int16).numpy(), r.view(np.int16)), p
        else:
            assert type(g) is type(r) and g.dtype == r.dtype and np.shape(g) == np.shape(r), p
            assert np.array_equal(g, r), p


@pytest.mark.parametrize("writer", ["flax", "tool"])
def test_trees_read_back_bit_equal(writer, tmp_path, monkeypatch):
    """A chunked leaf: flax splits arrays above MAX_CHUNK_SIZE bytes (2^30),
    lowered here so that the two ``chunked`` leaves split and the others do
    not."""
    tree = _tree(np.random.RandomState(0))
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 200)
    path = tmp_path / "tree.msgpack"
    if writer == "flax":
        path.write_bytes(flax.serialization.msgpack_serialize(tree))
    else:
        save_msgpack(tree, str(path))
    assert path.read_bytes().count(b"__msgpack_chunked_array__") == 2
    got = flax_msgpack.read_msgpack(str(path))
    _equal(got, tree)
    _equal(got, flax.serialization.msgpack_restore(path.read_bytes()))


def test_truncated_and_malformed_files_raise(tmp_path):
    data = flax.serialization.msgpack_serialize(_tree(np.random.RandomState(1)))
    cases = {"empty": (b"", "truncated"), "cut": (data[:-7], "truncated"),
             "header": (data[:3], "truncated"), "trailing": (data + b"\x00", "after the tree"),
             "reserved": (b"\xc1", "0xc1")}
    for name, (blob, why) in cases.items():
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=why) as err:
            flax_msgpack.read_msgpack(str(path))
        assert str(path) in str(err.value), name


@pytest.fixture(scope="module")
def state():
    """tests/test_torch_port_weights.py's d2 state with SimpleBaseline's CLIP
    embedding head."""
    rng = np.random.RandomState(1)
    d = _d2_state(rng, hidden=HID, enc=ENC, dec=DEC)
    p = "sem_seg_head.predictor.class_embed"
    del d[f"{p}.weight"], d[f"{p}.bias"]
    for i, (o, c) in enumerate(((2 * D, HID), (D, 2 * D))):
        d[f"{p}.layers.{i}.weight"] = (0.05 * rng.randn(o, c)).astype(np.float32)
        d[f"{p}.layers.{i}.bias"] = rng.randn(o).astype(np.float32)
    return d


def _segmenter(cfg):
    model = init_params(train.build_model(cfg, device="cpu"), seed=0)
    with torch.no_grad():
        model.non_object_embedding.fill_(0.5)
    train_net_torch.pretrained_init(cfg, model)
    return model


def test_m2f_msgpack_loads_into_the_segmenter_like_the_pkl(state, tmp_path):
    """``model.weights`` naming a converted tree: the segmenter equals the
    ``.pkl`` route's; outside it the init stays.  A tree with the COCO class
    head (the tool's default) loads all but that head, as flax's apply
    leaves an unknown subtree out."""
    pkl = tmp_path / "m2f.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": state}, f)
    tree = convert_mask2former(state, depth=50, enc_layers=ENC, dec_layers=DEC,
                               head="embedding")
    save_msgpack(tree, str(tmp_path / "m2f.msgpack"))
    ref = _segmenter(tiny_config(str(pkl))).state_dict()
    got = _segmenter(tiny_config(str(tmp_path / "m2f.msgpack"))).state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    assert (got["non_object_embedding"] == 0.5).all()

    coco = _d2_state(np.random.RandomState(2), hidden=HID, enc=ENC, dec=DEC)
    save_msgpack(convert_mask2former(coco, depth=50, enc_layers=ENC, dec_layers=DEC),
                 str(tmp_path / "coco.msgpack"))
    fresh = init_params(train.build_model(tiny_config(), device="cpu"), seed=0).state_dict()
    loaded = _segmenter(tiny_config(str(tmp_path / "coco.msgpack"))).state_dict()
    want = params_from_flax(convert_mask2former(coco, depth=50, enc_layers=ENC,
                                                dec_layers=DEC, head="embedding"))
    for k, v in loaded.items():
        if k.startswith("segmenter.predictor.heads.class_embed."):
            assert torch.equal(v, fresh[k]), k           # the init
        elif k.startswith("segmenter."):
            assert torch.equal(v, want[k[len("segmenter."):]]), k


def test_weights_msgpack_over_the_whole_model(tmp_path):
    """``--weights x.msgpack`` (eval or resume): the whole tree over the model
    (JAX ``train_net.py:223-231``), bf16 leaves included; a tree that holds
    none of the model's tensors is refused."""
    cfg = tiny_config()
    src = init_params(train.build_model(cfg, device="cpu"), seed=4)
    tree = flax_from_state_dict(src.state_dict())
    tree["non_object_embedding"] = np.asarray(jnp.asarray(tree["non_object_embedding"],
                                                          jnp.bfloat16))
    save_msgpack(tree, str(tmp_path / "whole.msgpack"))
    model = init_params(train.build_model(cfg, device="cpu"), seed=5)
    train_net_torch.load_weights_file(model, str(tmp_path / "whole.msgpack"), cfg)
    for k, v in src.state_dict().items():
        if k == "non_object_embedding":
            assert torch.equal(model.state_dict()[k], v.bfloat16().float())
        else:
            assert torch.equal(model.state_dict()[k], v), k
    save_msgpack({"backbone": tree["segmenter"]["backbone"]}, str(tmp_path / "stray.msgpack"))
    with pytest.raises(SystemExit, match="refusing"):
        train_net_torch.load_weights_file(model, str(tmp_path / "stray.msgpack"), cfg)


def test_clip_msgpack_equals_the_pt_route(tmp_path):
    """``clip_adapter.weights`` naming the tool's converted CLIP tree: the
    tree and the tower equal the ``.pt`` route's."""
    sd = clip_synthetic.openai_state_dict("test-tiny", seed=3, dtype=torch.float32)
    pt, mp = str(tmp_path / "clip.pt"), str(tmp_path / "clip.msgpack")
    torch.save(sd, pt)
    save_msgpack(convert_clip({k: v.numpy() for k, v in sd.items()}), mp)
    ref, got = dict(params_from_flax(build_clip_params(pt))), params_from_flax(
        build_clip_params(mp))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, test=dataclasses.replace(cfg.model.test, amp=False),
        clip_adapter=dataclasses.replace(cfg.model.clip_adapter, clip_model_name="test-tiny")))
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32))
    outs = []
    for path in (pt, mp):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, clip_adapter=dataclasses.replace(cfg.model.clip_adapter, weights=path)))
        outs.append(clip_towers.build_clip_visual(c, "cpu")(x))
    assert torch.equal(outs[0], outs[1])


def test_reader_imports_neither_msgpack_nor_jax(tmp_path):
    path = tmp_path / "tree.msgpack"
    tree = dict(_tree(np.random.RandomState(2)),
                wide=np.linspace(0, 1, 70000, dtype=np.float64))  # a bin32 of 560,000 bytes
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from openvis_tpu_torch.utils.flax_msgpack import read_msgpack
        tree = read_msgpack({str(path)!r})
        assert tree["half"]["kernel"].dtype.__str__() == "torch.bfloat16"
        assert tree["chunked"].shape == (9, 7), tree["chunked"].shape
        assert tree["wide"][-1] == 1.0 and tree["wide"].shape == (70000,)
        leaked = [m for m in ("msgpack", "jax", "flax", "openvis_tpu") if m in sys.modules]
        assert not leaked, leaked
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
