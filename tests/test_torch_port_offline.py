"""PyTorch port, the offline (clip-level) architectures against the JAX package
on the CPU in f32: the 3-D position encoding and offline SimpleBaseline's
loss and gradients to every parameter here; the shapes, weights and helpers
of the offline tests split off so that no file holds more than 4: the
video-mode decoder with each of its four heads (``class``, ``embedding``,
``proposal``, ``side_adapter``) on B=2 clips of T=3 frames
(``test_torch_port_offline_decoder.py``: its forward;
``_decoder_grads.py``: its gradients to the parameters and the inputs;
``_tree.py``: its parameter tree, groups and the class head's init), the
forward, loss and gradients to their outputs of VideoMaskFormer, MinVIS and
offline OpenVIS (``video_proposal``, ``frame_proposal``; ``_archs.py``),
offline SAN's forward and its loss's named error and the CLI with an offline
SimpleBaseline yaml (``_san.py``).

Shapes: the tiny segmenter of ``tests/test_torch_parity_e2e.py`` (64x96
frames, 2 encoder and 2 decoder layers, Q=8, hidden 64) on T=3 frames; SAN's
tiny CLIP of ``tests/test_torch_port_san.py``.  One set of weights, the
port's seeded init with random norm affines and sampling-offset kernels, goes
into both packages (``convert.flax_from_state_dict``), so JAX's init never
compiles; each JAX reference is one ``jax.jit``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.models.transformer_decoder as jax_td
import openvis_tpu.train as jax_train
import train_net_torch
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models.clip import model as jax_clip
from openvis_tpu.models.position_encoding import position_encoding_3d as jax_pe3d
from openvis_tpu.parallel.train_step import label_params as jax_label_params
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
)
from openvis_tpu_torch.models import transformer_decoder as td
from openvis_tpu_torch.models.clip import model as clip_model
from openvis_tpu_torch.models.meta import san
from openvis_tpu_torch.models.position_encoding import position_encoding_3d
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets
from test_torch_port_cli import CFG_YAML, cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import TINY, TINY_CLIP, san_cfg

K, D, B, T, H, W, HID, Q, N, POINTS = 5, 32, 1, 3, 64, 96, 64, 8, 3, 32
NHEADS, CLIP_HEADS = 4, 4
DEC_B, DEC_LAYERS = 2, 3        # the decoder alone: 2 clips, all three levels and back
LEVELS = ((2, 3), (4, 6), (8, 12))  # the token maps, top-down; mask features at 16x24
PE_ATOL = 1e-6
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
DECODER_REL_TO_MAX = 1e-4
FORWARD_REL_TO_MAX = 1e-4  # the whole model, ~60 layers deep
LOSS_RTOL = 1e-5
GRAD_REL_NORM = 1e-2       # tests/test_torch_port_train_step.py's bound (JAX's own f32 error)
HEADS = ("class", "embedding", "proposal", "side_adapter")
ARCHS = {  # id -> (meta architecture, decoder, num_classes)
    "video_maskformer": ("VideoMaskFormer", "video", K),
    "minvis": ("MinVIS", "frame", K),
    "simple_baseline": ("SimpleBaseline", "video_embedding", K),
    "openvis_video": ("OpenVIS", "video_proposal", 1),
    "openvis_frame": ("OpenVIS", "frame_proposal", 1),
}


@pytest.fixture(scope="module", autouse=True)
def tiny_clip():
    """One intra-op thread (the test workers share the machine's cores) and
    SAN's tiny CLIP shape in both packages' tables."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip._MODEL_SHAPES, TINY, TINY_CLIP)
        mp.setitem(clip_model._MODEL_SHAPES, TINY, TINY_CLIP)
        yield
    torch.set_num_threads(threads)


def arch_cfg(cls, arch: str, decoder: str, num_classes: int):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=num_classes, meta_architecture=arch,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name=decoder, hidden_dim=HID, num_queries=Q,
            nheads=NHEADS, dim_feedforward=128, dec_layers=2, mask_dim=HID,
            clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=POINTS))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


def offline_san_cfg(cls):
    cfg = san_cfg(cls)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="SAN", transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="side_adapter_video")))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _grads_close(grads, jgrads):
    """Each port gradient within GRAD_REL_NORM of JAX's; parameters without a
    port gradient (the ResNet's frozen affines) have exact zeros in JAX.  An
    exact zero (``k_proj``'s bias: softmax is shift-invariant) is held to the
    f32 rounding of the largest gradient, 1e-5 at least."""
    assert set(grads) <= set(jgrads)
    assert all(not np.any(v) for k, v in jgrads.items() if k not in grads)
    zero = max(1e-5, 1e-6 * max(np.abs(v).max() for v in jgrads.values()))
    for k in grads:
        if k.endswith("k_proj/bias") or not np.any(jgrads[k]):
            assert np.abs(grads[k]).max() < zero and np.abs(jgrads[k]).max() < zero, k
            continue
        err = np.linalg.norm(grads[k] - jgrads[k]) / np.linalg.norm(jgrads[k])
        assert err <= GRAD_REL_NORM, (k, err)


@pytest.mark.parametrize("thwc", [(3, 4, 6, 64), (1, 2, 3, 16), (7, 5, 9, 32)])
def test_position_encoding_3d_matches_jax(thwc):
    ref = np.asarray(jax.jit(jax_pe3d, static_argnums=(0, 1, 2, 3))(*thwc))
    got = position_encoding_3d(*thwc).numpy()
    assert got.shape == thwc
    np.testing.assert_allclose(got, ref, rtol=0, atol=PE_ATOL)


# ---- the video-mode decoder alone ----

def _decoders(head):
    kw = dict(mode="video", head=head, hidden_dim=HID, num_queries=Q, nheads=NHEADS,
              dim_feedforward=128, dec_layers=DEC_LAYERS, mask_dim=HID, num_classes=K,
              clip_dim=D, clip_heads=CLIP_HEADS, in_channels=HID)
    return td.MaskedTransformerDecoder(**kw), jax_td.MaskedTransformerDecoder(**kw)


def _decoder_out_keys(head):
    return ("pred_masks_all",
            "class_attn_biases_all" if head == "side_adapter" else "pred_logits_all")


@pytest.fixture(scope="module")
def decoder_runs():
    """Each head's decoder on the same inputs in both packages: the outputs
    and the gradients of a fixed random projection of them to the parameters
    and the inputs (JAX: one jit for the four heads)."""
    rng = np.random.RandomState(4)
    xs = [rng.randn(DEC_B * T, h, w, HID).astype(np.float32) for h, w in LEVELS]
    mf = rng.randn(DEC_B, T, 16, 24, HID).astype(np.float32)
    ports, trees, weights = {}, {}, {}
    for i, head in enumerate(HEADS):
        port, _ = _decoders(head)
        init_params(port, seed=10 + i)
        with torch.no_grad():
            for name, p in port.named_parameters():
                if "norm" in name:
                    p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
        ports[head] = port
        trees[head] = jax.tree.map(jnp.asarray, flax_from_state_dict(port.state_dict()))
        with torch.no_grad():
            out = port([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs],
                       torch.from_numpy(mf).permute(0, 1, 4, 2, 3), T)
        weights[head] = {k: rng.randn(*out[k].shape).astype(np.float32)
                         for k in _decoder_out_keys(head)}

    def jax_all(trees, xs, mf):
        res = {}
        for head in HEADS:
            _, jdec = _decoders(head)

            def proj(p, xs, mf, head=head, jdec=jdec):
                out = jdec.apply({"params": p}, xs, mf, T)
                keys = _decoder_out_keys(head)
                return sum((out[k] * weights[head][k]).sum() for k in keys), \
                    {k: out[k] for k in keys}

            (_, outs), grads = jax.value_and_grad(proj, argnums=(0, 1, 2), has_aux=True)(
                trees[head], xs, mf)
            res[head] = (outs, grads)
        return res

    ref = jax.jit(jax_all)(trees, [jnp.asarray(x) for x in xs], jnp.asarray(mf))

    got = {}
    for head, port in ports.items():
        txs = [torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_() for x in xs]
        tmf = torch.from_numpy(mf).permute(0, 1, 4, 2, 3).requires_grad_()
        out = port(txs, tmf, T)
        keys = _decoder_out_keys(head)
        total = sum((out[k] * torch.from_numpy(weights[head][k])).sum() for k in keys)
        named = dict(port.named_parameters())
        gs = torch.autograd.grad(total, list(named.values()) + txs + [tmf])
        pgrads = dict(zip(named, gs[:len(named)]))
        got[head] = ({k: out[k].detach().numpy() for k in keys},
                     dict(_flat(flax_from_state_dict(pgrads))),
                     [g.permute(0, 2, 3, 1).numpy() for g in gs[len(named):-1]],
                     gs[-1].permute(0, 1, 3, 4, 2).numpy())
    return got, ref


# ---- the whole models ----

@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(7)
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    labels = rng.randint(0, K, (B, N))
    masks = rng.rand(B, N, T, H, W) > 0.7
    valid = np.array([[True, True, False]])
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]],
                                     -1).astype(np.float32)
        return table[(b, p)]

    return frames, text, labels, masks, valid, draw


def _port_model(cfg, seed):
    rng = np.random.RandomState(seed)
    model = init_params(train.build_model(cfg, device="cpu"), seed=seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or ".ln" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    return model


def _out_keys(decoder):
    return ("pred_logits_all", "pred_masks_all") + (
        ("pred_embeds",) if decoder.startswith("frame") else ())


def _batches(batch):
    frames, text, labels, masks, valid, _ = batch
    jbatch = {"pixels": jnp.asarray(frames.reshape(B, T, H, W, 3)),
              "text_feats": jnp.asarray(text),
              "targets": JaxTargets(labels=jnp.asarray(labels, jnp.int32),
                                    masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                                    frame_valid=jnp.ones((B, N, T), bool))}
    tbatch = {"pixels": torch.from_numpy(frames.reshape(B, T, H, W, 3)),
              "text_feats": torch.from_numpy(text),
              "targets": ClipTargets(torch.from_numpy(labels), torch.from_numpy(masks),
                                     torch.from_numpy(valid),
                                     torch.ones(B, N, T, dtype=torch.bool))}
    return jbatch, tbatch


def _check_forward(out, ref, decoder, ncls):
    l = 2 + 1
    assert out["pred_masks_all"].shape == (l, B, Q, T, 16, 24)
    lead = (l, B) if decoder.startswith("video") else (l, B, T)
    assert out["pred_logits_all"].shape == (*lead, Q, ncls + 1)
    for k in _out_keys(decoder):
        assert _rel(out[k].detach(), ref[k]) <= FORWARD_REL_TO_MAX, k


def _check_losses(loss, metrics, jloss, jmetrics):
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_offline_simple_baseline_loss_and_gradients_match_jax(batch):
    """Offline SimpleBaseline, as its recipe trains: the forward, the
    clip-level loss through each package's ``make_loss_fn`` and its gradients
    to every parameter, from one set of weights, batch and points."""
    arch, decoder, ncls = ARCHS["simple_baseline"]
    draw = batch[-1]
    cfg, jcfg = arch_cfg(Config, arch, decoder, ncls), arch_cfg(JaxConfig, arch, decoder, ncls)
    model = _port_model(cfg, seed=2)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
    jbatch, tbatch = _batches(batch)
    jm = jax_train.build_model(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, b, p: jnp.asarray(draw(b[0], p)))
        jloss_fn = jax_train.make_loss_fn(jcfg, jm, K)

        def ref_fn(p):
            out = jm.apply({"params": p}, jbatch["pixels"].reshape(B * T, H, W, 3), T,
                           jbatch["text_feats"])
            fn = lambda q: jloss_fn(q, jbatch, jax.random.PRNGKey(1))  # noqa: E731
            return {k: out[k] for k in _out_keys(decoder)}, \
                jax.value_and_grad(fn, has_aux=True)(p)

        jout, ((jloss, jmetrics), jgrads) = jax.jit(ref_fn)(params)

    with torch.no_grad():
        out = model(tbatch["pixels"].reshape(B * T, H, W, 3), T, tbatch["text_feats"])
    _check_forward(out, jout, decoder, ncls)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
    try:
        step = train.build_train_step(cfg, model, K, device="cpu",
                                      draw_points=lambda g, b, p: torch.from_numpy(draw(b[0], p)))
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        loss, metrics = step.loss_fn(dict(model.named_parameters()), tbatch, torch.Generator())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    finally:
        torch.backends.mkldnn.enabled = prev
    _check_losses(loss, metrics, jloss, jmetrics)
    grads = dict(_flat(flax_from_state_dict(grads)))
    head = "segmenter/predictor/heads/class_embed"
    assert np.any(grads[f"{head}/layer1/kernel"])
    _grads_close(grads, dict(_flat(jgrads)))


class _Outputs(torch.nn.Module):
    """A model that returns the given outputs: the loss closure on them."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, *args):
        return self.out


class _JaxOutputs:
    """The same for the JAX loss closure: its ``params`` are the outputs."""

    def apply(self, variables, *args, **kwargs):
        return dict(variables["params"]["out"])


LOSS_ARCHS = ("video_maskformer", "minvis", "openvis_video", "openvis_frame")


@pytest.fixture(scope="module")
def arch_runs(batch):
    """VideoMaskFormer, MinVIS and offline OpenVIS (both decoders): each
    package's forward from one set of weights, then its loss closure
    (``make_loss_fn``: the arch's loss, clip-level or per frame) on those
    outputs, with its gradients to them (JAX: one jit for the four)."""
    draw = batch[-1]
    jbatch, tbatch = _batches(batch)
    models, trees, jfns = {}, {}, {}
    for arch_id in LOSS_ARCHS:
        arch, decoder, ncls = ARCHS[arch_id]
        cfg, jcfg = (arch_cfg(Config, arch, decoder, ncls),
                     arch_cfg(JaxConfig, arch, decoder, ncls))
        models[arch_id] = (cfg, _port_model(cfg, seed=LOSS_ARCHS.index(arch_id)))
        trees[arch_id] = jax.tree.map(jnp.asarray,
                                      flax_from_state_dict(models[arch_id][1].state_dict()))
        jfns[arch_id] = (jax_train.build_model(jcfg),
                         jax_train.make_loss_fn(jcfg, _JaxOutputs(), K))

    def ref_fn(trees):
        res = {}
        for arch_id, (jm, jloss_fn) in jfns.items():
            out = jm.apply({"params": trees[arch_id]},
                           jbatch["pixels"].reshape(B * T, H, W, 3), T, jbatch["text_feats"])
            keys = _out_keys(ARCHS[arch_id][1])
            out = {k: out[k] for k in keys}
            fn = lambda o: jloss_fn({"out": o}, jbatch, jax.random.PRNGKey(1))  # noqa: E731
            res[arch_id] = (out, jax.value_and_grad(fn, has_aux=True)(
                {k: out[k] for k in ("pred_logits_all", "pred_masks_all")}))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, b, p: jnp.asarray(draw(b[0], p)))
        ref = jax.jit(ref_fn)(trees)

    got = {}
    for arch_id, (cfg, model) in models.items():
        with torch.no_grad():
            out = model(tbatch["pixels"].reshape(B * T, H, W, 3), T, tbatch["text_feats"])
        leaves = {k: out[k].clone().requires_grad_() for k in ("pred_logits_all",
                                                               "pred_masks_all")}
        loss_fn = train.make_loss_fn(cfg, _Outputs(leaves), K,
                                     lambda g, b, p: torch.from_numpy(draw(b[0], p)))
        loss, metrics = loss_fn({}, tbatch, torch.Generator())
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        got[arch_id] = (out, loss, metrics, grads)
    return got, ref


OFFLINE_YAML = CFG_YAML.replace("meta_architecture: SimpleBaselineOnline",
                                "meta_architecture: SimpleBaseline").replace(
    "name: frame_embedding", "name: video_embedding").replace(
    "test: {{window_inference: true, window_size: 4, topk_per_video: 5}}",
    "test: {{window_inference: false, max_frames: 8, topk_per_video: 5}}")
