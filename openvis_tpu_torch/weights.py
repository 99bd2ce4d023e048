"""Readers of reference-format weights: Detectron2 Mask2Former checkpoints.

A copy of ``tools/convert_weights.py``'s readers for the port (the tool
belongs to the JAX package, which the port does not import):

  * ``load_torch_state`` (``:420``): a d2 ``.pkl`` through ``pickle`` with
    ``latin1``, a ``.pth``/``.pt`` state dict through ``torch.load`` (tensors,
    numbers and strings only: ``weights_only=True``);
  * ``migrate_legacy_keys`` (``:269``), ``convert_resnet`` (``:88``),
    ``convert_pixel_decoder`` (``:188``), ``convert_predictor`` (``:219``) and
    ``convert_mask2former`` (``:288``, the ResNet backbone) build the same
    flax-layout tree as the tool, which ``convert.params_from_flax`` maps onto
    the port's ``state_dict`` keys (``segmenter_state``).

The Swin, timm-ResNet and CLIP readers are not ported yet and raise, naming
their ROADMAP.md item.  The JAX package's flax ``.msgpack`` files are not
read: convert the reference checkpoint itself.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import params_from_flax

BN_EPS = 1e-5


def _lin(d, name):
    return {
        "kernel": np.ascontiguousarray(d[f"{name}.weight"].T),
        "bias": d[f"{name}.bias"],
    }


def _conv(d, name, bias=True):
    out = {"kernel": np.ascontiguousarray(d[f"{name}.weight"].transpose(2, 3, 1, 0))}
    if bias and f"{name}.bias" in d:
        out["bias"] = d[f"{name}.bias"]
    return out


def _frozen_bn(d, name):
    w, b = d[f"{name}.weight"], d[f"{name}.bias"]
    mean, var = d[f"{name}.running_mean"], d[f"{name}.running_var"]
    scale = w / np.sqrt(var + BN_EPS)
    return {"scale": scale, "bias": b - mean * scale}


def _norm(d, name):  # GroupNorm / LayerNorm
    return {"scale": d[f"{name}.weight"], "bias": d[f"{name}.bias"]}


def _mha(d, name):
    """torch nn.MultiheadAttention -> q/k/v/out projections."""
    w = d[f"{name}.in_proj_weight"]
    b = d[f"{name}.in_proj_bias"]
    c = w.shape[1]
    qw, kw, vw = w[:c], w[c : 2 * c], w[2 * c :]
    qb, kb, vb = b[:c], b[c : 2 * c], b[2 * c :]
    return {
        "q_proj": {"kernel": np.ascontiguousarray(qw.T), "bias": qb},
        "k_proj": {"kernel": np.ascontiguousarray(kw.T), "bias": kb},
        "v_proj": {"kernel": np.ascontiguousarray(vw.T), "bias": vb},
        "out_proj": _lin(d, f"{name}.out_proj"),
    }


def _mlp(d, name, n_layers):
    return {
        f"layer{i}": _lin(d, f"{name}.layers.{i}") for i in range(n_layers)
    }


def convert_resnet(d: Dict[str, np.ndarray], depth: int = 50) -> Dict:
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    out = {
        "stem_conv1": _conv(d, "backbone.stem.conv1", bias=False),
        "stem_norm1": _frozen_bn(d, "backbone.stem.conv1.norm"),
    }
    for si, nb in enumerate(blocks):
        stage = f"res{si + 2}"
        for bi in range(nb):
            pre = f"backbone.{stage}.{bi}"
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = _conv(d, f"{pre}.conv{ci}", bias=False)
                blk[f"norm{ci}"] = _frozen_bn(d, f"{pre}.conv{ci}.norm")
            if f"{pre}.shortcut.weight" in d:
                blk["shortcut_conv"] = _conv(d, f"{pre}.shortcut", bias=False)
                blk["shortcut_norm"] = _frozen_bn(d, f"{pre}.shortcut.norm")
            out[f"{stage}_block{bi}"] = blk
    return out


def convert_pixel_decoder(d: Dict[str, np.ndarray], enc_layers: int = 6) -> Dict:
    p = "sem_seg_head.pixel_decoder"
    out = {"level_embed": d[f"{p}.level_embed"]}
    for i in range(3):
        out[f"input_proj{i}_conv"] = _conv(d, f"{p}.input_proj.{i}.0")
        out[f"input_proj{i}_norm"] = _norm(d, f"{p}.input_proj.{i}.1")
    enc = {}
    for i in range(enc_layers):
        lp = f"{p}.transformer.encoder.layers.{i}"
        enc[f"layer{i}"] = {
            "self_attn": {
                "sampling_offsets": _lin(d, f"{lp}.self_attn.sampling_offsets"),
                "attention_weights": _lin(d, f"{lp}.self_attn.attention_weights"),
                "value_proj": _lin(d, f"{lp}.self_attn.value_proj"),
                "output_proj": _lin(d, f"{lp}.self_attn.output_proj"),
            },
            "norm1": _norm(d, f"{lp}.norm1"),
            "linear1": _lin(d, f"{lp}.linear1"),
            "linear2": _lin(d, f"{lp}.linear2"),
            "norm2": _norm(d, f"{lp}.norm2"),
        }
    out["encoder"] = enc
    # FPN tail: d2 names adapter_1/layer_1 operate on res2 (we call it idx 0)
    out["adapter0_conv"] = _conv(d, f"{p}.adapter_1", bias=False)
    out["adapter0_norm"] = _norm(d, f"{p}.adapter_1.norm")
    out["layer0_conv"] = _conv(d, f"{p}.layer_1", bias=False)
    out["layer0_norm"] = _norm(d, f"{p}.layer_1.norm")
    out["mask_features"] = _conv(d, f"{p}.mask_features")
    return out


def convert_predictor(
    d: Dict[str, np.ndarray], dec_layers: int = 9, head: str = "class"
) -> Dict:
    p = "sem_seg_head.predictor"
    out = {
        "query_feat": d[f"{p}.query_feat.weight"],
        "query_embed": d[f"{p}.query_embed.weight"],
        "level_embed": d[f"{p}.level_embed.weight"],
    }
    heads = {
        "decoder_norm": {"scale": d[f"{p}.decoder_norm.weight"],
                         "bias": d[f"{p}.decoder_norm.bias"]},
        "mask_embed": _mlp(d, f"{p}.mask_embed", 3),
    }
    if head == "class" and f"{p}.class_embed.weight" in d:
        heads["class_embed"] = _lin(d, f"{p}.class_embed")
    if head == "embedding" and f"{p}.class_embed.layers.0.weight" in d:
        heads["class_embed"] = _mlp(d, f"{p}.class_embed", 2)
    if head == "side_adapter" and f"{p}.attn_embed.layers.0.weight" in d:
        heads["attn_embed"] = _mlp(d, f"{p}.attn_embed", 3)
    out["heads"] = heads
    if head == "side_adapter" and f"{p}.attn_mlp.layers.0.weight" in d:
        for i in range(3):
            out[f"attn_mlp{i}"] = {
                "kernel": np.ascontiguousarray(
                    d[f"{p}.attn_mlp.layers.{i}.weight"].transpose(2, 3, 1, 0)
                ),
                "bias": d[f"{p}.attn_mlp.layers.{i}.bias"],
            }
    for i in range(dec_layers):
        out[f"cross_attn{i}"] = {
            "multihead_attn": _mha(
                d, f"{p}.transformer_cross_attention_layers.{i}.multihead_attn"
            ),
            "norm": _norm(d, f"{p}.transformer_cross_attention_layers.{i}.norm"),
        }
        out[f"self_attn{i}"] = {
            "self_attn": _mha(
                d, f"{p}.transformer_self_attention_layers.{i}.self_attn"
            ),
            "norm": _norm(d, f"{p}.transformer_self_attention_layers.{i}.norm"),
        }
        out[f"ffn{i}"] = {
            "linear1": _lin(d, f"{p}.transformer_ffn_layers.{i}.linear1"),
            "linear2": _lin(d, f"{p}.transformer_ffn_layers.{i}.linear2"),
            "norm": _norm(d, f"{p}.transformer_ffn_layers.{i}.norm"),
        }
    return out


def migrate_legacy_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """d2 v<2 checkpoint key migration, matching the reference's
    ``_load_from_state_dict`` shims: bare ``sem_seg_head.*`` keys gain the
    ``pixel_decoder.`` prefix (``mask_former_head.py:23-45``) and
    ``static_query`` renames to ``query_feat``
    (``video_mask2former_transformer_decoder.py:224-245``)."""
    out = {}
    for k, v in state.items():
        nk = k
        if "static_query" in nk:
            nk = nk.replace("static_query", "query_feat")
        if "sem_seg_head." in nk and ".predictor." not in nk and (
            ".pixel_decoder." not in nk
        ):
            nk = nk.replace("sem_seg_head.", "sem_seg_head.pixel_decoder.")
        out[nk] = v
    return out


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1 item {item})")


def convert_mask2former(
    state: Dict[str, np.ndarray],
    depth: int = 50,
    enc_layers: int = 6,
    dec_layers: int = 9,
    head: str = "class",
    backbone: str = "resnet",
) -> Dict:
    """Full segmenter tree: {backbone, pixel_decoder, predictor}."""
    if backbone != "resnet":
        raise _not_ported(f"the {backbone!r} backbone's weight reader", 8)
    state = migrate_legacy_keys(state)
    return {
        "backbone": convert_resnet(state, depth),
        "pixel_decoder": convert_pixel_decoder(state, enc_layers),
        "predictor": convert_predictor(state, dec_layers, head),
    }


def convert_clip(state: Dict[str, np.ndarray]) -> Dict:
    raise _not_ported("the CLIP weight reader", 4)


def convert_timm_resnet(state: Dict[str, np.ndarray], depth: int = 50) -> Dict:
    raise _not_ported("the timm ResNet weight reader", 8)


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint's tensors as f32 numpy arrays by name."""
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: the port does not read flax .msgpack files; pass the "
                         "reference checkpoint (.pkl, .pth or .pt) itself")
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        model = data.get("model", data)
        return {k: np.asarray(v) for k, v in model.items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    obj = obj.get("model", obj)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float().numpy() for k, v in obj.items()}


def segmenter_state(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """A d2 Mask2Former checkpoint as the port's ``segmenter`` state_dict
    keys (without the ``segmenter.`` prefix), at ``cfg``'s depths.  The
    SimpleBaseline decoder has the CLIP embedding head: a checkpoint with a
    class head (a COCO Mask2Former) leaves it at its init."""
    m = cfg.model
    if m.backbone.name != "resnet":
        raise _not_ported(f"the {m.backbone.name!r} backbone's weight reader", 8)
    tree = convert_mask2former(
        load_torch_state(path), depth=m.backbone.depth,
        enc_layers=m.pixel_decoder.transformer_enc_layers,
        dec_layers=m.transformer_decoder.dec_layers, head="embedding")
    return params_from_flax(tree)
