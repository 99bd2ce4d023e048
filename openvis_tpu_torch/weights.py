"""Readers of reference-format weights: Detectron2 Mask2Former and OpenAI CLIP.

A copy of ``tools/convert_weights.py``'s readers for the port (the tool
belongs to the JAX package, which the port does not import):

  * ``load_torch_state`` (``:420``): a d2 ``.pkl`` through ``pickle`` with
    ``latin1``, a ``.pth``/``.pt`` state dict through ``torch.load`` (tensors,
    numbers and strings only: ``weights_only=True``);
  * ``migrate_legacy_keys`` (``:269``), ``convert_resnet`` (``:88``),
    ``convert_swin`` (``:109``; the ``relative_position_index`` buffers are
    rebuilt by the model, not read), ``convert_timm_resnet`` (``:159``, timm's
    names onto d2's), ``convert_pixel_decoder`` (``:188``),
    ``convert_predictor`` (``:219``) and ``convert_mask2former`` (``:288``, a
    ResNet or Swin backbone) build the same flax-layout tree as the tool,
    which ``convert.params_from_flax`` maps onto the port's ``state_dict``
    keys (``segmenter_state``).

``convert_clip`` (``:366``, ``_clip_block`` ``:319``) converts an OpenAI CLIP
state dict the same way: a ViT (with a mask-adapted file's
``visual.mask_embedding``, ``:396-399``) or a ModifiedResNet (RN50/RN101,
``_convert_clip_rn_visual`` ``:337``: its BatchNorms folded with ``BN_EPS``
into ``FrozenAffine`` scales and biases).  The JAX package's flax
``.msgpack`` files, already in the flax layout, are read by
``utils/flax_msgpack.py``, not here.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from openvis_tpu_torch.config import Config
from openvis_tpu_torch.convert import params_from_flax
from openvis_tpu_torch.models.backbone.swin import SWIN_SHAPES

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


def convert_swin(d: Dict[str, np.ndarray], size: str = "base") -> Dict:
    """A d2 Mask2Former Swin checkpoint's ``backbone.*`` -> the Swin tree
    (``backbone.layers.{i}.blocks.{j}``, ``.downsample``, ``backbone.norm{i}``);
    the bias tables copy as they are."""
    depths = SWIN_SHAPES[size]["depths"]
    out = {
        "patch_embed": _conv(d, "backbone.patch_embed.proj"),
        "patch_norm": _norm(d, "backbone.patch_embed.norm"),
    }
    if "backbone.absolute_pos_embed" in d:  # (1, C, g, g) -> (1, g, g, C)
        out["absolute_pos_embed"] = np.ascontiguousarray(
            d["backbone.absolute_pos_embed"].transpose(0, 2, 3, 1))
    for si, nb in enumerate(depths):
        for bi in range(nb):
            pre = f"backbone.layers.{si}.blocks.{bi}"
            out[f"stage{si}_block{bi}"] = {
                "norm1": _norm(d, f"{pre}.norm1"),
                "attn": {
                    "qkv": _lin(d, f"{pre}.attn.qkv"),
                    "proj": _lin(d, f"{pre}.attn.proj"),
                    "relative_position_bias_table":
                        d[f"{pre}.attn.relative_position_bias_table"],
                },
                "norm2": _norm(d, f"{pre}.norm2"),
                "mlp_fc1": _lin(d, f"{pre}.mlp.fc1"),
                "mlp_fc2": _lin(d, f"{pre}.mlp.fc2"),
            }
        if si < len(depths) - 1:
            red = d[f"backbone.layers.{si}.downsample.reduction.weight"]
            out[f"downsample{si}"] = {
                "norm": _norm(d, f"backbone.layers.{si}.downsample.norm"),
                "reduction": {"kernel": np.ascontiguousarray(red.T)},
            }
        out[f"out_norm{si}"] = _norm(d, f"backbone.norm{si}")
    return out


def convert_timm_resnet(state: Dict[str, np.ndarray], depth: int = 50) -> Dict:
    """A timm ResNet (OV2Seg's IN21k trunk: ``conv1``/``bn1`` stem,
    ``layer{1..4}.{i}.conv/bn`` blocks, ``downsample.0/1`` shortcuts) -> the
    tree of :func:`convert_resnet`, through d2's names."""
    bn_parts = ("weight", "bias", "running_mean", "running_var")
    remap = {"backbone.stem.conv1.weight": state["conv1.weight"]}
    for part in bn_parts:
        remap[f"backbone.stem.conv1.norm.{part}"] = state[f"bn1.{part}"]
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    for si, nb in enumerate(blocks):
        for bi in range(nb):
            src, dst = f"layer{si + 1}.{bi}", f"backbone.res{si + 2}.{bi}"
            for ci in (1, 2, 3):
                remap[f"{dst}.conv{ci}.weight"] = state[f"{src}.conv{ci}.weight"]
                for part in bn_parts:
                    remap[f"{dst}.conv{ci}.norm.{part}"] = state[f"{src}.bn{ci}.{part}"]
            if f"{src}.downsample.0.weight" in state:
                remap[f"{dst}.shortcut.weight"] = state[f"{src}.downsample.0.weight"]
                for part in bn_parts:
                    remap[f"{dst}.shortcut.norm.{part}"] = state[f"{src}.downsample.1.{part}"]
    return convert_resnet(remap, depth)


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


def convert_mask2former(
    state: Dict[str, np.ndarray],
    depth: int = 50,
    enc_layers: int = 6,
    dec_layers: int = 9,
    head: str = "class",
    backbone: str = "resnet",
    swin_size: str = "base",
) -> Dict:
    """Full segmenter tree: {backbone, pixel_decoder, predictor};
    ``backbone="swin"`` reads the Mask2Former Swin checkpoints the Swin
    recipes start from."""
    state = migrate_legacy_keys(state)
    return {
        "backbone": (convert_swin(state, swin_size) if backbone == "swin"
                     else convert_resnet(state, depth)),
        "pixel_decoder": convert_pixel_decoder(state, enc_layers),
        "predictor": convert_predictor(state, dec_layers, head),
    }


def _ln_f32(d, name):  # CLIP's LayerNormF32 holds its LayerNorm as ``ln``
    return {"ln": _norm(d, name)}


def _clip_block(d, pre):
    """An OpenAI residual block: the packed ``in_proj`` splits into q/k/v."""
    return {
        "ln_1": _ln_f32(d, f"{pre}.ln_1"),
        "ln_2": _ln_f32(d, f"{pre}.ln_2"),
        "attn": _mha(d, f"{pre}.attn"),
        "mlp_c_fc": _lin(d, f"{pre}.mlp.c_fc"),
        "mlp_c_proj": _lin(d, f"{pre}.mlp.c_proj"),
    }


def _n_blocks(d, prefix):
    return len({k[len(prefix):].split(".")[0] for k in d if k.startswith(prefix)})


def _convert_clip_rn_visual(d) -> Dict:
    """OpenAI's ModifiedResNet visual tower -> ``MaskAdaptedModifiedResNet``'s
    tree: the 3-conv stem, the bottlenecks (``downsample.0``/``.1`` the
    shortcut's conv and BatchNorm), the attention pool's projections."""
    visual = {}
    for i in (1, 2, 3):
        visual[f"stem_conv{i}"] = _conv(d, f"visual.conv{i}", bias=False)
        visual[f"stem_bn{i}"] = _frozen_bn(d, f"visual.bn{i}")
    for si in range(1, 5):
        b = 0
        while f"visual.layer{si}.{b}.conv1.weight" in d:
            pre = f"visual.layer{si}.{b}"
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = _conv(d, f"{pre}.conv{ci}", bias=False)
                blk[f"bn{ci}"] = _frozen_bn(d, f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in d:
                blk["downsample_conv"] = _conv(d, f"{pre}.downsample.0", bias=False)
                blk["downsample_bn"] = _frozen_bn(d, f"{pre}.downsample.1")
            visual[f"layer{si}_block{b}"] = blk
            b += 1
    visual["positional_embedding"] = d["visual.attnpool.positional_embedding"]
    for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
        visual[p] = _lin(d, f"visual.attnpool.{p}")
    return visual


def _convert_clip_vit_visual(d) -> Dict:
    visual = {
        "conv1": {"kernel": np.ascontiguousarray(d["visual.conv1.weight"].transpose(2, 3, 1, 0))},
        "class_embedding": d["visual.class_embedding"],
        "positional_embedding": d["visual.positional_embedding"],
        "ln_pre": _ln_f32(d, "visual.ln_pre"),
        "ln_post": _ln_f32(d, "visual.ln_post"),
        "proj": d["visual.proj"],
    }
    # a mask-adapted file's learned prompt table (ov-seg's fine-tunes); the
    # adapted tower zero-inits it for a plain OpenAI file
    if "visual.mask_embedding" in d:
        visual["mask_embedding"] = d["visual.mask_embedding"]
    for i in range(_n_blocks(d, "visual.transformer.resblocks.")):
        visual[f"resblock{i}"] = _clip_block(d, f"visual.transformer.resblocks.{i}")
    return visual


def convert_clip(state: Dict[str, np.ndarray]) -> Dict:
    """OpenAI CLIP state dict (ViT or ModifiedResNet, told apart by its keys)
    -> {visual, text, logit_scale}."""
    d = state
    visual = (_convert_clip_rn_visual(d) if "visual.layer1.0.conv1.weight" in d
              else _convert_clip_vit_visual(d))
    text = {
        "token_embedding": {"embedding": d["token_embedding.weight"]},
        "positional_embedding": d["positional_embedding"],
        "ln_final": _ln_f32(d, "ln_final"),
        "text_projection": d["text_projection"],
    }
    for i in range(_n_blocks(d, "transformer.resblocks.")):
        text[f"resblock{i}"] = _clip_block(d, f"transformer.resblocks.{i}")
    return {"visual": visual, "text": text, "logit_scale": d["logit_scale"].reshape(())}


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint's tensors as f32 numpy arrays by name."""
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: a flax .msgpack tree, not a torch checkpoint; "
                         "utils/flax_msgpack.read_msgpack reads it")
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


def swin_size(cfg: Config) -> str:
    """The ``SWIN_SHAPES`` name of ``cfg``'s Swin trunk."""
    b = cfg.model.backbone
    shape = dict(embed_dim=b.swin_embed_dim, depths=tuple(b.swin_depths),
                 num_heads=tuple(b.swin_num_heads))
    for size, known in SWIN_SHAPES.items():
        if known == shape:
            return size
    raise ValueError(f"no Swin checkpoint layout has the shape {shape}")


def segmenter_state(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """A d2 Mask2Former checkpoint (ResNet or Swin) as the port's
    ``segmenter`` state_dict keys (without the ``segmenter.`` prefix), at
    ``cfg``'s depths; for ``timm_resnet`` a timm ResNet checkpoint, as the
    ``backbone`` keys alone.  The SimpleBaseline decoder has the CLIP
    embedding head: a checkpoint with a class head (a COCO Mask2Former)
    leaves it at its init.  Only the deformable pixel decoder's names are
    read: for ``fpn`` or ``transformer_enc`` it raises, as the JAX package
    has no reader for a d2 FPN checkpoint (``tools/convert_weights.py``
    reads the deformable encoder's names alone)."""
    m = cfg.model
    if m.backbone.name != "timm_resnet" and m.pixel_decoder.name != "msdeform":
        raise ValueError(
            f"{path}: no reader of a d2 checkpoint for the {m.pixel_decoder.name!r} pixel "
            "decoder (the JAX package's tools/convert_weights.py reads only the "
            "deformable encoder's names); load a flax .msgpack or the port's own checkpoint")
    state = load_torch_state(path)
    if m.backbone.name == "timm_resnet":
        return params_from_flax({"backbone": convert_timm_resnet(state, m.backbone.depth)})
    swin = m.backbone.name == "swin"
    tree = convert_mask2former(
        state, depth=m.backbone.depth,
        enc_layers=m.pixel_decoder.transformer_enc_layers,
        dec_layers=m.transformer_decoder.dec_layers, head="embedding",
        backbone="swin" if swin else "resnet", swin_size=swin_size(cfg) if swin else "base")
    return params_from_flax(tree)
