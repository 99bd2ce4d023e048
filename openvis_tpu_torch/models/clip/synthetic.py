"""Random CLIP weights in OpenAI's key layout and a tiny BPE merge file.

Neither OpenAI's CLIP checkpoints nor its BPE vocabulary are in the
repository, so the tests and ``chip_smoke.py`` write stand-ins from a seed:
``openai_state_dict`` draws a CLIP's state dict with the key names and
shapes of OpenAI's release, a ViT or a ModifiedResNet (RN50, RN101), with an
optional mask-adapted ``visual.mask_embedding`` (OpenAI's init scales, so
activations stay in range at full depth) and ``write_bpe`` a gzip merge file
in the ``bpe_simple_vocab_16e6.txt.gz`` format.
"""

from __future__ import annotations

import gzip
from typing import Dict, Sequence

import torch

from openvis_tpu_torch.models.clip.model import is_resnet, model_shape

# merges over the prompt templates' common words ("a photo of the person")
TINY_MERGES = (
    "t h", "th e</w>", "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "i n</w>",
    "e r", "s o", "so n</w>", "p er", "per son</w>", "a n", "i s</w>", "o n</w>",
    "c a", "ca r</w>", "d o", "do g</w>",
)


def write_bpe(path: str, merges: Sequence[str] = TINY_MERGES) -> str:
    """A merge file the tokenizer reads: a header line, then one merge a line."""
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges))  # no final newline: no empty merge
    return path


def bpe_vocab_size(merges: Sequence[str] = TINY_MERGES) -> int:
    """The tokenizer's vocabulary: 256 bytes twice (with and without
    ``</w>``), the merges, and the two specials."""
    return 512 + len(merges) + 2


def _blocks(out: Dict, gen: torch.Generator, prefix: str, width: int, layers: int) -> None:
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5

    def n(*shape, std=0.02):
        return torch.randn(shape, generator=gen) * std

    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        out[f"{p}.attn.in_proj_weight"] = n(3 * width, width, std=attn_std)
        out[f"{p}.attn.in_proj_bias"] = n(3 * width)
        out[f"{p}.attn.out_proj.weight"] = n(width, width, std=proj_std)
        out[f"{p}.attn.out_proj.bias"] = n(width)
        for ln in ("ln_1", "ln_2"):
            out[f"{p}.{ln}.weight"] = 1.0 + n(width, std=0.1)
            out[f"{p}.{ln}.bias"] = n(width)
        out[f"{p}.mlp.c_fc.weight"] = n(4 * width, width, std=fc_std)
        out[f"{p}.mlp.c_fc.bias"] = n(4 * width)
        out[f"{p}.mlp.c_proj.weight"] = n(width, 4 * width, std=proj_std)
        out[f"{p}.mlp.c_proj.bias"] = n(width)


def _batch_norm(out: Dict, gen: torch.Generator, name: str, ch: int, weight_std: float = 0.1,
                weight_mean: float = 1.0) -> None:
    """An eval-mode BatchNorm's affine and running statistics (a positive
    variance)."""
    out[f"{name}.weight"] = weight_mean + torch.randn(ch, generator=gen) * weight_std
    out[f"{name}.bias"] = torch.randn(ch, generator=gen) * 0.02
    out[f"{name}.running_mean"] = torch.randn(ch, generator=gen) * 0.1
    out[f"{name}.running_var"] = 1.0 + torch.rand(ch, generator=gen)


def _resnet_visual(out: Dict, gen: torch.Generator, s: Dict) -> None:
    """OpenAI's ``ModifiedResNet`` keys: the 3-conv stem, the bottlenecks
    (``downsample.0``/``.1``, the shortcut's conv and BatchNorm) and the
    attention pool.  Each bottleneck's last BatchNorm scales by ~0.1, so
    the residual stream stays in range at RN101's depth."""
    w = s["vision_width"]

    def conv(name, cout, cin, k):
        out[f"{name}.weight"] = torch.randn((cout, cin, k, k), generator=gen) * (
            2.0 / (cin * k * k)) ** 0.5

    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), start=1):
        conv(f"visual.conv{i}", cout, cin, 3)
        _batch_norm(out, gen, f"visual.bn{i}", cout)
    inplanes = w
    for si, n_blocks in enumerate(s["vision_layers"], start=1):
        planes = w * 2 ** (si - 1)
        for b in range(n_blocks):
            p = f"visual.layer{si}.{b}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            conv(f"{p}.conv2", planes, planes, 3)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            for ci in (1, 2):
                _batch_norm(out, gen, f"{p}.bn{ci}", planes)
            _batch_norm(out, gen, f"{p}.bn3", planes * 4, weight_mean=0.0)
            if b == 0 and (si > 1 or inplanes != planes * 4):
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                _batch_norm(out, gen, f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    c, g = inplanes, s["image_size"] // 32
    out["visual.attnpool.positional_embedding"] = torch.randn((g * g + 1, c), generator=gen) * (
        c ** -0.5)
    for name, cout in (("q_proj", c), ("k_proj", c), ("v_proj", c), ("c_proj", s["embed_dim"])):
        out[f"visual.attnpool.{name}.weight"] = torch.randn((cout, c), generator=gen) * c ** -0.5
        out[f"visual.attnpool.{name}.bias"] = torch.randn(cout, generator=gen) * 0.02


def openai_state_dict(model_name: str, seed: int, vocab_size: int = 49408,
                      context_length: int = 77, dtype: torch.dtype = torch.float16,
                      mask_prompt_depth: int = 0) -> Dict[str, torch.Tensor]:
    """A random CLIP state dict in OpenAI's layout (f16, as released); a ViT
    with ``mask_prompt_depth`` > 0 also carries a mask-adapted fine-tune's
    ``visual.mask_embedding`` (depth, g^2, width), drawn nonzero."""
    s = model_shape(model_name)
    gen = torch.Generator().manual_seed(seed)
    tw = s["text_width"]

    def n(*shape, std=0.02):
        return torch.randn(shape, generator=gen) * std

    out = {}
    if not is_resnet(s):  # drawn first, as before the ModifiedResNet: a seed's ViT is kept
        vw, p = s["vision_width"], s["vision_patch"]
        g = s["image_size"] // p
        out.update({
            "visual.conv1.weight": n(vw, 3, p, p, std=(3 * p * p) ** -0.5),
            "visual.class_embedding": n(vw, std=vw ** -0.5),
            "visual.positional_embedding": n(g * g + 1, vw, std=vw ** -0.5),
            "visual.ln_pre.weight": 1.0 + n(vw, std=0.1), "visual.ln_pre.bias": n(vw),
            "visual.ln_post.weight": 1.0 + n(vw, std=0.1), "visual.ln_post.bias": n(vw),
            "visual.proj": n(vw, s["embed_dim"], std=vw ** -0.5),
        })
    out.update({
        "token_embedding.weight": n(vocab_size, tw),
        "positional_embedding": n(context_length, tw, std=0.01),
        "ln_final.weight": 1.0 + n(tw, std=0.1), "ln_final.bias": n(tw),
        "text_projection": n(tw, s["embed_dim"], std=tw ** -0.5),
        "logit_scale": torch.tensor(4.6052),
    })
    if is_resnet(s):
        _resnet_visual(out, gen, s)
    else:
        _blocks(out, gen, "visual.transformer", vw, s["vision_layers"])
    _blocks(out, gen, "transformer", tw, s["text_layers"])
    if mask_prompt_depth and not is_resnet(s):
        out["visual.mask_embedding"] = n(mask_prompt_depth, g * g, vw, std=vw ** -0.5)
    return {k: v.to(dtype) for k, v in out.items()}
