"""Typed configuration of the PyTorch port.

A copy of ``openvis_tpu/config.py``: the same frozen dataclasses, defaults,
YAML loading (``_BASE_`` inheritance) and dotted overrides, so one YAML file
under ``configs/`` configures both packages.  The port keeps its own copy and
imports nothing of ``openvis_tpu``; ``tests/test_torch_port_config.py`` holds
the two to each other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _tup(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


@dataclass(frozen=True)
class BackboneConfig:
    """Reference: ``MODEL.BACKBONE`` + ``MODEL.RESNETS`` / ``MODEL.SWIN``."""

    name: str = "resnet"              # "resnet" | "swin" | "timm_resnet"
    depth: int = 50
    freeze_at: int = 0                # 0 = train all stages
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    stem_out_channels: int = 64
    stride_in_1x1: bool = False       # torchvision-style bottleneck (d2 default for M2F)
    norm: str = "frozen_bn"           # backbone BN is frozen (d2 FrozenBatchNorm2d)
    # swin knobs (MODEL.SWIN.*)
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_mlp_ratio: float = 4.0
    swin_patch_size: int = 4
    swin_drop_path_rate: float = 0.3
    swin_qkv_bias: bool = True
    swin_patch_norm: bool = True
    swin_ape: bool = False
    swin_pretrain_img_size: int = 224


@dataclass(frozen=True)
class PixelDecoderConfig:
    """Reference: ``MODEL.SEM_SEG_HEAD`` deformable-encoder knobs."""

    name: str = "msdeform"            # "msdeform" | "fpn"
    conv_dim: int = 256
    mask_dim: int = 256
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    transformer_enc_layers: int = 6
    num_heads: int = 8
    num_points: int = 4
    dim_feedforward: int = 1024
    dropout: float = 0.0
    common_stride: int = 4            # output (mask-feature) stride


@dataclass(frozen=True)
class TransformerDecoderConfig:
    """Reference: ``MODEL.MASK_FORMER`` transformer knobs."""

    name: str = "frame_embedding"
    # "video" | "frame" | {video,frame}_{embedding,proposal} | side_adapter_{frame,video}
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9               # 9 decoder layers + 1 pre-layer prediction
    pre_norm: bool = False
    mask_dim: int = 256
    enforce_input_project: bool = False
    # NOTE: no num_feature_levels knob — the reference decoder hardcodes 3
    # (video_mask2former_transformer_decoder.py:336), and so do we.
    clip_embed_dim: int = 512         # for embedding decoders (CLIP text space)


@dataclass(frozen=True)
class CriterionConfig:
    """Reference: loss weights + point-sampling knobs (``MODEL.MASK_FORMER``)."""

    deep_supervision: bool = True
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    train_num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # BriVIS brownian-bridge loss: True = -log(ratio) (the paper's
    # objective); False = raw ratio, bit-parity with the shipped reference
    # (brownian_criterion.py:96-103)
    brownian_neg_log: bool = True
    # opt-in: keep AMP bf16 mask logits in bf16 through criterion point
    # sampling (halves the mask HBM traffic that dominates the criterion).
    # Default off: torch autocast keeps grid_sample in fp32, so bf16
    # sampling deviates from the reference AMP policy (sampled VALUES only;
    # losses over the sampled points are always f32)
    bf16_masks: bool = False
    # corner-pack full-res target tables on the TPU gather path (one row
    # gather per point instead of four) at 4x the table's HBM residency;
    # disable on memory-tight configs (losses are bitwise identical)
    packed_targets: bool = True


@dataclass(frozen=True)
class ClipAdapterConfig:
    """Reference: ``MODEL.CLIP_ADAPTER``."""

    name: str = "clip"                # "clip" | "bg_clip" | "adapted" | "bg_adapted"
                                      # | "side" | "masqclip"
    prompt_name: str = "vild"         # "vild" | "imagenet" | "predefined"
    predefined_templates: Tuple[str, ...] = ("a photo of a {}.",)
    clip_model_name: str = "ViT-B/16"
    clip_num_heads: int = 12
    clip_embed_dims: int = 512
    # SAN side-adapter knobs
    merge_ids: Tuple[int, ...] = (3, 6, 9)
    broken_id: int = 9
    # inference-time score ensemble
    clip_ensemble: bool = True
    clip_ensemble_weight: float = 0.8
    # static sub-samples per roi_align output bin (reference uses the
    # adaptive ceil(roi/out) grid, adapter.py:106-111 — data-dependent, so
    # untraceable; 2 halves the sampling-density gap on large crops)
    crop_sampling_ratio: int = 2
    # mask-adapted CLIP knobs
    mask_prompt_depth: int = 3
    mask_prompt_fwd: bool = True
    # path to converted CLIP weights (msgpack pytree produced by tools/convert_weights.py)
    weights: str = ""
    # path to the BPE vocab (user-supplied; OpenAI CLIP bpe_simple_vocab_16e6.txt.gz)
    bpe_vocab: str = ""


@dataclass(frozen=True)
class ResamplerConfig:
    """BriVIS temporal instance resampler knobs (``resampler.py``)."""

    name: str = "temporal"            # "temporal" | "decoupled" | "raw"
    num_layers: int = 6
    conv_kernels: Tuple[int, ...] = (5, 3)
    window_size: int = 10             # raw-resampler windowed inference


@dataclass(frozen=True)
class TestConfig:
    """Reference: ``MODEL.MASK_FORMER.TEST``."""

    window_inference: bool = False
    window_size: int = 10
    # bf16 AMP evaluation (reference evaluates under torch.autocast,
    # train_net.py:241-242): f32 params/frames/text cast to bf16 for the
    # whole eval path; mask logits return to f32 at the host boundary
    amp: bool = True
    # NOTE: the reference's OBJECT_MASK_THRESHOLD / OVERLAP_THRESHOLD are
    # image-panoptic knobs its video inference assigns but never reads
    # (video_maskformer.py:36-37 / ov2seg.py:590-591) — omitted here.
    topk_per_video: int = 10
    max_frames: int = 128             # pad/bucket bound for eval videos (static shapes)
    # [[dataset, metric, expected, tolerance], ...] checked after evaluation
    # (reference train_net.py:294-295 verify_results over TEST.EXPECTED_RESULTS)
    expected_results: Tuple = ()


@dataclass(frozen=True)
class ModelConfig:
    meta_architecture: str = "SimpleBaselineOnline"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    transformer_decoder: TransformerDecoderConfig = field(default_factory=TransformerDecoderConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    clip_adapter: ClipAdapterConfig = field(default_factory=ClipAdapterConfig)
    resampler: ResamplerConfig = field(default_factory=ResamplerConfig)
    test: TestConfig = field(default_factory=TestConfig)
    num_classes: int = 101            # training taxonomy size (ytvis_2019_train2coco)
    size_divisibility: int = 32
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    weights: str = ""                 # converted pretrained init (orbax/msgpack)
    freeze_segmenter: bool = False    # BriVIS stage 2


@dataclass(frozen=True)
class SolverConfig:
    """Reference: ``SOLVER`` (``Base.yaml:21-38``, ``train_net.py:131-203``)."""

    ims_per_batch: int = 16
    base_lr: float = 1e-4
    max_iter: int = 6000
    steps: Tuple[int, ...] = (5000,)
    gamma: float = 0.1
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_embed: float = 0.0
    backbone_multiplier: float = 0.1
    clip_gradients: bool = True
    clip_value: float = 0.01          # full-model grad-norm clip
    amp: bool = True                  # bf16 compute
    checkpoint_period: int = 500
    optimizer: str = "adamw"


@dataclass(frozen=True)
class InputConfig:
    """Reference: ``INPUT`` (+ video sampling knobs)."""

    min_size_train: Tuple[int, ...] = (240, 360, 480)
    min_size_train_sampling: str = "choice_by_clip"
    max_size_train: int = 1333
    min_size_test: int = 360
    max_size_test: int = 1333
    random_flip: str = "flip_by_clip"
    crop_enabled: bool = False
    crop_type: str = "absolute_range"
    crop_size: Tuple[int, int] = (600, 720)
    format: str = "RGB"
    sampling_frame_num: int = 2
    sampling_frame_ratio: float = 1.0  # <1: single-frame video subsampling
    sampling_frame_range: int = 20
    sampling_frame_shuffle: bool = False
    sampling_frame_reverse: bool = False
    augmentations: Tuple[str, ...] = ()
    # pseudo-video (COCO) augs
    pseudo_augmentations: Tuple[str, ...] = ("rotation",)
    pseudo_min_size_train: Tuple[int, ...] = (240, 360, 480)
    pseudo_max_size_train: int = 1333
    # static-shape knobs (TPU): every batch is padded to these bounds
    max_instances: int = 40           # padded GT instance axis per clip
    train_size_divisibility: int = 32
    pad_size: Tuple[int, int] = (480, 864)  # fixed padded (H, W) train canvas


@dataclass(frozen=True)
class DataloaderConfig:
    """Reference: ``DATALOADER`` (``Base.yaml:62`` NUM_WORKERS: 4)."""

    num_workers: int = 4              # host decode/augment threads
    prefetch: int = 2                 # assembled batches buffered ahead


@dataclass(frozen=True)
class DatasetsConfig:
    train: Tuple[str, ...] = ("ytvis_2019_train2coco", "coco_2017_train")
    test: Tuple[str, ...] = ("ytvis_2019_val",)
    dataset_ratio: Tuple[float, ...] = (1.0, 0.75)
    root: str = "datasets"            # $DETECTRON2_DATASETS equivalent


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout (``parallel/mesh.make_mesh``). The reference is DDP-only
    (SURVEY §2.6); we expose a (data, time) mesh: the train batch and the
    eval window-group axis shard over EVERY mesh axis, so ``time_axis > 1``
    places consecutive windows of one video on ICI-adjacent devices
    (sequence parallelism at window granularity)."""

    data_axis: int = -1               # devices on the data axis; -1 = fill
    time_axis: int = 1                # devices on the time (window) axis


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    output_dir: str = "output"
    seed: int = 42


# ---------------------------------------------------------------------------
# (De)serialization: YAML with _BASE_ inheritance + dotted overrides.
# ---------------------------------------------------------------------------

def _merge_into(dc, overrides: Dict[str, Any]):
    """Recursively apply a nested dict onto a dataclass, returning a new one."""
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(dc)}
    for key, val in overrides.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(dc).__name__}")
        cur = getattr(dc, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kwargs[key] = _merge_into(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return dataclasses.replace(dc, **kwargs)


def load_config(path: str, overrides: Optional[Sequence[str]] = None) -> Config:
    """Load a YAML config with ``_BASE_`` inheritance and dotted overrides.

    Overrides are ``"a.b.c=value"`` strings; values parse as YAML scalars.
    """
    import yaml

    def load_tree(p: str) -> Dict[str, Any]:
        import os
        with open(p) as f:
            d = yaml.safe_load(f) or {}
        base = d.pop("_BASE_", None)
        if base:
            parent = load_tree(os.path.join(os.path.dirname(p), base))
            d = _deep_update(parent, d)
        return d

    tree = load_tree(path)
    cfg = _merge_into(Config(), tree)
    for ov in overrides or ():
        key, _, val = ov.partition("=")
        cfg = apply_override(cfg, key.strip(), yaml.safe_load(val))
    return cfg


def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in upd.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def apply_override(cfg: Config, dotted: str, value: Any) -> Config:
    parts = dotted.split(".")
    tree: Dict[str, Any] = {}
    node = tree
    for p in parts[:-1]:
        node[p] = {}
        node = node[p]
    node[parts[-1]] = value
    return _merge_into(cfg, tree)


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
