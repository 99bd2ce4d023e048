"""PyTorch port, module by module, against the JAX package at a tiny size:
the resizes and the 2-D position encoding here, the ResNet, the AMP policy
and one frame's tracking in ``test_torch_port_modules_resnet.py``, the pixel
decoder, the frame decoder and the tracking post-process in
``test_torch_port_modules_decoder.py`` (no file holds more than 4 tests).

Parameters come from the flax modules' own init and are carried across by
``openvis_tpu_torch.convert.params_from_flax``.  Norm affines and the MSDA
offset/attention-weight kernels are randomized, so that a wrong order, a
swapped axis or a sampling point that never leaves its init ring shows.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from openvis_tpu.models import tracking as jax_tracking
from openvis_tpu.models.amp import amp_norm as jax_amp_norm
from openvis_tpu.models.backbone.resnet import ResNet as JaxResNet
from openvis_tpu.models.meta.simple_baseline import eval_scores as jax_eval_scores
from openvis_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from openvis_tpu.models.position_encoding import position_encoding_2d as jax_pe2d
from openvis_tpu.models.postprocess import inference_video_topk as jax_topk
from openvis_tpu.models.transformer_decoder import MaskedTransformerDecoder as JaxDecoder
from openvis_tpu.utils.image import resize_bilinear_torch_hw as jax_resize_hw
from openvis_tpu_torch.convert import load_flax_params
from openvis_tpu_torch.models import tracking
from openvis_tpu_torch.models.amp import amp_norm, softmax_f32
from openvis_tpu_torch.models.backbone.resnet import ResNet, feature_channels
from openvis_tpu_torch.models.meta.simple_baseline import eval_scores
from openvis_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from openvis_tpu_torch.models.position_encoding import position_encoding_2d
from openvis_tpu_torch.models.postprocess import inference_video_topk
from openvis_tpu_torch.models.transformer_decoder import MaskedTransformerDecoder
from openvis_tpu_torch.utils.image import resize_bilinear_torch_hw
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

HID, NHEADS, Q, D = 64, 4, 8, 32
H, W = 64, 96  # input frame size; features at strides 4..32


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(params, rng, keys=("norm",), scale=0.1):
    """Replace every leaf whose path contains one of ``keys`` by 1 + noise
    (norm affines) or noise (kernels)."""
    def f(path, v):
        name = "/".join(str(getattr(k, "key", k)) for k in path).lower()
        if any(k in name for k in keys):
            noise = rng.randn(*v.shape).astype(np.float32) * scale
            return jnp.asarray(noise + (1.0 if "norm" in name else 0.0))
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("src,dst", [((16, 24), (4, 6)), ((4, 6), (16, 24)), ((12, 20), (7, 9))])
def test_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    ref = np.asarray(jax_resize_hw(jnp.asarray(x), dst))
    np.testing.assert_allclose(resize_bilinear_torch_hw(_t(x), dst).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_position_encoding_matches_jax():
    ref = np.asarray(jax.jit(jax_pe2d, static_argnums=(0, 1, 2))(6, 10, 32))
    np.testing.assert_allclose(position_encoding_2d(6, 10, 32).numpy(), ref, rtol=1e-5, atol=1e-5)


def _features(rng, b=2):
    chans = feature_channels(50)
    return {
        f"res{i + 2}": rng.randn(b, H // s, W // s, chans[f"res{i + 2}"]).astype(np.float32)
        for i, s in enumerate((4, 8, 16, 32))
    }
