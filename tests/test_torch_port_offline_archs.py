"""PyTorch port, the offline archs' forwards, losses and gradients against the
JAX package on the CPU in f32: VideoMaskFormer, MinVIS and both offline
OpenVIS decoders, one JAX jit.  Shapes and helpers:
``tests/test_torch_port_offline.py``."""

import numpy as np
import pytest

from test_torch_port_offline import (  # noqa: F401  (fixtures and helpers)
    ARCHS,
    GRAD_REL_NORM,
    LOSS_ARCHS,
    _check_forward,
    _check_losses,
    arch_runs,
    batch,
    tiny_clip,
)


@pytest.mark.parametrize("arch_id", LOSS_ARCHS)
def test_offline_arch_forward_loss_and_gradients_match_jax(arch_runs, arch_id):
    got, ref = arch_runs
    arch, decoder, ncls = ARCHS[arch_id]
    out, loss, metrics, grads = got[arch_id]
    jout, ((jloss, jmetrics), jgrads) = ref[arch_id]
    _check_forward(out, jout, decoder, ncls)
    _check_losses(loss, metrics, jloss, jmetrics)
    for k, g in grads.items():
        j = np.asarray(jgrads[k])
        assert np.any(j), k
        assert np.linalg.norm(g.numpy() - j) / np.linalg.norm(j) <= GRAD_REL_NORM, k
