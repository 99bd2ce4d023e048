"""PyTorch port, the video decoder's gradients against the JAX package on the
CPU in f32, for each of its four heads; the forward's JAX jit computes them
too.  Shapes and helpers: ``tests/test_torch_port_offline.py``."""

import numpy as np
import pytest

from test_torch_port_offline import (  # noqa: F401  (fixtures and helpers)
    GRAD_REL_NORM,
    HEADS,
    _flat,
    _grads_close,
    decoder_runs,
    tiny_clip,
)


@pytest.mark.parametrize("head", HEADS)
def test_video_decoder_gradients_match_jax(decoder_runs, head):
    got, ref = decoder_runs
    _, pgrads, xgrads, mfgrad = got[head]
    jp, jxs, jmf = ref[head][1]
    _grads_close(pgrads, dict(_flat(jp)))
    for g, j in zip(xgrads + [mfgrad], list(jxs) + [jmf]):
        j = np.asarray(j)
        assert np.linalg.norm(g - j) / np.linalg.norm(j) <= GRAD_REL_NORM
