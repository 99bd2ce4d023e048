"""PyTorch port, the video decoder's forward against the JAX package on the
CPU in f32, for each of its four heads (class, embedding, proposal,
side_adapter); one JAX jit of the four.  Shapes and helpers:
``tests/test_torch_port_offline.py``."""

import pytest

from test_torch_port_offline import (  # noqa: F401  (fixtures and helpers)
    CLIP_HEADS,
    D,
    DECODER_REL_TO_MAX,
    DEC_B,
    DEC_LAYERS,
    HEADS,
    K,
    Q,
    T,
    _decoder_out_keys,
    _rel,
    decoder_runs,
    tiny_clip,
)


@pytest.mark.parametrize("head", HEADS)
def test_video_decoder_forward_matches_jax(decoder_runs, head):
    got, ref = decoder_runs
    outs = got[head][0]
    l = DEC_LAYERS + 1
    shapes = {"class": (l, DEC_B, Q, K + 1), "embedding": (l, DEC_B, Q, D),
              "proposal": (l, DEC_B, Q, 2),
              "side_adapter": (l, DEC_B, T, CLIP_HEADS, Q, 4, 6)}
    key = _decoder_out_keys(head)[1]
    assert outs[key].shape == shapes[head]
    assert outs["pred_masks_all"].shape == (l, DEC_B, Q, T, 16, 24)
    for k, v in outs.items():
        assert _rel(v, ref[head][0][k]) <= DECODER_REL_TO_MAX, k
