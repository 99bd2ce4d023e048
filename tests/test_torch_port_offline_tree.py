"""PyTorch port, the video decoder's parameter trees against the JAX package:
each head's tree loads strictly, its groups equal JAX's ``label_params`` and
the port's init draws as flax's.  Shapes and helpers:
``tests/test_torch_port_offline.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvis_tpu.parallel.train_step import label_params as jax_label_params
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
)
from openvis_tpu_torch.parallel.train_step import label_params

from test_torch_port_offline import (  # noqa: F401  (fixtures and helpers)
    DEC_B,
    HEADS,
    HID,
    LEVELS,
    T,
    _decoders,
    _flat,
    tiny_clip,
)


@pytest.mark.parametrize("head", HEADS)
def test_video_decoder_tree_groups_and_init_match_flax(head):
    """The JAX decoder's parameter tree (shapes by ``eval_shape``) loads into
    the port strictly and back out unchanged; the groups equal JAX's ``label_params``; the
    head's Linears are drawn as flax's Dense: lecun-normal truncated at 2
    sigma, zero biases."""
    port, jdec = _decoders(head)
    xs = [jnp.zeros((DEC_B * T, h, w, HID)) for h, w in LEVELS]
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), xs,
                                              jnp.zeros((DEC_B, T, 16, 24, HID)), T))["params"]
    rng = np.random.RandomState(5)
    jtree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    load_flax_params(port, jtree)  # strict: the same names and shapes
    assert all(np.array_equal(v, dict(_flat(jtree))[k])
               for k, v in _flat(flax_from_state_dict(port.state_dict())))
    init_params(port, seed=3)
    tree = flax_from_state_dict(port.state_dict())
    jshapes = {k: tuple(v.shape) for k, v in
               ((("/".join(str(getattr(p, "key", p)) for p in path)), leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes)[0])}
    assert {k: v.shape for k, v in _flat(tree)} == jshapes
    jlabels = {"/".join(k.key for k in path): label for path, label in
               jax.tree_util.tree_flatten_with_path(jax_label_params(tree))[0]}
    plabels = label_params(port.named_parameters())
    assert {"/".join(flax_path(n, p.dim())): plabels[n]
            for n, p in port.named_parameters()} == jlabels
    linears = [m for n, m in port.heads.named_modules()
               if isinstance(m, torch.nn.Linear) and not n.startswith("mask_embed")]
    assert linears
    for lin in linears:
        std = (1.0 / lin.in_features) ** 0.5
        assert not lin.bias.any()
        assert lin.weight.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert 0.5 * std < lin.weight.std().item() < 1.5 * std
