"""Helpers shared by the port's tests (``tests/test_torch_port_*.py``): one
intra-op thread a module, the error measures, a flax tree's leaves by path,
JAX's parameter groups by path, the port's seeded model with random norm
affines and sampling-offset kernels as one set of weights for both packages,
a shape-keyed table of criterion points, one train step with the gradients
it hands its optimizer, and the JAX Swin under ``jit``.
JAX is imported only by the helpers that need it."""

from typing import Dict, Iterator, Tuple

import numpy as np
import pytest
import torch

from openvis_tpu_torch import train
from openvis_tpu_torch.convert import flax_from_state_dict, init_params
from openvis_tpu_torch.models.backbone import swin


def one_thread_fixture():
    """A module fixture: one intra-op thread (the tiny models' many small
    operations run no faster on more, and the test workers share the
    machine's cores)."""
    @pytest.fixture(scope="module", autouse=True)
    def one_thread():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)

    return one_thread


def rel(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def flat(tree, prefix=()) -> Iterator[Tuple[str, np.ndarray]]:
    """(path "a/b/leaf", f32 leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def jax_labels(tree, **kw) -> Dict[str, str]:
    """JAX's ``label_params(tree, **kw)`` of a flax tree, by path."""
    import jax

    from openvis_tpu.parallel.train_step import label_params as jax_label_params

    return {"/".join(k.key for k in path): label for path, label in
            jax.tree_util.tree_flatten_with_path(jax_label_params(tree, **kw))[0]}


def seeded_model(cfg, seed: int = 0, rng=None):
    """The port's model for ``cfg`` on the CPU from its seeded init, its norm
    affines and the encoder's sampling-offset kernels drawn from ``rng``, and
    the same weights as a flax tree of numpy leaves."""
    rng = np.random.RandomState(seed) if rng is None else rng
    model = init_params(train.build_model(cfg, device="cpu"), seed=seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
            if "sampling_offsets.weight" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.02))
    return model, flax_from_state_dict(model.state_dict())


def point_table(rng):
    """draw(batch, p) -> the same (batch, p, 2) y-sorted points for a shape
    each time, so that both packages sample at the same points whatever the
    order of their draws."""
    table = {}

    def draw(b, p):
        if (b, p) not in table:
            e = rng.exponential(size=(b, p + 1))
            s = np.cumsum(e, -1)
            table[(b, p)] = np.stack([rng.rand(b, p), s[:, :-1] / s[:, -1:]],
                                     -1).astype(np.float32)
        return table[(b, p)]

    return draw


def step_with_grads(step, batch, generator):
    """One call of the port's train step ``step``: (its metrics, the
    gradients of the trained parameters it hands its optimizer, before the
    clip).  One differentiation gives both the gradients and the update."""
    opt, seen = step.state.opt, {}
    update = opt.step

    def keep(params, grads, grad_norm=None):
        seen.update((n, g.detach().clone()) for n, g in grads.items())
        return update(params, grads, grad_norm)

    opt.step = keep
    try:
        metrics = step(batch, generator)
    finally:
        del opt.step  # the class's method again
    return metrics, seen


def jit_safe_jax_swin(mp: pytest.MonkeyPatch, shapes=((6, 9, 3, 1), (12, 12, 4, 2))) -> None:
    """Let the JAX package's Swin run under ``jax.jit``: its
    ``_shift_attn_mask`` turns a traced array into numpy (it runs only
    eagerly), so the numpy mask of the port stands in, held equal to JAX's
    eagerly first on ``shapes`` (h, w, window, shift)."""
    from openvis_tpu.models.backbone import swin as jax_swin

    for h, w, ws, shift in shapes:
        np.testing.assert_array_equal(swin.shift_attn_mask(h, w, ws, shift),
                                      jax_swin._shift_attn_mask(h, w, ws, shift))
    mp.setattr(jax_swin, "_shift_attn_mask", swin.shift_attn_mask)
