"""PyTorch port: one bf16 AMP train step of SimpleBaselineOnline at a tiny
size against the JAX package's, from the same f32 master weights, batch and
points (the setup of ``test_torch_port_train_step.py``).

The AMP rule is the JAX package's: frames and every f32 parameter except the
norms' run in bf16, cast at use; the losses run in f32, with the mask-logit
stack kept bf16 and sampled under the f32 policy.  The two frameworks round
to bf16 at different places (convolution and matmul accumulation, resize
weights, the attention scale), so only bounds hold.
"""

import numpy as np
import pytest

from test_torch_port_train_step import run_both
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


@pytest.fixture(scope="module")
def amp_step():
    return run_both(amp=True)


# observed on this seed: losses and grad norm within 0.75 % of JAX's; 94.7 %
# of the updated parameters within 1e-6 of JAX's; the concatenated gradients
# point the same way.  Bounds are 4x wider than what was seen.
LOSS_RTOL = 3e-2
PARAMS_WITHIN_1E6 = 0.9
GRAD_COSINE = 0.99


def test_amp_losses_and_grad_norm_within_bounds_of_jax(amp_step):
    got, ref = amp_step["metrics"], amp_step["jax_metrics"]
    for k in ("total_loss", "loss_ce", "loss_mask", "loss_dice", "grad_norm"):
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, got[k], ref[k])


def test_amp_gradients_point_like_jax(amp_step):
    ref, got = amp_step["jax_grads"], amp_step["grads"]
    keys = sorted(got)
    assert all(got[k].dtype == np.float32 for k in keys)  # f32 masters
    a = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    b = np.concatenate([ref[k].ravel() for k in keys]).astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= GRAD_COSINE


def test_amp_update_within_bounds_of_jax(amp_step):
    ref, got = amp_step["jax_params"], amp_step["params"]
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert np.isfinite(d).all()
    # Adam's step is ~lr = 1e-4 per element, so two sides that disagree on
    # an element's gradient sign are at most two steps apart
    assert d.max() <= 2.2e-4
    assert (d < 1e-6).mean() >= PARAMS_WITHIN_1E6
