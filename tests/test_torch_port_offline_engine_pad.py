"""PyTorch port, the offline archs' single shot on the CPU: the video
decoder's attention over the clip is not masked, so the engine pads a video
to ``_bucket(t)`` frames with its last frame as the JAX engine does
(``tests/test_torch_port_offline_engine.py`` holds the engine to the JAX
engine); the config is that file's offline OpenVIS."""

import numpy as np
import torch

from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import engine, train
from openvis_tpu_torch.convert import init_params
from test_torch_port_offline_engine import D, K, _cfg
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


def test_single_shot_pads_as_the_jax_engine(tmp_path):
    """The video decoder's attention over the clip is not masked: the 5-frame
    video's single shot of 8 (its last frame repeated) differs from a shot of
    its 5 real frames, so the engine must pad as the JAX engine does."""
    cfg = _cfg(port_config, "openvis", str(tmp_path), "pad")
    model = init_params(train.build_model(cfg, device="cpu"), seed=2)
    params = {n: p.detach() for n, p in model.named_parameters()}
    fn = engine.make_single_shot_fn(cfg, model, pre_topk=True)
    frames = torch.from_numpy(np.random.RandomState(3).randn(5, 64, 96, 3).astype(np.float32))
    with torch.inference_mode():
        probs5, masks5 = fn(params, frames, torch.zeros(K, D), torch.ones(5, dtype=torch.bool))
        padded = torch.cat([frames, frames[-1:].expand(3, -1, -1, -1)])
        probs8, masks8 = fn(params, padded, torch.zeros(K, D), torch.arange(8) < 5)
    assert masks8.shape[1] == 8 and probs8.shape == probs5.shape == (8, 1)
    assert not torch.allclose(masks8[:, :5], masks5, atol=1e-4)
