"""PyTorch port, the eval engine's API on the CPU, over the synthetic YTVIS
dataset and the tiny model of ``tests/test_torch_port_engine.py`` (whose
tests hold the engine to the JAX engine): under AMP eval and in f32 the
caller's f32 parameters are left as they were; what is not ported is
refused naming its ROADMAP.md item; in a fresh interpreter the engine runs
without JAX and launches no kernel on the CPU."""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import engine, train
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog, synthetic
from openvis_tpu_torch.evals.burst_eval import BURSTEvaluator
from test_torch_port_engine import CATEGORIES, D, DATASET, K, REPO, SETTINGS, VIDEOS, _cfg
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset (registered in the port's catalog), the text rows and the
    port's model from its seeded init."""
    root = str(tmp_path_factory.mktemp("engine_api"))
    catalog.register(synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0))
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    model = init_params(train.build_model(_cfg(port_config, root, True, False, "unused"),
                                          device="cpu"), seed=0)
    return root, text, model


def test_amp_eval_leaves_the_callers_parameters(setup):
    root, text, pm = setup
    for name, (windowed, amp) in SETTINGS.items():
        before = {n: p.detach().clone() for n, p in pm.named_parameters()}
        engine.evaluate_dataset(_cfg(port_config, root, windowed, amp, f"port_{name}"), pm,
                                DATASET, text, device="cpu")
        assert all(torch.equal(before[n], p) and p.dtype == torch.float32
                   for n, p in pm.named_parameters()), name


def test_engine_refuses_what_is_not_ported(setup):
    root, text, pm = setup
    cfg = _cfg(port_config, root, True, False, "refused")
    # the CLIP ensemble is ported (tests/test_torch_port_clip_ensemble.py), so
    # is its mask-adapted tower (tests/test_torch_port_mask_adapted.py): the
    # engine hands the tower each crop's soft mask
    adapted = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, clip_adapter=dataclasses.replace(cfg.model.clip_adapter, name="bg_adapted",
                                                    clip_ensemble=True,
                                                    clip_model_name="test-tiny")))
    seen = []

    def tower(crops, masks=None):  # (R, 64, 64, 3), (R, 64, 64) -> (R, D)
        seen.append((tuple(crops.shape), None if masks is None else tuple(masks.shape)))
        return crops.mean(dim=(1, 2)).repeat(1, -(-D // 3))[:, :D]

    metrics = engine.evaluate_dataset(adapted, pm, DATASET, text, clip_visual_apply=tower,
                                      device="cpu")
    q = cfg.model.transformer_decoder.num_queries
    assert seen and all(s == ((q, 64, 64, 3), (q, 64, 64)) for s in seen), seen
    assert np.isfinite(list(metrics.values())).all()
    # BriVIS, OpenVISOnline and the offline archs are ported
    # (tests/test_torch_port_brivis_engine.py, tests/test_torch_port_openvis_engine.py,
    # tests/test_torch_port_offline_engine.py), so are OV2Seg
    # (tests/test_torch_port_ov2seg_engine.py) and MasQCLIP, single-shot
    # (tests/test_torch_port_masqclip_engine.py); an unknown arch raises
    for arch in ("OV2SegOnline", "OV2Seg", "MasQCLIP"):
        train.check_arch(arch)
    assert engine.is_single_shot("MasQCLIP")
    unknown = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, meta_architecture="MaskCLIP"))
    with pytest.raises(ValueError, match="unknown meta architecture"):
        engine.evaluate_dataset(unknown, pm, DATASET, text, device="cpu")
    # BURST evaluation is ported (tests/test_torch_port_burst.py)
    burst = engine.make_evaluator(catalog.get("burst_val"))
    assert isinstance(burst, BURSTEvaluator)
    assert burst.class_splits == catalog.burst_class_splits()
    assert len(burst.class_splits["common"]) + len(burst.class_splits["uncommon"]) == 482


def test_engine_runs_without_jax_in_fresh_interpreter(setup):
    """The port's evaluate_dataset on the CPU imports neither JAX nor the
    JAX package, and its CPU path launches no kernel."""
    root = setup[0]
    info = dataclasses.asdict(catalog.get(DATASET))
    script = textwrap.dedent(f"""
        import dataclasses, os, sys
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from openvis_tpu_torch import config, engine, train
        from openvis_tpu_torch.convert import init_params
        from openvis_tpu_torch.data import catalog
        from openvis_tpu_torch.ops import hungarian_cuda, msda_cuda
        K, D, DATASET = {K}, {D}, {DATASET!r}
    """) + inspect.getsource(_cfg) + textwrap.dedent(f"""
        catalog.register(catalog.DatasetInfo(**{info!r}))
        cfg = _cfg(config, {root!r}, True, True, "fresh")
        model = init_params(train.build_model(cfg, device="cpu"), seed=1)
        text = np.eye(K, D, dtype=np.float32)
        metrics = engine.evaluate_dataset(cfg, model, DATASET, text, device="cpu")
        assert set(metrics) >= {{"AP", "AP50", "AR10"}}, metrics
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        assert msda_cuda.launches == 0 and hungarian_cuda.launches == 0
        leaked = [m for m in ("jax", "openvis_tpu") if m in sys.modules]
        assert not leaked, leaked
        print("OK")
    """)
    # one intra-op thread, as the test workers share the machine's cores
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=root,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
