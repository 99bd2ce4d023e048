"""PyTorch port: its own copy of the configuration, held to the JAX package's;
the entry points' device default; and no import of the JAX package."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import openvis_tpu.config as jax_config
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import train
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

REPO = Path(__file__).resolve().parent.parent


def test_default_config_matches_jax():
    assert dataclasses.asdict(port_config.Config()) == dataclasses.asdict(jax_config.Config())


@pytest.mark.parametrize("name", [
    "openvoc_ytvis_coco/san_online_R50_bs16_6000st.yaml",
    "openvoc_ytvis_coco/simplebsl_online_R50_bs8_12000st.yaml",
])
def test_yaml_loads_the_same(name):
    path = str(REPO / "configs" / name)
    overrides = ["solver.base_lr=0.0002", "model.criterion.train_num_points=64"]
    port = port_config.load_config(path, overrides)
    ref = jax_config.load_config(path, overrides)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "openvis_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("openvis_tpu", "jax", "flax", "optax")]
    assert not bad, bad


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = port_config.Config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_model(cfg)
    model = train.build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_train_step(cfg, model, num_text_classes=3)
