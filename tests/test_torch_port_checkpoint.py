"""PyTorch port, checkpoints: ``openvis_tpu_torch/checkpoint.py`` (the port of
``openvis_tpu/checkpoint.py``, ``torch.save`` in place of orbax) and the train
step's ``TrainState``, on the CPU at the tiny shapes of
``tests/test_torch_parity_e2e.py``: a round trip, keep-5 retention, a save
that dies midway, ``merge_pretrained``, a run of 2 + 2 steps resumed from its
checkpoint against 4 uninterrupted steps (pattern ``tests/test_engine.py:
112-140``), and the global gradient norm, computed once a step, against the
clip it used to compute for itself."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from openvis_tpu_torch import Config, train
from openvis_tpu_torch.checkpoint import (
    latest_step,
    load_checkpoint,
    load_params_from_checkpoint,
    merge_pretrained,
    restore_checkpoint,
    save_checkpoint,
)
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.parallel.train_step import AdamW, global_norm, step_seed
from openvis_tpu_torch.structures import ClipTargets

K, D, T, H, W, N = 5, 32, 2, 64, 96, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_config() -> Config:
    cfg = Config()
    m = dataclasses.replace(
        cfg.model, num_classes=K,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=64, mask_dim=64, transformer_enc_layers=2,
            dim_feedforward=128, num_heads=4, num_points=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="frame_embedding", hidden_dim=64,
            num_queries=8, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=64,
            clip_embed_dim=D),
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=64))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(
        cfg.solver, amp=False, warmup_iters=2, warmup_factor=0.5, steps=(1,)))


def batches(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    out = []
    for _ in range(n):
        out.append({"pixels": torch.from_numpy(rng.randn(1, T, H, W, 3).astype(np.float32)),
                    "text_feats": torch.from_numpy(text),
                    "targets": ClipTargets(
                        torch.from_numpy(rng.randint(0, K, (1, N))),
                        torch.from_numpy(rng.rand(1, N, T, H, W) > 0.7),
                        torch.tensor([[True, True, False]]),
                        torch.ones(1, N, T, dtype=torch.bool))})
    return out


def fresh_step(cfg, seed=0):
    model = init_params(train.build_model(cfg, device="cpu"), seed=seed)
    return train.build_train_step(cfg, model, K, device="cpu")


def params_of(step):
    return {n: p.detach().clone() for n, p in step.state.model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """4 uninterrupted steps; 2 steps, a checkpoint, a fresh process state
    (another init) restored from it, 2 more steps."""
    cfg = tiny_config()
    data = batches(4)
    whole = fresh_step(cfg)
    metrics_whole = [whole(b) for b in data]
    ckpt = str(tmp_path_factory.mktemp("resume") / "ckpt")
    first = fresh_step(cfg)
    metrics_first = [first(b) for b in data[:2]]
    save_checkpoint(ckpt, first.state.step, first.state.state_dict())
    saved = {k: (copy.deepcopy(v) if isinstance(v, dict) else v)
             for k, v in first.state.state_dict().items()}
    resumed = fresh_step(cfg, seed=1)
    assert restore_checkpoint(ckpt, resumed.state) is resumed.state
    restored = {"params": params_of(resumed), "step": resumed.state.step,
                **copy.deepcopy(resumed.state.opt.state_dict())}
    metrics_resumed = [resumed(b) for b in data[2:]]
    return {"whole": whole, "resumed": resumed, "saved": saved, "restored": restored,
            "metrics_whole": metrics_whole, "metrics_first": metrics_first,
            "metrics_resumed": metrics_resumed, "ckpt": ckpt, "cfg": cfg}


def test_restored_state_equals_the_checkpoint(runs):
    saved, restored = runs["saved"], runs["restored"]
    assert restored["step"] == saved["step"] == 2 and restored["count"] == saved["count"] == 2
    for part in ("params", "mu", "nu"):
        assert set(restored[part]) == set(saved[part])
        for n, t in saved[part].items():
            assert torch.equal(restored[part][n], t), (part, n)
    opt = runs["resumed"].state.opt
    # the schedule continues from the restored count: the warm-up ends at 2,
    # the decay (at 1 after it) applies to the fourth step
    assert opt.lr(restored["count"]) == runs["cfg"].solver.base_lr
    assert opt.lr(restored["count"] + 1) == pytest.approx(1e-5)


def test_resumed_run_equals_the_uninterrupted_one(runs):
    a, b = params_of(runs["whole"]), params_of(runs["resumed"])
    for n, p in a.items():
        tol = 1e-6 * p.abs().max().item()
        assert (b[n] - p).abs().max().item() <= tol, n
    got = runs["metrics_first"] + runs["metrics_resumed"]
    for ma, mb in zip(runs["metrics_whole"], got):
        for k in ma:
            assert abs(ma[k].item() - mb[k].item()) <= 1e-6 * abs(ma[k].item()), k
    assert runs["whole"].state.opt.count == runs["resumed"].state.opt.count == 4


def test_round_trip_and_params_reader(runs):
    sd = load_checkpoint(runs["ckpt"])
    assert latest_step(runs["ckpt"]) == 2 and sd["step"] == 2
    params = load_params_from_checkpoint(runs["ckpt"])
    assert all(torch.equal(params[n], t) for n, t in runs["saved"]["params"].items())
    assert all(t.device.type == "cpu" for t in params.values())


def test_keep_latest_five_and_a_save_that_dies(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    state = {"step": 0, "params": {"w": torch.zeros(3)}, "mu": {}, "nu": {}, "count": 0}
    for s in range(1, 8):
        save_checkpoint(d, s, dict(state, step=s))
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.pt" for s in range(3, 8)]

    def dies(obj, f):
        f.write(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError):
        save_checkpoint(d, 8, dict(state, step=8))
    monkeypatch.undo()
    assert latest_step(d) == 7 and load_checkpoint(d)["step"] == 7


def test_merge_pretrained_partial():
    params = {"segmenter.a": torch.zeros(3), "segmenter.b": torch.ones(2),
              "other.c": torch.ones(1)}
    out = merge_pretrained(params, {"a": torch.full((3,), 5.0)}, subtree="segmenter")
    assert torch.equal(out["segmenter.a"], torch.full((3,), 5.0))
    assert torch.equal(out["segmenter.b"], torch.ones(2))
    assert torch.equal(out["other.c"], torch.ones(1))
    assert torch.equal(params["segmenter.a"], torch.zeros(3))  # the input is not changed


def test_grad_norm_once_keeps_the_clip():
    """One process: the step's grad_norm is the norm of the loss's
    gradients, and its update (clip from that norm) equals AdamW computing the
    norm itself, bit for bit."""
    cfg = tiny_config()
    step = fresh_step(cfg)
    ref_model = copy.deepcopy(step.state.model)
    batch = batches(1, seed=1)[0]
    metrics = step(batch)

    loss_fn = train.make_loss_fn(cfg, ref_model, K)
    params = dict(ref_model.named_parameters())
    opt = AdamW(cfg, params, train.config_labels(cfg, ref_model))
    names = list(opt.hyper)
    gen = torch.Generator().manual_seed(step_seed(cfg.seed, 0))
    loss, _ = loss_fn(params, batch, gen)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    norm = global_norm(grads.values())
    assert metrics["grad_norm"].item() == norm.item() > cfg.solver.clip_value  # clipped
    assert metrics["total_loss"].item() == loss.item()
    opt.step(params, grads)
    for n, p in step.state.model.named_parameters():
        assert torch.equal(p, params[n]), n
