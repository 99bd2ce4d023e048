"""PyTorch port, multi-process training and eval over ``torch.distributed``:
two gloo ranks on the CPU (spawned processes, a ``file://`` rendezvous, one
thread each), each holding one clip of a global batch of two, against one
process holding both, at the tiny shapes of ``tests/test_torch_parity_e2e.py``.

The JAX step differentiates the global batch's loss (``__graft_entry__.py:
151-160``: N devices give the loss of 1); so must N ranks here: the same loss
(1e-5 relative), the same reduced gradients (1e-5 of each tensor's largest
element) and, after two steps, parameters within 4 * base_lr (Adam moves a
parameter by about +-lr where its gradient is near zero, so a rounding
difference can flip the sign of that step).  The eval's video stride and its
gather on rank 0 give the predictions and metrics of one process (pattern
``tests/test_engine.py:285-330``).  This module imports no JAX: the ranks
import it."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openvis_tpu_torch import Config, engine, train
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog, loader, synthetic
from openvis_tpu_torch.parallel import dist
from openvis_tpu_torch.structures import ClipTargets

REPO = Path(__file__).resolve().parent.parent
K, D, T, H, W, N = 5, 32, 2, 64, 96, 3
DATASET = "torch_port_distributed_synth"
VIDEOS = [(48, 64, 5, 2), (48, 64, 3, 1), (64, 48, 4, 1)]
CATEGORIES = [{"id": 1, "name": "c1"}, {"id": 2, "name": "c2"}]
STEPS, WORLD, JOIN_S = 2, 2, 120
LOSS_RTOL, GRAD_REL_TO_MAX = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_config(root: str, out: str) -> Config:
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
        criterion=dataclasses.replace(cfg.model.criterion, train_num_points=64),
        test=dataclasses.replace(cfg.model.test, window_inference=True, window_size=4))
    return dataclasses.replace(
        cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False),
        input=dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96,
                                  pad_size=(64, 96), max_instances=6),
        datasets=dataclasses.replace(cfg.datasets, root=root, test=(DATASET,)),
        output_dir=out)


def global_batches():
    """STEPS global batches of WORLD clips, and the text."""
    rng = np.random.RandomState(0)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    out = []
    for _ in range(STEPS):
        valid = rng.rand(WORLD, N) > 0.3
        valid[:, 0] = True
        out.append({"pixels": torch.from_numpy(rng.randn(WORLD, T, H, W, 3).astype(np.float32)),
                    "text_feats": torch.from_numpy(text),
                    "targets": ClipTargets(torch.from_numpy(rng.randint(0, K, (WORLD, N))),
                                           torch.from_numpy(rng.rand(WORLD, N, T, H, W) > 0.7),
                                           torch.from_numpy(valid),
                                           torch.ones(WORLD, N, T, dtype=torch.bool))})
    return out


def _slice(batch, r: int):
    t = batch["targets"]
    s = slice(r, r + 1)
    return {"pixels": batch["pixels"][s], "text_feats": batch["text_feats"],
            "targets": ClipTargets(t.labels[s], t.masks[s], t.valid[s], t.frame_valid[s])}


def run(cfg: Config, rank: int, world: int):
    """Eval from the init, then STEPS train steps on this rank's slice: the
    eval metrics, the metrics and reduced gradients of each step, and the
    parameters after the last."""
    model = init_params(train.build_model(cfg, device="cpu"), seed=0)
    text = global_batches()[0]["text_feats"][:len(CATEGORIES)]
    eval_metrics = engine.evaluate_dataset(cfg, model, DATASET, text, device="cpu")
    step = train.build_train_step(cfg, model, K, device="cpu")
    grads, opt_step = [], step.state.opt.step

    def recording(params, g, norm=None):
        grads.append({n: v.clone() for n, v in g.items()})
        opt_step(params, g, norm)

    step.state.opt.step = recording
    metrics = []
    for batch in global_batches():
        part = batch if world == 1 else _slice(batch, rank)
        metrics.append({k: v.item() for k, v in step(part).items()})
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"eval": eval_metrics, "metrics": metrics, "grads": grads, "params": params}


def rank_main(init_file: str, rank: int, root: str, info_json: str, result: str) -> None:
    """One rank of the two (run as a script by the test)."""
    torch.set_num_threads(1)
    info = json.loads(info_json)
    info["id_map"] = {int(k): v for k, v in info["id_map"].items()}
    info["thing_classes"] = tuple(info["thing_classes"])
    catalog.register(catalog.DatasetInfo(**info))
    dist.init_distributed(f"file://{init_file}", WORLD, rank, device="cpu")
    try:
        out = run(tiny_config(root, os.path.join(root, "out_2ranks")), rank, WORLD)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, result)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("distributed"))
    info = synthetic.write_ytvis_dataset(root, DATASET, VIDEOS, CATEGORIES, seed=0)
    catalog.register(info)
    return root, info


@pytest.fixture(scope="module")
def runs(dataset):
    root, info = dataset
    info_json = json.dumps(dataclasses.asdict(info))
    code = ("import json, sys\n"
            "import tests.test_torch_port_distributed as t\n"
            "a = json.loads(sys.argv[1])\n"
            "t.rank_main(a['init'], a['rank'], a['root'], a['info'], a['result'])\n")
    procs = []
    try:
        for r in range(WORLD):
            args = {"init": os.path.join(root, "rendezvous"), "rank": r, "root": root,
                    "info": info_json, "result": os.path.join(root, f"rank{r}.pt")}
            with open(os.path.join(root, f"rank{r}.err"), "w") as err:
                procs.append(subprocess.Popen([sys.executable, "-c", code, json.dumps(args)],
                                              cwd=str(REPO), stderr=err))
        one = run(tiny_config(root, os.path.join(root, "out_1rank")), 0, 1)
        for p in procs:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank did not finish in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(root, f"rank{r}.err")) as err:
            assert p.returncode == 0, err.read()[-3000:]
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return root, one, ranks


def test_two_ranks_give_the_loss_and_gradients_of_one(runs):
    _, one, ranks = runs
    for s in range(STEPS):
        for k, v in one["metrics"][s].items():
            for r in ranks:
                assert abs(r["metrics"][s][k] - v) <= LOSS_RTOL * abs(v), (s, k)
        for n, g in one["grads"][s].items():
            for r in ranks:
                err = (r["grads"][s][n] - g).abs().max().item()
                if n.endswith("k_proj.bias"):
                    # the exact gradient is 0 (softmax is shift-invariant):
                    # every side computes rounding noise
                    assert err < 1e-5 and g.abs().max().item() < 1e-5, (s, n)
                    continue
                assert err <= GRAD_REL_TO_MAX * g.abs().max().item(), (s, n, err)


def test_two_ranks_stay_in_step_with_one(runs):
    _, one, ranks = runs
    lr = tiny_config("", "").solver.base_lr
    for n, p in one["params"].items():
        assert torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]), n
        assert (ranks[0]["params"][n] - p).abs().max().item() <= 4 * lr, n


def test_two_rank_eval_gathers_the_predictions_of_one(runs):
    root, one, ranks = runs
    assert ranks[1]["eval"] == {}
    assert set(one["eval"]) >= {"AP", "AP50"}
    for k, v in one["eval"].items():
        assert ranks[0]["eval"][k] == pytest.approx(v, abs=1e-6), k
    preds = []
    for out in ("out_1rank", "out_2ranks"):
        with open(os.path.join(root, out, f"results_{DATASET}.json")) as f:
            preds.append(json.load(f))
    assert len(preds[0]) == len(preds[1]) > 0
    records = [rec["video_id"] for rec, _ in
               loader.test_videos(tiny_config(root, ""), DATASET, None, 0, 1)]
    for p in preds:
        assert list(dict.fromkeys(x["video_id"] for x in p)) == records == [1, 2, 3]
    for a, b in zip(*preds):
        assert (a["video_id"], a["category_id"], a["segmentations"]) == \
            (b["video_id"], b["category_id"], b["segmentations"])
        assert a["score"] == pytest.approx(b["score"], abs=1e-6)


def test_test_videos_stride_counts_max_videos_globally(dataset):
    root, _ = dataset
    cfg = tiny_config(root, "")
    def ids(max_videos):
        return [[rec["video_id"] for rec, _ in loader.test_videos(cfg, DATASET, max_videos, r, 2)]
                for r in (0, 1)]

    assert ids(3) == [[1, 3], [2]]
    assert ids(2) == [[1], [2]]


def test_gather_restores_the_record_order():
    """Rank p evaluated records p, p + 2, ...; the gathered predictions come
    back in record order, whatever the records' video ids (a BURST json's
    sequences need not ascend) and however many predictions a video has."""
    ids = [7, 3, 9, 1, 4]                      # video ids in record order
    counts = [2, 0, 3, 1, 2]                   # predictions of each record
    one = [{"video_id": v, "k": k} for v, n in zip(ids, counts) for k in range(n)]
    parts = []
    for r in range(2):
        mine = range(r, len(ids), 2)
        parts.append(([{"video_id": ids[i], "k": k} for i in mine for k in range(counts[i])],
                      [counts[i] for i in mine]))
    assert engine._record_order(parts) == one
    assert engine._record_order([(one, counts)]) == one
