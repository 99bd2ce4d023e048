"""PyTorch port, the LV-VIS evaluation
(``configs/openvoc_ytvis_coco/eval_lvvis.yaml``: SANOnline over ``lvvis_val``'s
1196 classes) against the JAX package on the CPU: a synthetic ``lvvis_val``
written in the dataset's own layout with the LV-VIS category table and read
by both packages' test loaders; ``YTVOSEval`` over the 1196 category ids and
``YTVISEvaluator`` with the LV-VIS table on one set of predictions; then the
recipe through the CLI (``--eval-only`` on a SANOnline checkpoint of the CLI
test's tiny shapes), its prompt-ensembled text bank over all 1196 names and
the 14 vild prompts (16,744 prompts) held to JAX's from the same CLIP file.

Shapes: the test-tiny CLIP (text width 64, 2 layers, context 77, as the JAX
bank tokenizes); the dataset three videos at 48x64 and 56x72 of 5, 3 and 6
frames; the CLI at ``tests/test_torch_port_cli.py``'s shapes.  The JAX bank
runs its tower under ``jax.jit`` (one chunk shape); nothing else here
compiles JAX.  Peak memory ~0.5 GB."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import openvis_tpu.config as jax_config
import train_net_torch
from openvis_tpu.data import catalog as jax_catalog
from openvis_tpu.data import loader as jax_loader
from openvis_tpu.evals import ytvis_eval as jax_eval
from openvis_tpu.models.clip import model as jax_model
from openvis_tpu.models.clip import tokenizer as jax_tokenizer
from openvis_tpu.models.clip.text_bank import TextEmbeddingBank as JaxBank
from openvis_tpu_torch import config as port_config
from openvis_tpu_torch import train
from openvis_tpu_torch.checkpoint import save_checkpoint
from openvis_tpu_torch.config import load_config
from openvis_tpu_torch.convert import init_params
from openvis_tpu_torch.data import catalog, loader, rle, synthetic
from openvis_tpu_torch.evals import ytvis_eval
from openvis_tpu_torch.models.clip import prompts
from openvis_tpu_torch.models.clip import synthetic as clip_synthetic
from test_torch_port_cli import D as CLI_D, cli_root  # noqa: F401  (the CLI's fixture)
from test_torch_port_san import SAN_YAML
from tools import convert_weights as jax_convert
from torch_port_common import one_thread_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "openvoc_ytvis_coco", "eval_lvvis.yaml")
LVVIS = "lvvis_val"
NUM_CLASSES = 1196
VIDEOS = ((48, 64, 5, 2), (56, 72, 3, 1), (48, 64, 6, 3))  # (h, w, frames, instances)
SHAPE = jax_model._MODEL_SHAPES["test-tiny"]
VOCAB = clip_synthetic.bpe_vocab_size()
CONTEXT = 77  # the JAX bank tokenizes to 77 tokens whatever the tower
# f32, the same arithmetic in another order (XLA against ATen): the bank's
# unit rows (tests/test_torch_port_clip.py's bound)
BANK_ATOL = 1e-5

one_thread = one_thread_fixture()


def _cfg(mod, root):
    cfg = mod.Config()
    inp = dataclasses.replace(cfg.input, min_size_test=48, max_size_test=96, pad_size=(64, 96))
    return dataclasses.replace(cfg, input=inp,
                               datasets=dataclasses.replace(cfg.datasets, root=root))


@pytest.fixture(scope="module")
def lvvis_root(tmp_path_factory):
    """A synthetic ``lvvis_val`` under a datasets root, in the dataset's own
    layout (``lvvis/val/JPEGImages``, ``lvvis/val_ytvis_style.json``), its
    instances drawn from the 1196 LV-VIS categories; the registered name
    resolves unchanged."""
    root = str(tmp_path_factory.mktemp("lvvis"))
    info = catalog.get(LVVIS)
    table = catalog.category_table(LVVIS)
    written = synthetic.write_ytvis_dataset(root, LVVIS, VIDEOS, table, seed=2, layout=info)
    assert written == info
    return root


def test_lvvis_layout_and_test_loader_match_jax(lvvis_root):
    """The port's ``lvvis_val`` entry equals JAX's, its category table is the
    1196 LV-VIS ids in order, and both packages' test loaders read the
    written dataset to the same videos and samples."""
    info, jinfo = catalog.get(LVVIS), jax_catalog.get(LVVIS)
    assert (info.image_root, info.json_file, info.thing_classes, info.id_map) == \
        (jinfo.image_root, jinfo.json_file, jinfo.thing_classes, jinfo.id_map)
    assert (info.image_root, info.json_file) == ("lvvis/val/JPEGImages",
                                                 "lvvis/val_ytvis_style.json")
    table = catalog.category_table(LVVIS)
    assert [c["id"] for c in table] == sorted(info.id_map) and len(table) == NUM_CLASSES
    assert [c["name"] for c in table] == list(info.thing_classes)
    ours = list(loader.test_videos(_cfg(port_config, lvvis_root), LVVIS))
    theirs = list(jax_loader.test_videos(_cfg(jax_config, lvvis_root), LVVIS))
    assert len(ours) == len(theirs) == len(VIDEOS)
    for (ra, sa), (rb, sb) in zip(ours, theirs):
        assert ra == rb
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _predictions(gt, rng):
    """Predictions of the GT boxes shifted by 0-6 pixels, a fifth of them in
    another LV-VIS category, plus one false positive a video in a category
    with no GT."""
    ids = sorted(catalog.get(LVVIS).id_map)
    sizes = {v["id"]: (v["height"], v["width"]) for v in gt["videos"]}
    preds = []
    for ann in gt["annotations"]:
        h, w = sizes[ann["video_id"]]
        masks = [rle.decode(s) for s in ann["segmentations"]]
        for shift in rng.choice(7, size=2, replace=False):
            cat = ann["category_id"] if rng.rand() < 0.8 else int(rng.choice(ids))
            segs = [rle.encode(np.roll(m, (int(shift), -int(shift) // 2), axis=(0, 1)))
                    for m in masks]
            preds.append({"video_id": ann["video_id"], "category_id": cat,
                          "score": float(rng.rand()), "segmentations": segs})
    for vid, (h, w) in sizes.items():
        m = np.zeros((h, w), np.uint8)
        m[:8, :8] = 1
        preds.append({"video_id": vid, "category_id": ids[-1], "score": float(rng.rand()),
                      "segmentations": [rle.encode(m)] * len(gt["videos"][vid - 1]["file_names"])})
    return preds


def _gt_and_predictions(root):
    with open(os.path.join(root, catalog.get(LVVIS).json_file)) as f:
        gt = json.load(f)
    assert len(gt["categories"]) == NUM_CLASSES
    return gt, _predictions(gt, np.random.RandomState(0))


def test_ytvoseval_over_the_lvvis_ids_matches_jax(lvvis_root):
    """``YTVOSEval`` over all 1196 category ids, the port's against JAX's on the
    written GT and one set of predictions: precision, recall, the summary and
    the per-category AP (NaN where a category has no GT, in both)."""
    gt, preds = _gt_and_predictions(lvvis_root)
    gts = [{k: a[k] for k in ("video_id", "category_id", "segmentations", "iscrowd")}
           for a in gt["annotations"]]
    cats = [c["id"] for c in gt["categories"]]
    ours, theirs = ytvis_eval.YTVOSEval(gts, preds, cats), jax_eval.YTVOSEval(gts, preds, cats)
    ours.accumulate()
    theirs.accumulate()
    assert ours.precision.shape[2] == NUM_CLASSES
    np.testing.assert_array_equal(ours.precision, theirs.precision)
    np.testing.assert_array_equal(ours.recall, theirs.recall)
    got = ours.summarize()
    assert got == theirs.summarize() and 0.0 < got["AP"] < 1.0
    per_cat = ours.per_category_ap()
    assert len(per_cat) == NUM_CLASSES
    np.testing.assert_equal(per_cat, theirs.per_category_ap())


def test_ytvis_evaluator_with_the_lvvis_table_matches_jax(lvvis_root):
    """``YTVISEvaluator`` with ``lvvis_val``'s table, the port's against JAX's on
    the same GT and predictions: the metrics and the per-category table."""
    gt, preds = _gt_and_predictions(lvvis_root)
    ev, jev = (ytvis_eval.YTVISEvaluator(catalog.get(LVVIS)),
               jax_eval.YTVISEvaluator(jax_catalog.get(LVVIS)))
    ev.predictions, jev.predictions = list(preds), list(preds)
    got = ev.evaluate(gt)
    assert got == jev.evaluate(gt) and 0.0 < got["AP"] < 1.0
    assert len(ev.per_category) == NUM_CLASSES
    np.testing.assert_equal(ev.per_category, jev.per_category)


def _recipe_yaml(root):
    """A yaml with ``eval_lvvis.yaml`` as ``_BASE_`` and the CLI test's tiny
    SAN settings; its test dataset stays the recipe's ``lvvis_val``."""
    body = SAN_YAML.format(d=CLI_D, root=root, train="torch_port_cli_train", eval=LVVIS)
    for line in ("  meta_architecture: SANOnline\n", "  num_classes: 2\n",
                 "  test: [lvvis_val]\n"):
        assert line in body, line
        body = body.replace(line, "")
    path = os.path.join(root, "tiny_eval_lvvis.yaml")
    with open(path, "w") as f:
        f.write(f"_BASE_: {RECIPE}\n" + body)
    return path


def _jax_bank(weights, bpe, names):
    """JAX's prompt-ensembled bank of ``names`` (its padded chunks of 256)
    from the CLIP file ``weights`` at the test-tiny shape."""
    state = {k: v.numpy() for k, v in torch.load(weights, weights_only=True).items()}
    tree = jax_convert.convert_clip(state)
    s = SHAPE
    tower = jax_model.CLIPTextEncoder(vocab_size=VOCAB, context_length=CONTEXT,
                                      width=s["text_width"], heads=s["text_heads"],
                                      layers=s["text_layers"], embed_dim=s["embed_dim"])
    return JaxBank(tower, tree["text"], jax_tokenizer.SimpleTokenizer(bpe),
                   prompts.get_templates("vild")).encode(names)


def test_eval_lvvis_through_the_cli(cli_root, lvvis_root):  # noqa: F811
    """``eval_lvvis.yaml --eval-only`` on a SANOnline checkpoint: the CLI's
    bank over the 1196 names and the 14 vild prompts (16,744 prompts, chunks
    of 256 unpadded) reaches the engine and equals JAX's bank from the same
    CLIP file row for row; every prediction names an LV-VIS id; the metrics
    over the 1196 ids are finite and written."""
    root, _ = cli_root
    path = _recipe_yaml(root)
    weights = os.path.join(root, "clip_tiny_77.pt")
    torch.save(clip_synthetic.openai_state_dict("test-tiny", seed=0, vocab_size=VOCAB,
                                                context_length=CONTEXT, dtype=torch.float32),
               weights)
    over = [f"datasets.root={lvvis_root}", f"output_dir={os.path.join(root, 'lvvis_out')}",
            f"model.clip_adapter.weights={weights}"]
    cfg = load_config(path, over)
    assert (cfg.model.meta_architecture, tuple(cfg.datasets.test)) == ("SANOnline", (LVVIS,))
    assert cfg.model.clip_adapter.prompt_name == "vild"
    model = init_params(train.build_model(cfg, device="cpu"), seed=0)
    ckpt = os.path.join(root, "lvvis_ckpt")
    save_checkpoint(ckpt, 1, {"step": 1, "params": model.state_dict()})
    seen = []
    evaluate = train_net_torch.engine.evaluate_dataset

    def spy(cfg, model, name, text, *a, **kw):
        seen.append((name, np.array(text)))
        return evaluate(cfg, model, name, text, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net_torch.engine, "evaluate_dataset", spy)
        train_net_torch.main(["--config-file", path, "--device", "cpu", "--eval-only",
                              "--weights", ckpt, *over])
    names = list(catalog.get(LVVIS).thing_classes)
    assert len(names) == NUM_CLASSES and names == list(jax_catalog.get(LVVIS).thing_classes)
    assert [name for name, _ in seen] == [LVVIS]
    rows = seen[0][1]
    assert rows.shape == (NUM_CLASSES, CLI_D) and rows.dtype == np.float32
    np.testing.assert_allclose(rows, _jax_bank(weights, cfg.model.clip_adapter.bpe_vocab, names),
                               rtol=0, atol=BANK_ATOL)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=-1), 1.0, atol=1e-6)
    out = cfg.output_dir
    with open(os.path.join(out, f"metrics_{LVVIS}.json")) as f:
        metrics = json.load(f)
    assert "AP" in metrics and all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(out, f"results_{LVVIS}.json")) as f:
        results = json.load(f)
    ids = set(catalog.get(LVVIS).id_map)
    assert results and {r["category_id"] for r in results} <= ids
    assert {r["video_id"] for r in results} == set(range(1, len(VIDEOS) + 1))
