"""PyTorch port, the whole SimpleBaselineOnline eval slice against the JAX
package's ``make_eval_fn`` at a tiny size (64x96 frames, 2 encoder and 2
decoder layers, Q=8, hidden 64, 4 heads), in f32 and in bf16, plus a check in a
fresh interpreter that the port runs without JAX."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvis_tpu.train as jax_train
from openvis_tpu.config import Config
from openvis_tpu_torch import train
from openvis_tpu_torch.convert import load_flax_params
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

K, D = 5, 32
T, H, W = 2, 64, 96
HID, Q = 64, 8
REPO = Path(__file__).resolve().parent.parent


def _cfg() -> Config:
    cfg = Config()
    m = dataclasses.replace(
        cfg.model,
        num_classes=K,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, conv_dim=HID, mask_dim=HID,
            transformer_enc_layers=2, dim_feedforward=128, num_heads=4, num_points=4,
        ),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name="frame_embedding", hidden_dim=HID,
            num_queries=Q, nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID,
            clip_embed_dim=D,
        ),
    )
    return dataclasses.replace(cfg, model=m)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    rng = np.random.RandomState(0)
    frames = rng.randn(T, H, W, 3).astype(np.float32)
    text = rng.randn(K, D).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jm = jax_train.build_model(cfg)
    params = jax.jit(lambda f, x: jm.init(jax.random.PRNGKey(0), f, T, x))(
        jnp.asarray(frames), jnp.asarray(text))["params"]
    # randomized norm affines (init 1/0 hides order bugs)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1 + 1.0)
        if "norm" in "/".join(str(getattr(k, "key", k)) for k in p).lower() else v,
        params,
    )
    tm = load_flax_params(train.build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return cfg, jm, params, tm, frames, text


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_eval_fn_matches_jax_f32(setup):
    cfg, jm, params, tm, frames, text = setup
    ref = jax.jit(jax_train.make_eval_fn(cfg, jm))(params, jnp.asarray(frames), jnp.asarray(text))
    out = train.make_eval_fn(cfg, tm)(torch.from_numpy(frames), torch.from_numpy(text))
    assert set(out) == set(ref)
    for name in ("labels", "query_idx"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)
    for name in ("scores", "entropy", "mask_logits"):
        assert tuple(out[name].shape) == ref[name].shape, name
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


# bf16: the two frameworks round at different places (resize weights, the
# attention scale, reductions), the decoder's attention mask reads the SIGN
# of bf16 mask logits, and the scores are a softmax of 100 * cosine: observed
# on three seeds, outputs differ by <= 5 % of their largest magnitude, mask
# signs agree on >= 99 % of pixels, and the top-k scores shift by <= 0.06.
BF16_REL_TO_MAX = 0.06
BF16_SIGN_AGREE = 0.98
BF16_SCORE_ATOL = 0.1


def test_forward_and_eval_match_jax_bf16(setup):
    cfg, jm, params, tm, frames, text = setup
    # the casts under one jit: eagerly each parameter's shape compiles its own
    pb, fb, xb = jax.jit(lambda *t: jax.tree.map(lambda x: x.astype(jnp.bfloat16), t))(
        params, jnp.asarray(frames), jnp.asarray(text))
    ref = jax.jit(lambda p, f, x: jm.apply({"params": p}, f, T, x))(pb, fb, xb)
    tb = tm.to(torch.bfloat16)
    frames_b, text_b = torch.from_numpy(frames).bfloat16(), torch.from_numpy(text).bfloat16()
    with torch.no_grad():
        out = tb(frames_b, T, text_b)
    for name in ("pred_logits", "pred_masks", "pred_embeds"):
        assert out[name].dtype == torch.bfloat16, name
        r, o = _np(ref[name]), out[name].float().numpy()
        assert o.shape == r.shape, name
        assert np.abs(o - r).max() <= BF16_REL_TO_MAX * np.abs(r).max(), name
    r, o = _np(ref["pred_masks"]), out["pred_masks"].float().numpy()
    assert ((r > 0) == (o > 0)).mean() >= BF16_SIGN_AGREE

    ref_e = jax.jit(jax_train.make_eval_fn(cfg, jm))(pb, fb, xb)
    out_e = train.make_eval_fn(cfg, tb)(frames_b, text_b)
    for name in ref_e:
        assert tuple(out_e[name].shape) == ref_e[name].shape, name
        assert torch.isfinite(out_e[name].float()).all(), name
    # top-k order among near-ties differs: compare the sorted scores
    np.testing.assert_allclose(np.sort(out_e["scores"].float().numpy()),
                               np.sort(_np(ref_e["scores"])), atol=BF16_SCORE_ATOL)


def test_port_runs_without_jax_in_fresh_interpreter():
    """The port imports neither JAX nor the JAX package, through an eval
    window (frame and video decoder) and a train step, and its CPU path
    launches no kernel."""
    script = textwrap.dedent(f"""
        import dataclasses, sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from openvis_tpu_torch import Config, engine, train
        from openvis_tpu_torch.convert import init_params
        from openvis_tpu_torch.models.meta import video_maskformer
        from openvis_tpu_torch.ops import hungarian_cuda, msda_cuda, point_sample_cuda
        from openvis_tpu_torch.structures import ClipTargets
        cfg = Config()
        m = dataclasses.replace(
            cfg.model, num_classes=3,
            criterion=dataclasses.replace(cfg.model.criterion, train_num_points=16),
            pixel_decoder=dataclasses.replace(
                cfg.model.pixel_decoder, conv_dim=64, mask_dim=64,
                transformer_enc_layers=1, dim_feedforward=64, num_heads=4),
            transformer_decoder=dataclasses.replace(
                cfg.model.transformer_decoder, hidden_dim=64, num_queries=4,
                nheads=4, dim_feedforward=64, dec_layers=1, mask_dim=64,
                clip_embed_dim=16))
        cfg = dataclasses.replace(cfg, model=m)
        model = init_params(train.build_model(cfg, device="cpu"), seed=0)
        g = torch.Generator().manual_seed(0)
        out = train.make_eval_fn(cfg, model)(
            torch.randn(3, 64, 96, 3, generator=g), torch.randn(3, 16, generator=g))
        assert out["mask_logits"].shape == (10, 3, 16, 24), out["mask_logits"].shape
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        # the offline path: the video decoder, clip-level scores
        vcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, meta_architecture="SimpleBaseline",
            transformer_decoder=dataclasses.replace(cfg.model.transformer_decoder,
                                                    name="video_embedding")))
        vmodel = init_params(train.build_model(vcfg, device="cpu"), seed=0)
        vout = train.make_eval_fn(vcfg, vmodel)(
            torch.randn(3, 64, 96, 3, generator=g), torch.randn(3, 16, generator=g))
        assert vout["mask_logits"].shape == (10, 3, 16, 24), vout["mask_logits"].shape
        assert engine.is_single_shot("SimpleBaseline") and video_maskformer.VideoMaskFormerModel
        step = train.build_train_step(cfg, model, 3, device="cpu")
        batch = dict(pixels=torch.randn(1, 2, 64, 96, 3, generator=g),
                     text_feats=torch.randn(3, 16, generator=g),
                     targets=ClipTargets(torch.tensor([[0, 2]]),
                                         torch.rand(1, 2, 2, 64, 96, generator=g) > 0.8,
                                         torch.ones(1, 2, dtype=torch.bool),
                                         torch.ones(1, 2, 2, dtype=torch.bool)))
        metrics = step(batch, g)
        assert all(torch.isfinite(v) for v in metrics.values()), metrics
        assert msda_cuda.launches == 0 and hungarian_cuda.launches == 0
        assert msda_cuda.dcoord_launches == msda_cuda.dvalue_launches == 0
        assert point_sample_cuda.fwd_launches == point_sample_cuda.dvalue_launches == 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] == "openvis_tpu")
        assert not leaked, leaked
        print("OK")
    """)
    # one intra-op thread, as the test workers share the machine's cores
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO / "openvis_tpu_torch"),
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
