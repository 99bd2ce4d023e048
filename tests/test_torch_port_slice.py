"""PyTorch port, the whole SimpleBaselineOnline eval slice against the JAX
package's ``make_eval_fn`` at a tiny size (64x96 frames, 2 encoder and 2
decoder layers, Q=8, hidden 64, 4 heads), in f32 and in bf16, plus a check in a
fresh interpreter that the port runs without JAX."""

import dataclasses
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
    tm = load_flax_params(train.build_model(cfg), jax.tree.map(np.asarray, params))
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
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    fb, xb = jnp.asarray(frames).astype(jnp.bfloat16), jnp.asarray(text).astype(jnp.bfloat16)
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
    """The port imports no JAX, and its CPU path launches no kernel."""
    script = textwrap.dedent(f"""
        import dataclasses, sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from openvis_tpu_torch import Config, train
        from openvis_tpu_torch.convert import init_params
        from openvis_tpu_torch.ops import hungarian_cuda, msda_cuda
        cfg = Config()
        m = dataclasses.replace(
            cfg.model, num_classes=3,
            pixel_decoder=dataclasses.replace(
                cfg.model.pixel_decoder, conv_dim=64, mask_dim=64,
                transformer_enc_layers=1, dim_feedforward=64, num_heads=4),
            transformer_decoder=dataclasses.replace(
                cfg.model.transformer_decoder, hidden_dim=64, num_queries=4,
                nheads=4, dim_feedforward=64, dec_layers=1, mask_dim=64,
                clip_embed_dim=16))
        cfg = dataclasses.replace(cfg, model=m)
        model = init_params(train.build_model(cfg), seed=0)
        g = torch.Generator().manual_seed(0)
        out = train.make_eval_fn(cfg, model)(
            torch.randn(3, 64, 96, 3, generator=g), torch.randn(3, 16, generator=g))
        assert out["mask_logits"].shape == (10, 3, 16, 24), out["mask_logits"].shape
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        assert msda_cuda.launches == 0 and hungarian_cuda.launches == 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO / "openvis_tpu_torch"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
