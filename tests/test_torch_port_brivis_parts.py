"""PyTorch port, BriVIS's parts against the JAX package on the CPU: the
resampler's 1-D convolutions (even kernels refused, rank-3 kernels through
``convert``), the tree and its parameter groups, and the criterion with a
fixed assignment and the tracking matcher.  Shapes and helpers:
``tests/test_torch_port_brivis.py``."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvis_tpu.losses.criterion as jcrit
import openvis_tpu.train as jax_train
from openvis_tpu.models import resampler as jax_resampler
from openvis_tpu.models.segmenter import Segmenter as JaxSegmenter
from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.parallel.train_step import label_params as jax_label_params
from openvis_tpu.structures import ClipTargets as JaxTargets
from openvis_tpu_torch import Config, train
from openvis_tpu_torch.convert import (
    flax_from_state_dict,
    flax_path,
    init_params,
    load_flax_params,
    params_from_flax,
)
from openvis_tpu_torch.losses import criterion
from openvis_tpu_torch.models import resampler
from openvis_tpu_torch.parallel.train_step import label_params
from openvis_tpu_torch.structures import ClipTargets

from test_torch_port_san import LOSS_RTOL, _batch, _rel  # noqa: F401  (fixtures and helpers)
from test_torch_port_brivis import (  # noqa: F401  (fixtures and helpers)
    B,
    D,
    H,
    K,
    N,
    RESAMPLERS,
    T,
    W,
    _criterion_inputs,
    _settings,
    brivis_cfg,
    tiny_clip,
)


def test_even_conv_kernels_raise():
    with pytest.raises(ValueError, match="must be odd"):
        resampler.TemporalResampler(64, 128, 4, 1, (4, 3))


def test_rank3_kernels_round_trip_and_convolve_as_flax():
    rng = np.random.RandomState(5)
    conv = init_params(torch.nn.Conv1d(6, 4, 5), seed=5)
    tree = flax_from_state_dict(conv.state_dict())
    assert tree["kernel"].shape == (5, 6, 4)                   # flax (k, in, out)
    np.testing.assert_array_equal(tree["kernel"],
                                  conv.weight.detach().numpy().transpose(2, 1, 0))
    back = params_from_flax(tree)
    assert set(back) == {"weight", "bias"}
    assert torch.equal(back["weight"], conv.weight.detach())
    # lecun-normal over fan-in in * k, as flax draws it
    big = init_params(torch.nn.Conv1d(64, 64, 5), seed=6).weight
    assert abs(big.std().item() - (64 * 5) ** -0.5) < 0.1 * (64 * 5) ** -0.5
    x = rng.randn(3, 9, 6).astype(np.float32)                   # (N, T, C) channels-last
    ref = fnn.Conv(4, (5,), padding="VALID").apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert _rel(got, ref) <= 1e-5


def _jax_resampler(name, cfg):
    """JAX's resampler of kind ``name`` as ``BriVISModel.setup`` builds it."""
    m = cfg.model
    kw = dict(hidden_dim=m.transformer_decoder.hidden_dim,
              feed_dim=m.transformer_decoder.dim_feedforward, nheads=m.transformer_decoder.nheads,
              nlayers=m.resampler.num_layers, conv_kernels=tuple(m.resampler.conv_kernels))
    if name == "decoupled":
        return jax_resampler.DecoupledTemporalResampler(
            nqueries=m.transformer_decoder.num_queries, **kw)
    if name == "raw":
        return jax_resampler.RawTemporalResampler(**kw)
    return jax_resampler.TemporalResampler(**kw)


def _children(cfg):
    """``BriVISModel.setup``'s submodules for ``cfg``, bound and untraced:
    {scope name: module}."""
    bound = jax_train.build_model(cfg).bind({})
    bound._try_setup()
    return dict(bound._state.children)


def _fields(module):
    return {f.name: getattr(module, f.name) for f in dataclasses.fields(module)
            if f.name not in ("parent", "name")}


def test_brivis_tree_loads_into_the_port_and_groups_match_jax():
    """The JAX model's parameter tree (shapes by ``eval_shape``) loads into the
    port strictly, for each resampler; the groups equal JAX's ``label_params``
    on the same tree; the decoupled queries draw N(0, 1).  The model is traced
    once: the resampler's kind changes only the ``resampler`` subtree
    (``BriVISModel.setup``, checked on each kind's bound model: the same
    submodules, the resampler the kind's own), which each kind's module gives
    on its own from the segmenter's traced outputs (the temporal one held to
    the model's)."""
    jm = jax_train.build_model(brivis_cfg(JaxConfig, RESAMPLERS[0]))
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T, jnp.zeros((K, D)),
        capture_intermediates=lambda mdl, method: (isinstance(mdl, JaxSegmenter)
                                                   and method == "__call__")))
    seg = variables["intermediates"]["segmenter"]["__call__"][0]
    inputs = [seg["pred_embeds"], seg["mask_feats"], seg["attn_feats"]]
    first = _children(brivis_cfg(JaxConfig, RESAMPLERS[0]))
    assert set(first) == set(variables["params"])
    for name in RESAMPLERS:
        jcfg, cfg = brivis_cfg(JaxConfig, name), brivis_cfg(Config, name)
        kids = _children(jcfg)
        assert {k: type(v) for k, v in kids.items()} == \
            {k: type(v) for k, v in first.items() if k != "resampler"} | \
            {"resampler": type(_jax_resampler(name, jcfg))}, name
        assert _fields(kids["resampler"]) == _fields(_jax_resampler(name, jcfg)), name
        args = inputs + ([seg["ms_feats"], seg["ms_pos"]] if name == "raw" else [])
        zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), args)
        resampler_shapes = jax.eval_shape(lambda: _jax_resampler(name, jcfg).init(
            jax.random.PRNGKey(0), *zeros))["params"]
        if name == RESAMPLERS[0]:
            assert jax.tree.map(lambda a: (a.shape, a.dtype), resampler_shapes) == \
                jax.tree.map(lambda a: (a.shape, a.dtype), variables["params"]["resampler"])
        shapes = dict(variables["params"], resampler=resampler_shapes)
        rng = np.random.RandomState(0)
        tree = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
        model = load_flax_params(train.build_model(cfg, device="cpu"), tree)
        jlabels = {"/".join(k.key for k in path): label for path, label in
                   jax.tree_util.tree_flatten_with_path(
                       jax_label_params(tree, ("segmenter", "clip_adapter")))[0]}
        plabels = label_params(model.named_parameters(), ("segmenter", "clip_adapter"))
        got = {"/".join(flax_path(n, p.dim())): plabels[n] for n, p in model.named_parameters()}
        assert got == jlabels, name
        res = {k: v for k, v in got.items() if k.startswith("resampler/")}
        assert res["resampler/short0_conv1/kernel"] == "main"
        assert res["resampler/short0_conv1/bias"] == "nodecay"
        assert not any(v == "frozen" for v in res.values())
        assert all(v == "frozen" for k, v in got.items()
                   if k.startswith(("segmenter/", "clip_adapter/")))
        if name == "decoupled":
            q = init_params(train.build_model(cfg, device="cpu"), seed=1).resampler.query_emb
            assert abs(q.std().item() - 1.0) < 0.2 and res["resampler/query_emb"] == "main"


def test_set_criterion_fixed_assignment_and_tracking_match_match_jax():
    rng = np.random.RandomState(7)
    logits, masks, labels, tmasks, valid, fv = _criterion_inputs(rng)
    _, _, _, draw = _batch(np.random.RandomState(8))
    jt = JaxTargets(labels=jnp.asarray(labels, jnp.int32), masks=jnp.asarray(tmasks),
                    valid=jnp.asarray(valid), frame_valid=jnp.asarray(fv))
    pt = ClipTargets(torch.from_numpy(labels), torch.from_numpy(tmasks),
                     torch.from_numpy(valid), torch.from_numpy(fv))
    fixed = np.array([[3, 0, 5], [1, 4, 2]])
    lg_all = np.stack([logits.mean(1), logits[:, 0]])             # (2, B, Q, K+1)
    mk_all = np.stack([masks, masks[:, ::-1]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcrit, "sorted_uniform_points",
                   lambda key, batch, p: jnp.asarray(draw(batch[0], p)))

        @jax.jit
        def ref(lg, mk, lg_t, mk_t):
            losses, _ = jcrit.set_criterion(jax.random.PRNGKey(0), lg, mk, jt, _settings(jcrit),
                                            fixed_assignment=jnp.asarray(fixed, jnp.int32))
            return losses, jcrit.tracking_match(jax.random.PRNGKey(1), lg_t, mk_t, jt,
                                                _settings(jcrit))

        jlosses, jtrack = ref(jnp.asarray(lg_all), jnp.asarray(mk_all), jnp.asarray(logits),
                              jnp.asarray(masks))
    pdraw = lambda g, b, p: torch.from_numpy(draw(b[0], p))  # noqa: E731
    solved = []
    orig = criterion.batched_hungarian

    def counting(cost):
        solved.append(cost.shape)
        return orig(cost)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(criterion, "batched_hungarian", counting)
        losses, last = criterion.set_criterion(
            torch.Generator(), torch.from_numpy(lg_all), torch.from_numpy(mk_all.copy()), pt,
            _settings(criterion), pdraw, fixed_assignment=torch.from_numpy(fixed))
        assert not solved  # no matching with an assignment given
        track = criterion.tracking_match(torch.Generator(), torch.from_numpy(logits),
                                         torch.from_numpy(masks), pt, _settings(criterion),
                                         pdraw)
    assert solved == [(B + 1, N, 6)] * T  # one Hungarian call a frame
    assert torch.equal(last, torch.from_numpy(fixed))
    for k in ("loss_ce", "loss_mask", "loss_dice", "total"):
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_array_equal(track.numpy()[valid], np.asarray(jtrack)[valid])
    # distinct queries per clip, each slot on a query free in its first frame
    for row, v in zip(track.numpy(), valid):
        assert len(set(row[v].tolist())) == v.sum()
