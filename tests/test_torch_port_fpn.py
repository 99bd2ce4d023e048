"""PyTorch port, the FPN pixel decoders, the DETR transformer and the
zero-shot heads against the JAX package on the CPU in f32:

  * ``BasePixelDecoder`` (``fpn``, and ``transformer_enc`` with its DETR
    encoder over res5): outputs and every gradient (parameters and input
    maps) from one numpy seed, the weights carried by ``convert``; the
    ``extra_features`` argument is read by neither package;
  * ``DETRTransformer``, pre- and post-norm, ``relu`` and ``gelu`` (flax's
    tanh approximation);
  * the ``frame_zero_shot`` and ``video_zero_shot`` decoders through the
    ``Segmenter`` (over the ``fpn`` and the ``transformer_enc`` pixel
    decoders): the packed ``[embedding | objectness]`` logits and the masks;
  * JAX's trees of both pixel decoders load into the port strictly and
    back, and every parameter's group equals JAX's ``config_labels``.

Shapes: the tiny segmenter of ``tests/test_torch_parity_e2e.py`` (64x96
frames, hidden 64, Q=8, 2 encoder and 2 decoder layers).  One set of
weights, the port's seeded init with random norm affines, goes into both
packages; each JAX reference is one ``jax.jit``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openvis_tpu.config import Config as JaxConfig
from openvis_tpu.models import pixel_decoder as jax_pd
from openvis_tpu.models.segmenter import Segmenter as JaxSegmenter
from openvis_tpu.parallel.train_step import config_labels as jax_config_labels
from openvis_tpu_torch import Config
from openvis_tpu_torch.convert import flax_from_state_dict, flax_path, init_params, load_flax_params
from openvis_tpu_torch.models import pixel_decoder
from openvis_tpu_torch.models.segmenter import Segmenter
from openvis_tpu_torch.parallel.train_step import config_labels
from torch_port_common import flat, one_thread_fixture, rel

K, D, B, T, H, W, HID, Q = 5, 32, 1, 3, 64, 96, 64, 8
# f32 on both sides, the same arithmetic in another order (XLA against ATen)
FORWARD_REL_TO_MAX = 1e-4   # the whole segmenter, ~60 layers deep
MODULE_REL_TO_MAX = 1e-5    # one pixel decoder or DETR transformer
GRAD_REL_TO_MAX = 1e-4      # its gradients, of each tensor's largest element

one_thread = one_thread_fixture()


def fpn_cfg(cls, pixel: str, decoder: str = "frame_embedding"):
    cfg = cls()
    m = dataclasses.replace(
        cfg.model, num_classes=K,
        pixel_decoder=dataclasses.replace(
            cfg.model.pixel_decoder, name=pixel, conv_dim=HID, mask_dim=HID,
            transformer_enc_layers=2, dim_feedforward=128, num_heads=4),
        transformer_decoder=dataclasses.replace(
            cfg.model.transformer_decoder, name=decoder, hidden_dim=HID, num_queries=Q,
            nheads=4, dim_feedforward=128, dec_layers=2, mask_dim=HID, clip_embed_dim=D))
    return dataclasses.replace(cfg, model=m, solver=dataclasses.replace(cfg.solver, amp=False))


def _randomize_norms(module, rng):
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name:
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1 + 1.0))
    return module


def test_pixel_decoder_trees_and_groups_match_jax():
    """For ``fpn`` (under ``frame_zero_shot``) and ``transformer_enc`` (under
    ``video_zero_shot``): JAX's tree (shapes by ``eval_shape``) loads into
    the port strictly and back unchanged; ``transformer_enc`` has
    ``input_proj``, ``enc_attn{i}``, ``enc_ffn{i}`` and no ``adapter0``;
    every group equals JAX's ``config_labels``."""
    for pixel, decoder in (("fpn", "frame_zero_shot"), ("transformer_enc", "video_zero_shot")):
        jm = JaxSegmenter(fpn_cfg(JaxConfig, pixel, decoder).model)
        shapes = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((T, H, W, 3)), T))["params"]
        rng = np.random.RandomState(1)
        tree = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
        cfg = fpn_cfg(Config, pixel, decoder)
        model = load_flax_params(Segmenter(cfg.model), tree)
        pd_tree = tree["pixel_decoder"]
        names = set(pd_tree)
        if pixel == "fpn":
            assert {f"adapter{i}_conv" for i in range(4)} <= names and "input_proj" not in names
        else:
            assert {"input_proj", "enc_attn0", "enc_ffn1", "adapter1_conv"} <= names
            assert "adapter0_conv" not in names
        assert {"layer3_conv", "layer3_norm", "mask_features"} <= names
        back = dict(flat(flax_from_state_dict(model.state_dict())))
        assert back.keys() == dict(flat(tree)).keys()
        assert all(np.array_equal(back[k], v) for k, v in flat(tree))
        groups = config_labels(cfg, model)
        got = {"/".join(flax_path(n, p.dim())): groups[n] for n, p in model.named_parameters()}
        want = jax_config_labels(fpn_cfg(JaxConfig, pixel, decoder), tree)
        want = {"/".join(k.key for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert got == want
        assert got["predictor/heads/object_embed/layer1/kernel"] == "main"
        assert got["predictor/heads/object_embed/layer0/bias"] == "nodecay"
        pre = "pixel_decoder/"
        assert got[pre + "layer0_conv/kernel"] == "main"
        assert got[pre + "layer0_norm/scale"] == got[pre + "layer0_norm/bias"] == "nodecay"
        assert got[pre + "mask_features/kernel"] == "main"
        assert got[pre + "mask_features/bias"] == "nodecay"
        if pixel == "transformer_enc":
            assert got[pre + "input_proj/kernel"] == "main"
            assert got[pre + "input_proj/bias"] == "nodecay"
            assert got[pre + "enc_attn0/self_attn/q_proj/kernel"] == "main"
            assert got[pre + "enc_ffn1/norm/scale"] == "nodecay"


def test_base_pixel_decoders_and_gradients_match_jax():
    """Both variants' outputs and every gradient of a random projection of
    them, with respect to the parameters and the four input maps; then the
    same call with ``extra_features`` gives the same outputs in both
    packages (neither reads it)."""
    rng = np.random.RandomState(0)
    channels = {"res2": 16, "res3": 24, "res4": 32, "res5": 40}
    sizes = {"res2": (16, 24), "res3": (8, 12), "res4": (4, 6), "res5": (2, 3)}
    feats = {k: rng.randn(2, c, *sizes[k]).astype(np.float32) for k, c in channels.items()}
    extra = [rng.randn(2, HID, *sizes[k]).astype(np.float32) for k in ("res5", "res4", "res3")]
    for layers in (0, 2):
        port = pixel_decoder.BasePixelDecoder(channels, conv_dim=HID, mask_dim=48,
                                              transformer_enc_layers=layers, nheads=4,
                                              dim_feedforward=128)
        port = _randomize_norms(init_params(port, seed=layers), rng)
        tree = jax.tree.map(jnp.asarray, flax_from_state_dict(port.state_dict()))
        jm = jax_pd.BasePixelDecoder(conv_dim=HID, mask_dim=48, transformer_enc_layers=layers,
                                     nheads=4, dim_feedforward=128)
        out_w = [rng.randn(2, 48, 16, 24), rng.randn(2, HID, 2, 3), rng.randn(2, HID, 2, 3),
                 rng.randn(2, HID, 4, 6), rng.randn(2, HID, 8, 12)]
        out_w = [w.astype(np.float32) for w in out_w]

        def jax_loss(p, f, ex):
            mf, top, ms = jm.apply({"params": p}, f, ex)
            outs = [mf, top, *ms]
            return sum(jnp.sum(o * jnp.asarray(w.transpose(0, 2, 3, 1)))
                       for o, w in zip(outs, out_w)), outs

        jfeats = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in feats.items()}
        jex = [jnp.asarray(e.transpose(0, 2, 3, 1)) for e in extra]
        # one program, called with the extra maps and with zeros in their place
        jfn = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))
        (_, jouts), (jg, jgf) = jfn(tree, jfeats, jex)
        (_, zouts), zgrads = jfn(tree, jfeats, [jnp.zeros_like(e) for e in jex])
        for j, z in zip(jax.tree.leaves((jouts, jg, jgf)), jax.tree.leaves((zouts, zgrads))):
            np.testing.assert_array_equal(np.asarray(j), np.asarray(z))
        tfeats = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
        prev = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False  # see tests/test_torch_port_train_step.py
        try:
            mf, top, ms = port(tfeats)
            outs = [mf, top, *ms]
            loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, out_w))
            named = dict(port.named_parameters())
            grads = torch.autograd.grad(loss, [*named.values(), *tfeats.values()])
            with torch.no_grad():
                got_ex = port(tfeats, [torch.from_numpy(e) for e in extra])
        finally:
            torch.backends.mkldnn.enabled = prev
        for o, j in zip(outs, jouts):
            assert rel(o.detach().permute(0, 2, 3, 1), j) <= MODULE_REL_TO_MAX
        pg = dict(flat(flax_from_state_dict(dict(zip(named, grads)))))
        for k, g in flat(jax.tree.map(np.asarray, jg)):
            if k.endswith("k_proj/bias"):  # exactly 0: softmax is shift-invariant
                assert np.abs(pg[k]).max() < 1e-5 and np.abs(g).max() < 1e-5, k
            else:
                assert rel(pg[k], g) <= GRAD_REL_TO_MAX, (layers, k)
        for name, g in zip(tfeats, grads[len(named):]):
            assert rel(g.permute(0, 2, 3, 1), jgf[name]) <= GRAD_REL_TO_MAX, (layers, name)
        for o, e in zip(outs, [got_ex[0], got_ex[1], *got_ex[2]]):
            assert torch.equal(o.detach(), e)


def test_detr_transformer_matches_jax():
    """Pre- and post-norm with ``relu`` and ``gelu``: the decoder's stack of
    normed layer outputs and the encoder's memory."""
    rng = np.random.RandomState(2)
    d, heads, h, w, nq = 32, 4, 3, 4, 5
    src = rng.randn(2, d, h, w).astype(np.float32)
    pos = rng.randn(1, d, h, w).astype(np.float32)
    query = rng.randn(nq, d).astype(np.float32)
    for pre_norm in (False, True):
        for act in ("relu", "gelu"):
            port = pixel_decoder.DETRTransformer(d, heads, 2, 3, 64, pre_norm, act)
            port = _randomize_norms(init_params(port, seed=3), rng)
            assert hasattr(port, "encoder_norm") == pre_norm
            tree = jax.tree.map(jnp.asarray, flax_from_state_dict(port.state_dict()))
            jm = jax_pd.DETRTransformer(d, heads, 2, 3, 64, pre_norm, act)
            jhs, jmem = jax.jit(lambda p, s, qe, pe: jm.apply({"params": p}, s, qe, pe))(
                tree, jnp.asarray(src.transpose(0, 2, 3, 1)), jnp.asarray(query),
                jnp.asarray(pos.transpose(0, 2, 3, 1)))
            with torch.no_grad():
                hs, mem = port(torch.from_numpy(src), torch.from_numpy(query),
                               torch.from_numpy(pos))
            assert hs.shape == (3, 2, nq, d) and mem.shape == src.shape
            assert rel(hs, jhs) <= MODULE_REL_TO_MAX, (pre_norm, act)
            assert rel(mem.permute(0, 2, 3, 1), jmem) <= MODULE_REL_TO_MAX, (pre_norm, act)


def test_zero_shot_segmenters_match_jax():
    """``frame_zero_shot`` over ``fpn`` and ``video_zero_shot`` over
    ``transformer_enc``: logits of width hidden + 2, the normed decoder
    output packed with the 2 objectness logits of the ``object_embed`` MLP,
    and the masks at stride 4."""
    rng = np.random.RandomState(4)
    frames = rng.randn(B * T, H, W, 3).astype(np.float32)
    for pixel, decoder in (("fpn", "frame_zero_shot"), ("transformer_enc", "video_zero_shot")):
        model = Segmenter(fpn_cfg(Config, pixel, decoder).model)
        model = _randomize_norms(init_params(model, seed=5), rng)
        heads = model.predictor.heads
        assert heads.object_embed.layer1.out_features == 2
        tree = jax.tree.map(jnp.asarray, flax_from_state_dict(model.state_dict()))
        jm = JaxSegmenter(fpn_cfg(JaxConfig, pixel, decoder).model)
        ref = jax.jit(lambda p, x: {k: v for k, v in jm.apply({"params": p}, x, T).items()
                                    if k in ("pred_logits_all", "pred_masks_all")})(
            tree, jnp.asarray(frames))
        with torch.no_grad():
            got = model(torch.from_numpy(frames), T)
        lead = (3, B, T, Q) if decoder == "frame_zero_shot" else (3, B, Q)
        assert tuple(got["pred_logits_all"].shape) == (*lead, HID + 2)
        assert tuple(got["pred_masks_all"].shape) == (3, B, Q, T, H // 4, W // 4)
        for k in ref:
            assert rel(got[k], ref[k]) <= FORWARD_REL_TO_MAX, (decoder, k)
        # the embedding half is the decoder's normed output (the frame
        # decoder's tracking embeddings), the rest its objectness
        x = got["pred_logits"][..., :HID]
        if decoder == "frame_zero_shot":
            assert torch.equal(x, got["pred_embeds"])
        with torch.no_grad():
            assert torch.equal(got["pred_logits"][..., HID:], heads.object_embed(x))
