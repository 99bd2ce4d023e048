"""PyTorch port, the CLIP towers and the text bank against the JAX package on
the CPU in f32: the prompt tables, the BPE tokenizer (both of its patterns),
``resize_pos_embed``, the vision and text towers and the dual ``CLIP`` loaded
through ``convert.params_from_flax``, ``TextEmbeddingBank.encode``, the weight
reader (``weights.convert_clip`` against ``tools/convert_weights.convert_clip``,
a plain state dict and an OpenAI-style JIT archive).

The weights are random, in OpenAI's key layout, at the ``test-tiny`` shape
with the vocabulary of a tiny BPE merge file written here
(``models/clip/synthetic.py``); neither OpenAI's weights nor its vocabulary
are in the repository."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import tools.convert_weights as jax_convert
from openvis_tpu.models.clip import model as jax_model
from openvis_tpu.models.clip import prompts as jax_prompts
from openvis_tpu.models.clip import tokenizer as jax_tokenizer
from openvis_tpu.models.clip.text_bank import TextEmbeddingBank as JaxBank
from openvis_tpu_torch import weights
from openvis_tpu_torch.convert import init_params, params_from_flax
from openvis_tpu_torch.models.clip import model, prompts, synthetic, tokenizer
from openvis_tpu_torch.models.clip.build import build_clip_params, load_clip_state
from openvis_tpu_torch.models.clip.text_bank import TextEmbeddingBank

SHAPE = jax_model._MODEL_SHAPES["test-tiny"]
VOCAB = synthetic.bpe_vocab_size()
CONTEXT = 77  # the JAX bank tokenizes to 77 tokens whatever the tower
# f32, the same arithmetic in another order (XLA against ATen): the towers'
# outputs of magnitude ~2.5 agree to 1.4e-6 on the CPU, the bank's unit rows
# to 1e-7
ATOL = 1e-5
NAMES = ["person", "giant panda", "car", "dog", "parking meter", "zebra"]
TEXTS = NAMES + ["a photo of the person.", "There is a large dog in the scene.",
                 "it's 3 cars &amp; a dog's toy!", "  many   spaces\tand\nlines  "]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny towers' many small operations run no
    faster on more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    state = synthetic.openai_state_dict("test-tiny", seed=0, vocab_size=VOCAB,
                                        context_length=CONTEXT, dtype=torch.float32)
    path = str(root / "tiny.pt")
    torch.save(state, path)
    bpe = synthetic.write_bpe(str(root / "bpe.txt.gz"))
    tree = jax_convert.convert_clip({k: v.numpy() for k, v in state.items()})
    return root, state, path, bpe, tree


def _jax_vision():
    s = SHAPE
    return jax_model.CLIPVisionTransformer(
        patch_size=s["vision_patch"], width=s["vision_width"], layers=s["vision_layers"],
        heads=s["vision_heads"], embed_dim=s["embed_dim"], image_size=s["image_size"])


def _jax_text():
    s = SHAPE
    return jax_model.CLIPTextEncoder(vocab_size=VOCAB, context_length=CONTEXT,
                                     width=s["text_width"], heads=s["text_heads"],
                                     layers=s["text_layers"], embed_dim=s["embed_dim"])


def _port_text(tree):
    enc = model.text_tower("test-tiny", VOCAB, CONTEXT)
    enc.load_state_dict(params_from_flax(tree["text"]), strict=True)
    return enc


def test_prompt_tables_equal_the_jax_copy():
    assert prompts.TEMPLATE_SETS == jax_prompts.TEMPLATE_SETS
    for name in ("imagenet", "vild"):
        assert prompts.get_templates(name) == jax_prompts.get_templates(name)
    assert prompts.get_templates("predefined", ["{} here"]) == ["{} here"]
    assert prompts.get_templates("predefined") == jax_prompts.get_templates("predefined")
    with pytest.raises(ValueError):
        prompts.get_templates("nope")


@pytest.mark.parametrize("pattern", ["regex", "re"])
def test_tokenizer_matches_jax(files, monkeypatch, pattern):
    """Both tokenizers pick the ``regex`` pattern when the module imports and
    the ASCII ``re`` pattern when it does not (an installation without
    ``regex`` runs the latter)."""
    bpe = files[3]
    if pattern == "re":
        monkeypatch.setitem(sys.modules, "regex", None)  # import regex -> ImportError
    ours, ref = tokenizer.SimpleTokenizer(bpe), jax_tokenizer.SimpleTokenizer(bpe)
    assert ("\\p{L}" in ours.pat.pattern) == (pattern == "regex")
    assert ours.pat.pattern == ref.pat.pattern
    assert len(ours.encoder) == VOCAB and ours.encoder == ref.encoder
    texts = TEXTS + [t.format(n) for t in prompts.get_templates("vild") for n in NAMES[:2]]
    for text in texts:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids)
    merged = ours.encode("the person")
    assert merged == [ours.encoder["the</w>"], ours.encoder["person</w>"]]
    for ctx in (CONTEXT, 8):
        got = tokenizer.tokenize(ours, texts, ctx)
        np.testing.assert_array_equal(got, jax_tokenizer.tokenize(ref, texts, ctx))
        assert got.dtype == np.int32 and (got.max(axis=1) == ours.encoder["<|endoftext|>"]).all()


@pytest.mark.parametrize("grid", [(8, 8), (12, 16)], ids=["identity", "resize"])
def test_resize_pos_embed_matches_jax(grid):
    pos = np.random.RandomState(3).randn(1 + 8 * 8, 64).astype(np.float32)
    got = model.resize_pos_embed(torch.from_numpy(pos), grid).numpy()
    ref = np.asarray(jax_model.resize_pos_embed(jnp.asarray(pos), grid))
    assert got.shape == ref.shape == (1 + grid[0] * grid[1], 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    if grid == (8, 8):
        np.testing.assert_array_equal(got, pos)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)], ids=["native", "resized_grid"])
def test_vision_tower_matches_jax(files, hw):
    tree = files[4]
    vis = model.vision_tower("test-tiny")
    vis.load_state_dict(params_from_flax(tree["visual"]), strict=True)
    x = np.random.RandomState(1).randn(3, *hw, 3).astype(np.float32)
    ref = np.asarray(jax.jit(_jax_vision().apply)({"params": tree["visual"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = vis(torch.from_numpy(x)).numpy()
        # the block API: embed, blocks 0..2 then 2..4 with taps, finalize
        h, _ = vis.embed(torch.from_numpy(x))
        h, taps = vis.run_blocks(h, 0, 2, taps=(2,))
        h, _ = vis.run_blocks(h, 2, 4)
        split = vis.finalize(h[:, 0]).numpy()
    assert got.shape == (3, SHAPE["embed_dim"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(split, got)
    assert list(taps) == [2]


def test_text_tower_and_dual_clip_match_jax(files):
    tree = files[4]
    rng = np.random.RandomState(2)
    toks = rng.randint(1, VOCAB - 1, (4, CONTEXT)).astype(np.int32)
    for i, n in enumerate((5, 9, 1, 30)):  # EOT (the largest id) ends each prompt
        toks[i, n] = VOCAB - 1
        toks[i, n + 1:] = 0
    ref = np.asarray(jax.jit(_jax_text().apply)({"params": tree["text"]}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port_text(tree)(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)

    shape = dict(SHAPE, vocab_size=VOCAB, context_length=CONTEXT)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jax_model.CLIP(**shape).apply)({"params": tree},
                                                            jnp.asarray(images),
                                                            jnp.asarray(toks)))
    clip = model.CLIP(**shape)
    clip.load_state_dict(params_from_flax(tree), strict=True)
    with torch.no_grad():
        got = clip(torch.from_numpy(images), torch.from_numpy(toks).long()).numpy()
    # 100 x cosine: the towers' error scaled by the logit scale (observed 2.1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=100 * ATOL)


def test_text_bank_matches_jax(files):
    """Chunks of 3 prompts (unpadded) against JAX's one padded chunk of 256."""
    _, _, _, bpe, tree = files
    templates = prompts.get_templates("vild")
    ref = JaxBank(_jax_text(), tree["text"], jax_tokenizer.SimpleTokenizer(bpe),
                  templates).encode(NAMES)
    bank = TextEmbeddingBank(_port_text(tree), tokenizer.SimpleTokenizer(bpe), templates,
                             device="cpu", batch_size=3)
    got = bank.encode(NAMES)
    assert got.dtype == np.float32 and got.shape == (len(NAMES), SHAPE["embed_dim"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(bank.encode(NAMES[::-1]), got[::-1])  # from the cache


def _jit_archive(state, path):
    """A TorchScript archive holding ``state`` under its dotted names, as
    OpenAI's released ``ViT-B-16.pt`` does."""
    root = nn.Module()
    for key, t in state.items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, nn.Module())
            m = getattr(m, name)
        m.register_parameter(leaf, nn.Parameter(t.half(), requires_grad=False))
    torch.jit.script(root).save(path)


def test_weight_readers_match_the_tool(files):
    root, state, path, _, tree = files
    got = weights.convert_clip({k: v.numpy() for k, v in state.items()})
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    from_file = build_clip_params(path)
    for a, b in zip(jax.tree.leaves(from_file), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)

    jit_path = str(root / "jit.pt")
    _jit_archive(state, jit_path)
    read = load_clip_state(jit_path)
    assert set(read) == set(state)
    ref = jax_convert.load_torch_state(jit_path)  # the tool's reader of the same archive
    for k, v in state.items():
        np.testing.assert_array_equal(read[k], v.half().float().numpy())
        np.testing.assert_array_equal(read[k], ref[k])
    vis = model.vision_tower("test-tiny")
    vis.load_state_dict(params_from_flax(build_clip_params(jit_path)["visual"]), strict=True)


def test_unported_clip_inputs_raise_their_roadmap_item(files):
    root, state, _, _, _ = files
    with pytest.raises(ValueError, match="queue 1 item 8"):
        load_clip_state("ViT-B/16")
    with pytest.raises(ValueError, match="queue 1 item 8"):
        load_clip_state("https://example.invalid/ViT-B-16.pt")
    # the JAX package's converted .msgpack is read (tests/test_torch_port_msgpack.py):
    # an empty one stops at its reader
    msgpack = root / "clip.msgpack"
    msgpack.write_bytes(b"")
    with pytest.raises(ValueError, match="clip.msgpack: truncated"):
        build_clip_params(str(msgpack))
    # the ModifiedResNet towers (queue 1 item 8.6b) are ported: the reader reads
    # an RN file into the tower strictly, and RN50's tower has its published
    # widths (tests/test_torch_port_mask_adapted.py holds both to JAX)
    rn_state = synthetic.openai_state_dict("test-tiny-rn", seed=0, dtype=torch.float32)
    rn = weights.convert_clip({k: v.numpy() for k, v in rn_state.items()})
    model.vision_tower("test-tiny-rn").load_state_dict(params_from_flax(rn["visual"]),
                                                      strict=True)
    rn50 = model.vision_tower("RN50")
    assert len(rn50.blocks) == 16 and rn50.c_proj.weight.shape == (1024, 2048)
    assert model.text_tower("RN50", VOCAB, CONTEXT).text_projection.shape == (512, 1024)
    # SAN's biased attention is ported (queue 1 item 5; the parity with JAX is
    # tests/test_torch_port_san.py's): the same calls run and give the
    # dense-bias result.  A zero bias is no bias; the sos-split form is the
    # dense bias it stands for (-100 on the context rows' sos column).
    vis = init_params(model.vision_tower("test-tiny"), seed=0)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 64).astype(np.float32))
    sos_bias = torch.from_numpy(np.random.RandomState(5).randn(1, 4, 1, 2).astype(np.float32))
    dense = torch.zeros(1, 4, 3, 3)
    dense[:, :, 1:, 0] = -100.0
    dense[:, :, :1, 1:] = sos_bias
    with torch.no_grad():
        block = vis.blocks[0]
        np.testing.assert_array_equal(block(x, attn_bias=torch.zeros(1, 4, 3, 3)), block(x))
        split, _ = vis.run_blocks(x, 0, 1, attn_bias=[sos_bias], sos_q=1)
        ref, _ = vis.run_blocks(x, 0, 1, attn_bias=[dense])
    np.testing.assert_allclose(split, ref, rtol=0, atol=ATOL)
