"""Bloom (ALiBi, the embedding norm), ChatGLM-6B (GLM positions, the
deepnorm residual, the bidirectional prompt), query-key layer scaling and
gpt_bigcode without multi-query in the port, against the JAX package (and
HF where it has the family) on the CPU at tiny sizes, fp32.

* ``generate_alibi_slopes`` / ``generate_alibi_biases`` bit-equal to the
  JAX ``functional.py`` at 12, 16 and 20 heads (20 and 12: the branch for
  head counts that are not a power of two);
* the Bloom mapper bit-equal to the JAX one on a tiny seeded HF
  ``BloomForCausalLM``, the ChatGLM mapper on a seeded state in THUDM's
  layout; Bloom's prefill logits against HF (2e-3) and JAX (1e-5) and
  three steps against JAX (logits and cache, 1e-5); ChatGLM's prefill with
  a left-padded ragged batch and three steps against JAX (1e-5);
* greedy ``GenerationSession`` at batch 2 (ragged left-padded prompts)
  token-exact with the JAX session for Bloom (layer by layer on both
  sides) and ChatGLM (the JAX kernel 1 in interpret mode,
  ``EWT_PALLAS_DECODE=1``); cum log-probs within 1e-4;
* Bloom beams: the JAX session's beams through its table (its default)
  differ from its gather mode, since its ALiBi step drops the table (the
  fault recorded in ROADMAP.md); the port's table mode equals the JAX
  gather mode (tokens exact, scores 1e-4), and so does the port's gather
  mode;
* query-key layer scaling on a GPT-2-class model: logits against JAX
  (1e-5), and not the unscaled model's;
* gpt_bigcode without multi-query (q, k and v packed per head) against
  HF's logits (2e-3) and greedy tokens;
* ``build_from_hf`` builds Bloom and ChatGLM-6B;
* CPU rehearsals of ``chip_smoke.py``'s bloom and chatglm paths.
"""
import importlib.util
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch import functional as pf
from eddie_wang_hackathon2023_tpu_torch.models import families
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
    from_jax_state
from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig)
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

V = 97


def _mc(c):
    return dict(vocab_size=c.vocab_size, num_layers=c.num_layers,
                num_heads=c.num_heads, hidden_size=c.hidden_size,
                max_seq_len=c.max_position_embeddings,
                num_kv_heads=c.num_kv_heads)


def _jax_session(jm, c, sc, monkeypatch, **kw):
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    return JSession(JMC(**_mc(c)), jm, sc, **kw)


# -- ALiBi ---------------------------------------------------------------------

@pytest.mark.parametrize("heads", [12, 16, 20])
def test_alibi_slopes_and_biases_bit_equal_to_jax(heads):
    from eddie_wang_hackathon2023_tpu.functional import (
        generate_alibi_biases as j_biases, generate_alibi_slopes as j_slopes)
    want = j_slopes(heads)
    got = pf.generate_alibi_slopes(heads)
    assert got.shape == (1, heads, 1, 1) and got.dtype == np.float32
    assert np.array_equal(got, want)
    bias = pf.generate_alibi_biases(pf.alibi_slopes(heads,
                                                    torch.device("cpu")), 37)
    assert bias.shape == (1, heads, 1, 37) and bias.dtype == torch.float32
    assert np.array_equal(bias.numpy(), np.asarray(j_biases(want, 37)))


# -- Bloom ---------------------------------------------------------------------

_BUILT = {}


def _bloom():
    """(HF model, JAX model, port model, port config): a tiny seeded HF
    Bloom (width 64, 2 layers, 4 heads of 16, vocab 97), fp32, built once
    a module."""
    if "bloom" not in _BUILT:
        import transformers as T

        from eddie_wang_hackathon2023_tpu.models.families import \
            build_from_hf as j_build
        torch.manual_seed(0)
        hf = T.BloomForCausalLM(T.BloomConfig(
            vocab_size=V, hidden_size=64, n_layer=2, n_head=4)).eval()
        # HF initialises the norms to ones and the biases to zeros: give
        # them values, so that the mapper's every key is seen
        with torch.no_grad():
            for name, p in hf.named_parameters():
                if "layernorm" in name or name.endswith("bias"):
                    p.add_(0.1 * torch.randn_like(p))
        jm, jc = j_build("bloom", hf, dtype="float32")
        pm, pc = families.build_from_hf("bloom", hf, dtype="float32",
                                        device="cpu")
        _BUILT["bloom"] = (hf, jm, pm, pc)
    return _BUILT["bloom"]


def test_bloom_mapper_bit_equal_to_jax():
    from eddie_wang_hackathon2023_tpu.models.families import \
        FAMILIES as J_FAMILIES
    hf, _, _, pc = _bloom()
    jc = J_FAMILIES["bloom"][0](hf.config, dtype="float32")
    sd = hf.state_dict()
    want = J_FAMILIES["bloom"][1](sd, jc)
    got = families.FAMILIES["bloom"][1](sd, pc)
    assert sorted(got) == sorted(want) and "ln_embed.weight" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "position_embedding", "embedding_norm", "norm_eps",
              "hidden_act", "tie_word_embeddings"):
        assert getattr(pc, f) == getattr(jc, f), f


@torch.inference_mode()
def test_bloom_logits_match_jax_and_hf():
    """A 6-token prefill against HF and JAX, then three single-token steps
    (logits and the cache) against JAX."""
    hf, jm, pm, _ = _bloom()
    tokens = np.array([[3, 11, 25, 40, 7, 60]], dtype=np.int32)
    ref = hf(torch.from_numpy(tokens).long()).logits.numpy()
    jl, jcache = jm(jnp.asarray(tokens), jm.new_kv_cache(1, 16), 0,
                    jnp.array([6]))
    cache = pm.new_kv_cache(1, 16)
    lg, cache = pm(torch.from_numpy(tokens).long(), cache, 0,
                   torch.tensor([6], dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(lg.numpy(), ref, atol=2e-3)
    for i, tok in enumerate((9, 2, 40)):
        jl, jcache = jm(jnp.asarray([[tok]], jnp.int32), jcache, 6 + i,
                        jnp.array([7 + i]))
        lg, cache = pm(torch.tensor([[tok]]), cache, 6 + i, 7 + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=1e-5)


IDS = np.random.RandomState(4).randint(0, 96, (2, 6)).astype(np.int32)
LENS = np.asarray([6, 3], np.int32)


def test_bloom_greedy_token_exact_with_jax(monkeypatch):
    """Two ragged prompts (6 and 3 tokens, left-padded, bucketed to 8), 12
    new tokens: the ALiBi bias over the absolute cache column on both
    sides, each layer's column written before its attention."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    _, jm, pm, c = _bloom()
    pt, pl, pc = GenerationSession(
        ModelConfig(**_mc(c)), pm,
        SamplingConfig(end_id=-1, pad_id=96)).decode(IDS, LENS,
                                                     max_new_tokens=12)
    jt, jl, jc = _jax_session(jm, c, JSampling(end_id=-1, pad_id=96),
                              monkeypatch).decode(IDS, LENS,
                                                  max_new_tokens=12)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


def test_bloom_beams_read_through_the_table(monkeypatch):
    """Beam 3 over the two prompts, 8 new tokens.  The JAX session's table
    mode (its default) differs from its gather mode: its ALiBi step drops
    the table, so a beam reads its own row's history, not its parent's.
    The port reads through the table: its table mode equals the JAX gather
    mode (tokens exact, scores within 1e-4), as its gather mode does."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    _, jm, pm, c = _bloom()
    sc = dict(end_id=-1, pad_id=96, num_beams=3)
    j_table = _jax_session(jm, c, JSampling(**sc), monkeypatch).decode(
        IDS, LENS, max_new_tokens=8)
    j_gather = _jax_session(jm, c, JSampling(**sc), monkeypatch,
                            use_cache_indirection=False).decode(
        IDS, LENS, max_new_tokens=8)
    # the fault: the table mode's scores are not the gather mode's
    assert np.abs(j_table[2] - j_gather[2]).max() > 1e-3
    for ind in (True, False):
        pt, pl, pc = GenerationSession(
            ModelConfig(**_mc(c)), pm, SamplingConfig(**sc),
            use_cache_indirection=ind).decode(IDS, LENS, max_new_tokens=8)
        assert pt.shape == (2, 3, 14)
        np.testing.assert_array_equal(pt, j_gather[0])
        np.testing.assert_array_equal(pl, j_gather[1])
        np.testing.assert_allclose(pc, j_gather[2], rtol=1e-4, atol=1e-4)


# -- ChatGLM-6B ----------------------------------------------------------------

GLM_HID, GLM_LAYERS, GLM_HEADS = 128, 2, 2        # heads of 64: halves of 32


def _glm_sd(rng):
    """Seeded weights in THUDM/chatglm-6b's state-dict layout (as
    tests/test_chatglm.py writes them), at GLM_HID."""
    hid, ffn = GLM_HID, 4 * GLM_HID

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    sd = {"transformer.word_embeddings.weight": n(V, hid),
          "transformer.final_layernorm.weight": 1 + n(hid, s=0.1),
          "transformer.final_layernorm.bias": n(hid, s=0.1),
          "lm_head.weight": n(V, hid, s=hid ** -0.5)}
    for i in range(GLM_LAYERS):
        p = f"transformer.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + n(hid, s=0.1),
            p + "input_layernorm.bias": n(hid, s=0.1),
            p + "attention.query_key_value.weight": n(3 * hid, hid,
                                                      s=hid ** -0.5),
            p + "attention.query_key_value.bias": n(3 * hid, s=0.1),
            p + "attention.dense.weight": n(hid, hid, s=hid ** -0.5),
            p + "attention.dense.bias": n(hid, s=0.1),
            p + "post_attention_layernorm.weight": 1 + n(hid, s=0.1),
            p + "post_attention_layernorm.bias": n(hid, s=0.1),
            p + "mlp.dense_h_to_4h.weight": n(ffn, hid, s=hid ** -0.5),
            p + "mlp.dense_h_to_4h.bias": n(ffn, s=0.1),
            p + "mlp.dense_4h_to_h.weight": n(hid, ffn, s=ffn ** -0.5),
            p + "mlp.dense_4h_to_h.bias": n(hid, s=0.1),
        })
    return sd


def _glm_hf_cfg():
    return types.SimpleNamespace(vocab_size=V, hidden_size=GLM_HID,
                                 num_layers=GLM_LAYERS,
                                 num_attention_heads=GLM_HEADS,
                                 inner_hidden_size=4 * GLM_HID,
                                 max_sequence_length=64,
                                 layernorm_epsilon=1e-5)


def _glm():
    """(THUDM state, JAX model, port model, port config), fp32, built once
    a module."""
    if "glm" not in _BUILT:
        from eddie_wang_hackathon2023_tpu.models.decoder import \
            DecoderLMHead as JModel
        from eddie_wang_hackathon2023_tpu.models.families import (
            chatglm6b_config as j_config, from_hf_chatglm6b as j_map)
        sd = _glm_sd(np.random.default_rng(7))
        jc = j_config(_glm_hf_cfg(), dtype="float32")
        jm = JModel(jc)
        jm.load_state_dict(j_map(sd, jc), strict=False)
        pc = families.chatglm6b_config(_glm_hf_cfg(), dtype="float32")
        pm = from_jax_state(families.from_hf_chatglm6b(sd, pc), pc,
                            device="cpu")
        _BUILT["glm"] = (sd, jm, pm, pc)
    return _BUILT["glm"]


def test_chatglm_mapper_bit_equal_to_jax():
    from eddie_wang_hackathon2023_tpu.models.families import (
        chatglm6b_config as j_config, from_hf_chatglm6b as j_map)
    sd, _, _, pc = _glm()
    jc = j_config(_glm_hf_cfg(), dtype="float32")
    want = j_map(sd, jc)
    got = families.from_hf_chatglm6b(sd, pc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    for f in ("num_layers", "num_heads", "ffn_hidden_size",
              "position_embedding", "deepnorm_alpha",
              "bidirectional_context", "hidden_act", "tie_word_embeddings",
              "norm_eps", "max_position_embeddings"):
        assert getattr(pc, f) == getattr(jc, f), f


@torch.inference_mode()
def test_chatglm_logits_match_jax():
    """Two left-padded prompts of 6 and 4 true tokens in 8 columns (start
    2 and 4): the bidirectional prefill, then three single-token steps,
    each with the true prompt lengths for the GLM positions; logits and
    the cache against JAX (1e-5)."""
    _, jm, pm, _ = _glm()
    tokens = np.array([[0, 0, 5, 9, 2, 33, 60, 17],
                       [0, 0, 0, 0, 7, 21, 60, 17]], dtype=np.int32)
    plen = np.array([6, 4], np.int32)
    start = 8 - plen
    jl, jcache = jm(jnp.asarray(tokens), jm.new_kv_cache(2, 16), 0,
                    jnp.full((2,), 8, jnp.int32),
                    attention_start=jnp.asarray(start),
                    context_lengths=jnp.asarray(plen))
    cache = pm.new_kv_cache(2, 16)
    lg, cache = pm(torch.from_numpy(tokens).long(), cache, 0,
                   torch.full((2,), 8, dtype=torch.int32),
                   attention_start=torch.from_numpy(start),
                   context_lengths=torch.from_numpy(plen))
    # the pad rows' logits are garbage on both sides: the live ones
    for b in range(2):
        np.testing.assert_allclose(lg.numpy()[b, start[b]:],
                                   np.asarray(jl)[b, start[b]:], atol=1e-5)
    for i, tok in enumerate((9, 2, 40)):
        jl, jcache = jm(jnp.asarray([[tok], [tok]], jnp.int32), jcache,
                        8 + i, jnp.full((2,), 9 + i, jnp.int32),
                        attention_start=jnp.asarray(start),
                        context_lengths=jnp.asarray(plen))
        lg, cache = pm(torch.tensor([[tok], [tok]]), cache, 8 + i, 9 + i,
                       attention_start=torch.from_numpy(start),
                       context_lengths=torch.from_numpy(plen))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    for b in range(2):
        np.testing.assert_allclose(
            cache.numpy()[:, b, ..., start[b]:11],
            np.asarray(jcache)[:, b, ..., start[b]:11], atol=1e-5)


def test_chatglm_greedy_token_exact_with_jax(monkeypatch):
    """Two prompts of 6 and 3 true tokens (left-padded, bucketed to 8), 10
    new tokens: the port's session (kernel 1's plain version) and the JAX
    session through its kernel 1 in interpret mode, token for token."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    monkeypatch.setenv("EWT_PALLAS_DECODE", "1")
    jax.clear_caches()
    _, jm, pm, c = _glm()
    assert pm.needs_context_lengths
    try:
        jt, jl, jc = _jax_session(jm, c, JSampling(end_id=-1, pad_id=0),
                                  monkeypatch).decode(IDS, LENS,
                                                      max_new_tokens=10)
    finally:
        monkeypatch.delenv("EWT_PALLAS_DECODE")
        jax.clear_caches()
    pt, pl, pc = GenerationSession(
        ModelConfig(**_mc(c)), pm,
        SamplingConfig(end_id=-1, pad_id=0)).decode(IDS, LENS,
                                                    max_new_tokens=10)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-4)


def test_glm_positions_follow_the_true_prompt():
    """pos0 = min(p, plen - 2), pos1 = max(p - plen + 2, 0): the prompt
    counts up to [gMASK] at plen - 2, [sop] repeats it with block position
    1, generated token s keeps plen - 2 with block position s + 2."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        glm_positions
    p0, p1 = glm_positions(torch.arange(9)[None], torch.tensor([6]))
    assert p0.tolist() == [[0, 1, 2, 3, 4, 4, 4, 4, 4]]
    assert p1.tolist() == [[0, 0, 0, 0, 0, 1, 2, 3, 4]]


# -- query-key layer scaling, gpt_bigcode without multi-query -------------------

@torch.inference_mode()
def test_query_key_layer_scaling_matches_jax():
    """A tiny GPT-2 with ``apply_query_key_layer_scaling``: the scale is
    1 / (sqrt(head_dim) * num_layers) on both sides (not re-multiplied in
    the softmax); a prefill and two steps against JAX (1e-5), and the
    logits are not the unscaled model's."""
    import transformers as T

    from eddie_wang_hackathon2023_tpu.models.families import \
        build_from_hf as j_build
    torch.manual_seed(1)
    hf = T.GPT2LMHeadModel(T.GPT2Config(vocab_size=V, n_positions=64,
                                        n_embd=64, n_layer=3,
                                        n_head=4)).eval()
    jm, _ = j_build("gpt2", hf, dtype="float32",
                    apply_query_key_layer_scaling=True)
    pm, pc = families.build_from_hf("gpt2", hf, dtype="float32",
                                    device="cpu",
                                    apply_query_key_layer_scaling=True)
    plain, _ = families.build_from_hf("gpt2", hf, dtype="float32",
                                      device="cpu")
    assert pm.blocks[0].attention.scale == pytest.approx(
        1 / (math.sqrt(16) * 3))
    tokens = np.array([[3, 11, 25, 40, 7]], dtype=np.int32)
    jl, jcache = jm(jnp.asarray(tokens), jm.new_kv_cache(1, 16), 0,
                    jnp.array([5]))
    cache = pm.new_kv_cache(1, 16)
    lg, cache = pm(torch.from_numpy(tokens).long(), cache, 0,
                   torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    unscaled, _ = plain(torch.from_numpy(tokens).long(),
                        plain.new_kv_cache(1, 16), 0,
                        torch.tensor([5], dtype=torch.int32))
    assert np.abs(unscaled.numpy() - lg.numpy()).max() > 1e-3
    for i, tok in enumerate((9, 2)):
        jl, jcache = jm(jnp.asarray([[tok]], jnp.int32), jcache, 5 + i,
                        jnp.array([6 + i]))
        lg, cache = pm(torch.tensor([[tok]]), cache, 5 + i, 6 + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)


@torch.inference_mode()
def test_gpt_bigcode_without_multi_query_matches_hf():
    """HF ``GPTBigCodeAttention`` without multi-query packs q, k and v per
    head ([H, 3, D] rows): the port's mapper follows it (held against HF's
    logits, 2e-3, and its greedy tokens), where the JAX mapper's
    [q | k | v] split does not (ROADMAP.md)."""
    import transformers as T
    torch.manual_seed(2)
    hf = T.GPTBigCodeForCausalLM(T.GPTBigCodeConfig(
        vocab_size=V, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        multi_query=False)).eval()
    pm, pc = families.build_from_hf("gpt_bigcode", hf, dtype="float32",
                                    device="cpu")
    assert pc.num_kv_heads == pc.num_heads == 4
    tokens = torch.tensor([[3, 11, 25, 40, 7]])
    ref = hf(tokens).logits.numpy()
    lg, _ = pm(tokens, pm.new_kv_cache(1, 16), 0,
               torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), ref, atol=2e-3)
    want = hf.generate(tokens, max_new_tokens=6, do_sample=False,
                       pad_token_id=0)[0, 5:].numpy()
    got, _, _ = GenerationSession(
        ModelConfig(**_mc(pc)), pm, SamplingConfig(end_id=-1, pad_id=0),
        bucket_prompts=False).decode(tokens.numpy().astype(np.int32),
                                     np.asarray([5], np.int32),
                                     max_new_tokens=6)
    np.testing.assert_array_equal(got[0, 0, 5:], want)


def test_build_from_hf_builds_bloom_and_chatglm():
    """Bloom from its HF model, ChatGLM-6B from an object with its config
    and THUDM state dict (no HF class exists for it)."""
    _, _, pm, pc = _bloom()
    assert pc.position_embedding == "alibi" and hasattr(pm, "ln_embed")
    sd, _, _, _ = _glm()
    glm = types.SimpleNamespace(config=_glm_hf_cfg(), state_dict=lambda: sd)
    gm, gc = families.build_from_hf("chatglm6b", glm, device="cpu")
    assert gc.position_embedding == "glm_rope" and gc.bidirectional_context
    assert not gm.megakernel_eligible() and not pm.megakernel_eligible()


# -- chip_smoke.py's bloom and chatglm paths, rehearsed -------------------------

def _smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_bloom_and_chatglm_paths_on_cpu(one_cpu_thread):
    """``chip_smoke.bloom_path`` (2 layers of width 128, 4 heads of 32,
    vocab 97, bf16 as on the card) and ``chatglm_path`` (2 layers of width
    256, 2 heads of 128, its parameters made on the device in the JAX
    layout): batch 8, 20 tokens for prompts of 60 (ChatGLM's of 60 down to
    32 true tokens), no kernel launched from CPU tensors, the replays
    agree, Bloom's bf16 logits within 5e-2 of its fp32 weights'."""
    import dataclasses
    smoke = _smoke()
    bc = dataclasses.replace(smoke.bloom_560m_config(), vocab_size=V,
                             hidden_size=128, num_layers=2, num_heads=4,
                             num_kv_heads=4, ffn_hidden_size=512)
    e2e, counts = smoke.bloom_path(torch, np, config=bc, device="cpu")
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0 and e2e["tokens_per_s"] > 0
    assert e2e["fp32_check"]["rel_err"] < 5e-2
    gc = dataclasses.replace(smoke.chatglm_6b_config(), vocab_size=V,
                             hidden_size=256, num_layers=2, num_heads=2,
                             num_kv_heads=2, ffn_hidden_size=512)
    e2e, counts = smoke.chatglm_path(torch, np, config=gc, device="cpu")
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0 and e2e["tokens_per_s"] > 0
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    with torch.device("meta"):
        n = sum(p.numel() for p in DecoderLMHead(gc).parameters())
    assert e2e["parameters"] == n
