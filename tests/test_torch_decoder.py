"""The port's decoder-only path (SantaCoder class: MQA/GQA attention,
learned positions, int8 weight-only) against the JAX package on the CPU.
Inputs come from numpy seeds and go to both sides.

* the plain grouped decode (``plain_gqa_decode_attention``, what the
  wrapper runs for CPU tensors) against the Pallas ``_gqa_kernel`` in
  interpret mode (``fused_decode_attention(..., chunk=8, interpret=True)``),
  rtol/atol 2e-5 as ``tests/test_pallas_decode.py`` holds it;
* the grouped prefill (causal offset and start index, Lq > 1) against the
  JAX ``cached_decode_attention``, fp32, 1e-5;
* the separate-KV int8 weight-only quantiser bit-equal to the JAX one;
* ``DecoderLMHead`` prefill and decode-step logits and caches against the
  JAX model, fp32, 1e-4;
* greedy generation token-exact with the JAX ``GenerationSession`` (its
  XLA path and its ``_gqa_kernel`` path in interpret mode), ragged
  left-padded prompts, float and ``woq8``, MQA and GQA, and with HF's
  ``GPTBigCodeForCausalLM.generate``;
* a CPU rehearsal of ``chip_smoke.py``'s decoder path at a tiny size;
* what the port does not run raises (beams over the MQA cache among them;
  the sampling options that raised before the sampling slice are held
  token-exact with the JAX session instead)."""
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.models.decoder import (DecoderConfig,
                                                               DecoderLMHead)
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
    from_jax_state, quantize_state)
from eddie_wang_hackathon2023_tpu_torch.ops import attention as pattn
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig,
                                                        bucket_length,
                                                        dynamic_decode)
from eddie_wang_hackathon2023_tpu_torch.runtime.sampling import \
    DecodeParams as PDecodeParams


def _j(x):
    return jnp.asarray(x)


def _jax_noise(seed):
    """The noise the JAX generation loop draws, one [rows, V] array a step
    (``rng, sub = split(rng)`` from ``PRNGKey(seed)``, then
    ``gumbel(sub, shape)``), to replace a port session's ``_gumbel``."""
    import jax
    state = dict(rng=jax.random.PRNGKey(seed))

    def gumbel(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))
    return gumbel


def _t(x):
    return torch.from_numpy(np.array(x))


# -- (a) the grouped decode: plain version vs the Pallas _gqa_kernel -------

@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_plain_grouped_decode_matches_gqa_kernel(cache, hkv):
    """4 query heads over 1 or 2 KV heads, fresh K/V, per-row lengths (one
    row with nothing cached) and starts, S = 37 over chunks of 8."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import \
        fused_decode_attention as j_fused
    rs = np.random.RandomState(10 * hkv + (cache == "int8"))
    L, B, H, D, S = 2, 3, 4, 16, 37
    q = rs.randn(B, H, 1, D).astype(np.float32)
    if cache == "int8":
        kv = rs.randint(-127, 128, (L, B, 2, hkv, D, S)).astype(np.int8)
        fresh = tuple(rs.randint(-127, 128, (B, hkv, D, 1)).astype(np.int8)
                      for _ in range(2))
        ks = np.asarray(0.02, np.float32)
    else:
        kv = rs.randn(L, B, 2, hkv, D, S).astype(np.float32)
        fresh = tuple(rs.randn(B, hkv, D, 1).astype(np.float32)
                      for _ in range(2))
        ks = None
    seq = np.asarray([1, 20, 37], np.int32)
    start = np.asarray([0, 3, 9], np.int32)
    ref = j_fused(_j(kv), 1, _j(q), _j(seq), D ** -0.5,
                  kv_quant_orig_scale=None if ks is None else _j(ks),
                  fresh_kv=tuple(map(_j, fresh)), start_index=_j(start),
                  chunk=8, interpret=True)
    out = pdec.fused_decode_attention(
        _t(kv), 1, _t(q), _t(seq), D ** -0.5,
        kv_quant_orig_scale=None if ks is None else _t(ks),
        fresh_kv=tuple(map(_t, fresh)), start_index=_t(start))
    assert out.shape == (B, H, 1, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_grouped_decode_needs_fresh_kv_and_no_projection():
    """The JAX dispatch asserts both for the grouped mode (:849-851)."""
    cache = torch.zeros(1, 1, 2, 1, 16, 8)
    q = torch.zeros(1, 4, 1, 16)
    seq = torch.tensor([3])
    with pytest.raises(ValueError, match="fresh"):
        pdec.fused_decode_attention(cache, 0, q, seq, 0.25)
    fresh = (torch.zeros(1, 1, 16, 1),) * 2
    with pytest.raises(ValueError, match="equal-heads"):
        pdec.fused_decode_attention(
            cache, 0, q, seq, 0.25, fresh_kv=fresh,
            proj=(torch.zeros(64, 64, dtype=torch.int8), torch.ones(64),
                  None))


# -- (b) the grouped prefill -----------------------------------------------

@pytest.mark.parametrize("hkv", [1, 2])
def test_grouped_prefill_matches_jax(hkv):
    """Six prompt tokens written at column 2 of a 12-column cache, causal
    from the write index, row 1's keys below 3 masked (its first query
    attends nothing: finite, as in the JAX formulation)."""
    from eddie_wang_hackathon2023_tpu.ops.attention import \
        cached_decode_attention as j_cda
    rs = np.random.RandomState(hkv)
    B, H, Lq, D, S = 2, 4, 6, 16, 12
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    cache = rs.randn(B, 2, hkv, D, S).astype(np.float32)
    seq = np.full((B,), 2 + Lq, np.int32)
    start = np.asarray([0, 3], np.int32)
    ref = j_cda(_j(q), _j(cache), _j(seq), scale=0.3, causal_offset=2,
                start_index=_j(start))
    out = pattn.cached_decode_attention(_t(q), _t(cache), _t(seq), scale=0.3,
                                        causal_offset=2,
                                        start_index=_t(start))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# -- (c) the models, built from one numpy state on both sides ----------------

MQA = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=2,
           num_kv_heads=1, max_position_embeddings=64)      # 2 heads of 128
GQA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, max_position_embeddings=64)      # 4 heads of 32


def _models(kw, woq: bool, seed: int = 0):
    """(JAX model, port model, float state) for one decoder config, fp32,
    random weights (LayerNorm weights 1 + N(0, 0.02), the rest N(0, 0.2)),
    int8 weight-only on both sides with ``woq``."""
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    jstate = state
    if woq:
        jm, jstate = j_woq(jm, state, JQ.use_weight_only())
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jstate.items()})
    pc = DecoderConfig(**kw, dtype="float32", quant_mode=(
        QuantMode.use_weight_only() if woq else QuantMode(0)))
    pm = from_jax_state(quantize_state(state, pc), pc, device="cpu")
    return jm, pm, state


@pytest.mark.parametrize("family", ["mqa", "gqa"])
def test_separate_kv_quantiser_bit_equal_to_jax(family):
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    kw = MQA if family == "mqa" else GQA
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(3)
    state = {n: rs.randn(*p.shape).astype(np.float32)
             for n, p in jm.named_parameters()}
    _, jq = j_woq(jm, state, JQ.use_weight_only())
    pq = quantize_state(state, DecoderConfig(
        **kw, quant_mode=QuantMode.use_weight_only()))
    assert sorted(pq) == sorted(jq)
    assert "blocks.attention.qkv.kv_bias" in pq
    for k in pq:
        a, b = np.asarray(pq[k]), np.asarray(jq[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("woq", [False, True], ids=["float", "woq8"])
@pytest.mark.parametrize("family", ["mqa", "gqa"])
def test_decoder_logits_match_jax(family, woq):
    """A left-padded prefill of 6 tokens, then one decode step: logits and
    the updated caches."""
    jm, pm, _ = _models(MQA if family == "mqa" else GQA, woq)
    rs = np.random.RandomState(1)
    B, P, S = 2, 6, 10
    ids = rs.randint(0, 97, (B, P)).astype(np.int32)
    start = np.asarray([0, 2], np.int32)
    step = rs.randint(0, 97, (B, 1)).astype(np.int32)
    params = jm.state_dict()
    j_lg, j_cache = jm.apply(params, _j(ids), jm.new_kv_cache(B, S), 0,
                             jnp.full((B,), P, jnp.int32),
                             attention_start=_j(start))
    j_lg2, j_cache = jm.apply(params, _j(step), j_cache, P,
                              jnp.full((B,), P + 1, jnp.int32),
                              attention_start=_j(start))
    with torch.inference_mode():
        cache = pm.new_kv_cache(B, S)
        lg, cache = pm(_t(ids).long(), cache, 0, torch.full((B,), P),
                       attention_start=_t(start))
        lg2, cache = pm(_t(step).long(), cache, P, P + 1,
                        attention_start=_t(start))
    assert lg.dtype == torch.float32 and lg.shape == (B, P, 97)
    np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=1e-4)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(j_lg2), atol=1e-4)
    np.testing.assert_allclose(cache.numpy(), np.asarray(j_cache),
                               atol=1e-4)


# -- (d) greedy generation ---------------------------------------------------

@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "gqa_kernel"])
@pytest.mark.parametrize("woq", [False, True], ids=["float", "woq8"])
@pytest.mark.parametrize("family", ["mqa", "gqa"])
def test_generation_token_exact_with_jax(family, woq, pallas, monkeypatch):
    """Three ragged prompts (5, 2 and 4 tokens, left-padded, bucketed to 8),
    10 new tokens; the end id is a token that row 0 generates on its fourth
    step, so rows finish at different steps.  The JAX side runs its XLA
    formulation or its ``_gqa_kernel`` in interpret mode, with the decode
    tail off (set before its first trace)."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    monkeypatch.setenv("EWT_PALLAS_DECODE", pallas)
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    kw = MQA if family == "mqa" else GQA
    jm, pm, _ = _models(kw, woq, seed=2)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 96, (3, 5)).astype(np.int32)
    lens = np.asarray([5, 2, 4], np.int32)
    mc = dict(vocab_size=97, num_layers=2, num_heads=kw["num_heads"],
              hidden_size=kw["hidden_size"], max_seq_len=64,
              num_kv_heads=kw["num_kv_heads"])
    sess = GenerationSession(ModelConfig(**mc), pm,
                             SamplingConfig(end_id=-1, pad_id=96))
    free, _, _ = sess.decode(ids, lens, max_new_tokens=10)
    end_id = int(free[0, 0, 5 + 3])
    pt, pl, pc = sess.decode(ids, lens, SamplingConfig(end_id=end_id,
                                                       pad_id=96),
                             max_new_tokens=10)
    jt, jl, jc = JSession(JMC(**mc), jm, JSampling(end_id=end_id,
                                                   pad_id=96)).decode(
        ids, lens, max_new_tokens=10)
    assert pt.shape == (3, 1, 15) and pl.min() < 15
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("prompt_len", [4, 11])
def test_greedy_matches_hf_gpt_bigcode(prompt_len):
    """HF GPTBigCode (multi-query) with random weights, converted by
    ``from_hf_santacoder``: 12 greedy tokens equal ``generate``'s (the
    11-token prompt is left-padded to its bucket of 16 inside the port)."""
    import transformers as T

    from eddie_wang_hackathon2023_tpu_torch.models.families import (
        from_hf_santacoder, santacoder_config)
    torch.manual_seed(1)
    cfg = T.GPTBigCodeConfig(vocab_size=97, n_positions=96, n_embd=64,
                             n_layer=2, n_head=4, multi_query=True)
    hf = T.GPTBigCodeForCausalLM(cfg).eval()
    config = santacoder_config(cfg, dtype="float32")
    assert config.num_kv_heads == 1
    model = from_jax_state(from_hf_santacoder(hf.state_dict(), config),
                           config, device="cpu")
    prompt = np.random.RandomState(prompt_len).randint(
        0, 96, (1, prompt_len)).astype(np.int32)
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompt.astype(np.int64)),
                          max_new_tokens=12, do_sample=False,
                          pad_token_id=96).numpy()[0]
    sess = GenerationSession(
        ModelConfig(vocab_size=97, num_layers=2, num_heads=4, hidden_size=64,
                    max_seq_len=96, num_kv_heads=1), model,
        SamplingConfig(end_id=-1, pad_id=96))
    tokens, lens, _ = sess.decode(prompt, np.asarray([prompt_len]),
                                  max_new_tokens=12)
    np.testing.assert_array_equal(tokens[0, 0], ref)
    assert lens[0, 0] == prompt_len + 12


def test_greedy_step_and_buckets_match_jax():
    """``dynamic_decode``'s greedy branch (ties to the first index) and the
    prompt buckets."""
    from eddie_wang_hackathon2023_tpu.runtime.generation import \
        bucket_length as j_bucket
    from eddie_wang_hackathon2023_tpu.runtime.sampling import (
        DecodeParams, dynamic_decode as j_decode)
    from eddie_wang_hackathon2023_tpu.runtime.sampling import \
        SamplingConfig as JSampling
    rs = np.random.RandomState(6)
    logits = rs.randn(4, 50).astype(np.float32)
    logits[1, [7, 30]] = logits[1].max() + 1          # a tie
    jt, jlp = j_decode(_j(logits), None, DecodeParams.from_config(
        JSampling(), 4))
    tok, lp = dynamic_decode(_t(logits), None, PDecodeParams.from_config(
        SamplingConfig(), 4))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    assert int(tok[1]) == 7
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6)
    for n in (1, 8, 9, 60, 2048, 2049):
        assert bucket_length(n) == j_bucket(n)


# -- (e) chip_smoke.py's decoder path, rehearsed -----------------------------

def test_chip_smoke_decoder_path_on_cpu():
    """The decoder path of ``chip_smoke.py`` at 2 layers of width 256
    (SantaCoder's head dim 128, one KV head, vocab 97), bf16 and woq8 as on
    the card: it builds, generates 20 tokens for 8 prompts, launches no
    kernel from CPU tensors, and its teacher-forced replay through the
    plain path is exact (on the CPU both are the plain version)."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = dataclasses.replace(
        smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128)
    e2e, counts = smoke.decoder_path(torch, np, config=config, device="cpu")
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0
    assert e2e["logits_argmax_agreement"] == 1.0
    assert e2e["tokens_per_s"] > 0


# -- (f) what is not ported, and the device choice --------------------------

@pytest.mark.parametrize("option", [
    dict(position_embedding="alibi"), dict(position_embedding="glm_rope"),
    dict(deepnorm_alpha=2.0), dict(bidirectional_context=True),
    dict(embedding_norm=True), dict(apply_query_key_layer_scaling=True),
    dict(quant_mode=QuantMode.use_weight_only().set_fp8_kv_cache())],
    ids=lambda o: next(iter(o)))
def test_unported_decoder_options_raise(option):
    """An fp8 (e4m3) KV cache is ported (held against the JAX package in
    tests/test_torch_fp8_serving.py): it builds, its cache is e4m3, and it
    runs as the options below do.  Bloom's and ChatGLM-6B's options are
    ported (held
    against the JAX package in tests/test_torch_families_b.py): on the MQA
    model each builds and a left-padded prefill and one step give finite
    logits (GLM's positions with the true prompt lengths).  RoPE, RMSNorm,
    the gated MLP, the parallel residual and a separate LM head are ported
    (tests/test_torch_families.py)."""
    config = DecoderConfig(**{**MQA, **option}, dtype="float32")
    model = DecoderLMHead(config)
    if config.quant_mode.has_fp8_kv_cache():
        assert model.new_kv_cache(1, 8).dtype == torch.float8_e4m3fn
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    ctx = ({"context_lengths": torch.tensor([3])}
           if model.needs_context_lengths else {})
    start = torch.tensor([1], dtype=torch.int32)
    with torch.inference_mode():
        cache = model.new_kv_cache(1, 8)
        lg, cache = model(torch.tensor([[0, 5, 7, 9]]), cache, 0,
                          torch.tensor([4], dtype=torch.int32),
                          attention_start=start, **ctx)
        step, _ = model(torch.tensor([[3]]), cache, 4, 5,
                        attention_start=start, **ctx)
    assert lg.shape == (1, 4, 97) and step.shape == (1, 1, 97)
    assert torch.isfinite(lg[:, 1:]).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("sampling", [
    dict(top_k=5, temperature=0.8), dict(top_p=0.9),
    dict(repetition_penalty=1.2), dict(min_length=3),
    dict(bad_words_list=[[3]]), dict(stop_words_list=[[3, 4]]),
    dict(num_beams=2)], ids=lambda o: next(iter(o)))
def test_unported_sampling_raises(sampling, monkeypatch):
    """Beams over the MQA cache still raise (the JAX package cannot run
    them either, ``test_torch_generation.py``).  The other options raised
    until the port's sampling landed; each now runs token-exact with the
    JAX session on the MQA model (the JAX noise in place of the port's),
    lengths exact, cum log-probs within 1e-5."""
    if "num_beams" in sampling:
        model = DecoderLMHead(DecoderConfig(**MQA, dtype="float32"))
        sess = GenerationSession(ModelConfig(97, 2, 2, 256, 64, 1), model,
                                 SamplingConfig(**sampling))
        with pytest.raises(NotImplementedError):
            sess.decode(np.zeros((1, 3), np.int32), np.asarray([3]),
                        max_new_tokens=2)
        return
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    jm, pm, _ = _models(MQA, False, seed=2)
    sc = dict(end_id=-1, pad_id=96, **sampling)
    ids = np.random.RandomState(4).randint(0, 96, (2, 5)).astype(np.int32)
    lens = np.asarray([5, 3], np.int32)
    mc = (97, 2, 2, 256, 64, 1)
    sess = GenerationSession(ModelConfig(*mc), pm, SamplingConfig(**sc))
    sess._gumbel = _jax_noise(1)
    pt, pl, pc = sess.decode(ids, lens, max_new_tokens=8, seed=1)
    jt, jl, jc = JSession(JMC(*mc), jm, JSampling(**sc)).decode(
        ids, lens, max_new_tokens=8, seed=1)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-5)


def test_unported_forward_modes_raise():
    model = DecoderLMHead(DecoderConfig(**MQA, dtype="float32"))
    tok = torch.zeros((1, 1), dtype=torch.long)
    cache = model.new_kv_cache(1, 8)
    seq = torch.tensor([1])
    for kw in (dict(beam_indirection=torch.zeros(1, 1, 8)),
               dict(kv_tail=cache)):
        with pytest.raises(NotImplementedError):
            model(tok, cache, 0, seq, **kw)
    # per-row write positions (serving's dense slot cache) are ported: a
    # [B] write index gives the int one's logits and cache, and is not
    # taken by the megakernel, which the blobs would otherwise route to
    with torch.inference_mode():
        want, _ = model(tok, cache, 0, seq)
        row_cache = model.new_kv_cache(1, 8)
        got, _ = model(tok, row_cache, torch.tensor([0]), seq,
                       megakernel_blobs=object())
    # (the weights are the model's uninitialised ones: NaN where NaN)
    for a, b in ((got, want), (row_cache, cache)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # the megakernel's grouped mode is ported: the MQA model (heads of 128)
    # is eligible, its session packs blobs at batch 1 (the K and V columns
    # beside q's panel) and none at batch 2
    assert model.megakernel_eligible()
    sess = GenerationSession(
        ModelConfig(vocab_size=97, num_layers=2, num_heads=2,
                    hidden_size=256, num_kv_heads=1), model,
        SamplingConfig(end_id=-1, pad_id=0), decode_megakernel=True)
    assert sess._megakernel_blobs(2) is None
    blobs = sess._megakernel_blobs(1)
    assert blobs.kvblob.shape == (2, 256, 2 * 128)


def test_decoder_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = DecoderConfig(**MQA, dtype="float32")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            from_jax_state({}, config, device=device)
    with pytest.raises(RuntimeError):               # the empty state
        from_jax_state({}, config, device="cpu")
