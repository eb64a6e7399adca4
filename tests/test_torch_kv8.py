"""The int8 self-KV cache (``kv8``) of the port against the JAX package on
the CPU, with the same numpy-seeded inputs on both sides, at the tiny
Whisper of ``test_torch_whisper.py`` (2+2 layers, d 64, 4 heads) and, for
the megakernel, a Whisper of d 128 with heads of 64:

* the recipe: ``Recipe.parse`` takes ``kv8``, ``decoder_state_dict(
  int8_kv_scales=)`` equals the JAX converter's array for array, and
  ``quantize_states`` refuses ``kv8`` without scales;
* the calibration: ``kv_abs_max`` and ``calibrate_int8_kv`` against the
  JAX functions on the same model and mel, fp32, rel 1e-5;
* the decoder: the int8 self cache bit-equal to the JAX cache after the
  prefill and after 3 decode steps (the bar of the JAX package's own
  megakernel test, ``tests/test_megakernel.py:94-95``), the logits within
  1e-4;
* transcription token-exact with the JAX pipeline: greedy under ``kv8``
  and under ``woq8+kv8+ckv8+lmq8+sqenc`` on the layer-by-layer path and
  through the megakernel's plain version (``decode_megakernel=True``), and
  beam search under ``woq8+kv8+ckv8+lmq8``;
* SmoothQuant smoothing: ``smooth_quantize_weights``, ``apply_smoothing``
  and ``smooth_gemm`` bit-equal to the JAX functions, and
  ``smooth_quantize_state_dict`` with activation scales and LayerNorm paths
  equal to the JAX surgery on a stacked encoder state, whose encoder output
  agrees within the SmoothQuant tolerance of ``test_torch_whisper.py``;
* the decoder-only model (SantaCoder class, MQA) under ``woq8`` with an
  int8 KV cache: greedy tokens exact with the JAX ``GenerationSession``;
  its int8 cache equal but for one-step flips of values within fp32
  summation error of a rounding tie (stated in the test), and the cache
  writes bit-equal to the JAX functions on the same inputs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JConfig,
    WhisperDecoder as JDecoder, WhisperEncoder as JEncoder)
from eddie_wang_hackathon2023_tpu.models.whisper.convert import (
    decoder_state_dict as j_decoder_state_dict)
from eddie_wang_hackathon2023_tpu.models.whisper.model import (
    quantize_lm_head_state as j_quantize_lm_head_state)
from eddie_wang_hackathon2023_tpu.models.whisper.pipeline import (
    DecodingOptions as JOptions, WhisperPipeline as JPipeline)
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQuantMode
from eddie_wang_hackathon2023_tpu.quantization import (
    smoothquant_layers as j_sql)
from eddie_wang_hackathon2023_tpu.quantization.calibration import (
    calibrate_int8_kv as j_calibrate_int8_kv, kv_abs_max as j_kv_abs_max)
from eddie_wang_hackathon2023_tpu.quantization.surgery import (
    smooth_quantize as j_smooth_quantize,
    smooth_quantize_state_dict as j_smooth_quantize_state_dict,
    weight_only_quantize_state as j_weight_only_quantize_state)
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    BENCH_RECIPE, Recipe, WhisperConfig, from_jax_state, quantize_states)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.convert import (
    decoder_state_dict)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.quantization import (
    smoothquant_layers as p_sql)
from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import (
    calibrate_cross_kv_scales, calibrate_int8_kv, kv_abs_max)
from eddie_wang_hackathon2023_tpu_torch.quantization.mode import QuantMode
from eddie_wang_hackathon2023_tpu_torch.quantization.surgery import (
    smooth_quantize_state_dict)
from test_torch_whisper import (DIMS, FLOAT_STATES, JCFG, MEL, PCFG,
                                SAMPLE_LEN, _jax_build, _random_state)

KV8_RECIPE = "woq8+kv8+ckv8+lmq8+sqenc"
# the megakernel's Whisper: d 128, 2 heads of 64, 2+2 layers
MK_DIMS = {**DIMS, "n_audio_state": 128, "n_audio_head": 2,
           "n_text_state": 128, "n_text_head": 2}
MK_JCFG, MK_PCFG = JConfig(**MK_DIMS), WhisperConfig(**MK_DIMS)
MK_STATES = tuple(
    _random_state(m, np.random.RandomState(seed))
    for m, seed in ((JEncoder(MK_JCFG), 0), (JDecoder(MK_JCFG), 1),
                    (JCrossAttnKV(MK_JCFG), 2)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _build(recipe, kv_step=None, pcfg=PCFG, **kw):
    """The JAX pipeline for ``recipe`` (``kv8`` with the per-layer steps
    ``kv_step``; :func:`test_torch_whisper._jax_build`), and the port's
    modules from the same quantised numpy states."""
    jpipe, states = _jax_build(recipe, kv_step=kv_step, **kw)
    return jpipe, from_jax_state(*states, pcfg, recipe=recipe, device="cpu")


@functools.lru_cache(maxsize=None)
def _float_pair(which="tiny"):
    """(JAX, port) float pipelines of the tiny (or the megakernel's)
    Whisper, for the calibration."""
    kw = (dict(jcfg=MK_JCFG, pcfg=MK_PCFG, float_states=MK_STATES)
          if which == "mk" else {})
    jpipe, mods = _build("none", **kw)
    pcfg = kw.get("pcfg", PCFG)
    return jpipe, WhisperPipeline(pcfg, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN))


@functools.lru_cache(maxsize=None)
def _kv_step(which="tiny"):
    """The port's calibrated self-KV steps of the float model."""
    return calibrate_int8_kv(_float_pair(which)[1], [MEL[0]])


# -- (a) the recipe and the converter ---------------------------------------

def test_recipe_takes_kv8_and_refuses_what_is_not_ported():
    r = Recipe.parse(KV8_RECIPE)
    assert r.decoder.has_int8_kv_cache() and r.decoder.is_int8_weight_only()
    # the encoder keeps no cache
    assert not r.encoder.has_int8_kv_cache()
    assert r.encoder.has_act_and_weight_quant() and r.lm_head and r.ckv8
    plain = Recipe.parse("kv8")
    assert plain.decoder.has_int8_kv_cache()
    assert not plain.decoder.is_weight_only()
    for bad in ("kv8+fp8kv", "kv4", "woq8+kv16"):
        with pytest.raises(NotImplementedError):
            Recipe.parse(bad)
    enc_sd, dec_sd, ckv_sd = FLOAT_STATES
    with pytest.raises(ValueError, match="kv8"):
        quantize_states(enc_sd, dec_sd, ckv_sd, "woq8+kv8")
    t = np.full((2, 1), 0.01, np.float32)
    _, dq, _ = quantize_states(
        enc_sd, {**dec_sd, "blocks.attn.kv_orig_quant_scale": 1 / t,
                 "blocks.attn.kv_quant_orig_scale": t}, ckv_sd, "woq8+kv8")
    np.testing.assert_array_equal(dq["blocks.attn.kv_quant_orig_scale"], t)


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py`` as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_decoder_state_dict_with_kv_scales_equals_jax():
    sd = _smoke().random_openai_state(np, PCFG, np.random.default_rng(3))
    scales = np.asarray([0.013, 0.027], np.float32)
    ref = j_decoder_state_dict(sd, JCFG, int8_kv_scales=scales)
    out = decoder_state_dict(sd, PCFG, int8_kv_scales=scales)
    assert sorted(out) == sorted(ref)
    for k in ref:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert out["blocks.attn.kv_orig_quant_scale"].shape == (2, 1)


# -- (b) calibration ---------------------------------------------------------

def test_kv_abs_max_and_calibration_match_jax():
    """Both sides calibrate their float pipeline on the same mel: the greedy
    tokens are the same (test_torch_whisper), and the per-layer amax of the
    teacher-forced prefill agrees to fp32 rounding of the sums."""
    jpipe, ppipe = _float_pair()
    ref = j_calibrate_int8_kv(jpipe, [MEL[0]])
    out = _kv_step()
    assert out.shape == ref.shape == (DIMS["n_text_layer"],)
    assert out.dtype == np.float32 and (out > 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    # kv_abs_max alone, on tokens and lengths of rows of their own
    rs = np.random.RandomState(5)
    tokens = rs.randint(0, 50000, (2, 9)).astype(np.int32)
    lengths = np.asarray([9, 6], np.int32)
    xa = np.asarray(jpipe.get_audio_features(np.concatenate([MEL, MEL])))
    cross = jpipe.precompute_cross_kv(xa)
    jpipe._ensure_params()
    ref = j_kv_abs_max(jpipe.decoder, jpipe._params_dec, jnp.asarray(tokens),
                       cross, jnp.asarray(lengths))
    out = kv_abs_max(ppipe.decoder, _t(tokens).long(), _t(cross),
                     _t(lengths))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5)


# -- (c) the decoder's int8 self cache --------------------------------------

def _jax_decoder_run(jpipe, tokens, cross, write_index, seq_len, cache=None):
    dec = jpipe.decoder
    if cache is None:
        cache = dec.new_kv_cache(tokens.shape[0])
    logits, cache = dec.apply(jpipe._params_dec, jnp.asarray(tokens),
                              cache, cross, write_index,
                              jnp.full((tokens.shape[0],), seq_len,
                                       jnp.int32))
    return np.asarray(logits), cache


@torch.inference_mode()
def test_int8_cache_bit_equal_after_prefill_and_steps():
    """The prompt's prefill, then 3 single-token steps, on the same cross
    K/V and tokens: the int8 cache equal bit for bit, the logits within
    1e-4."""
    jpipe, (_, dec, _) = _build(KV8_RECIPE, _kv_step())
    xa = np.asarray(jpipe.get_audio_features(MEL))
    cross_j = jpipe.precompute_cross_kv(xa)
    cross_p = tuple(_t(t) for t in cross_j)
    prompt = np.asarray([[50258, 50259, 50359]], np.int32)
    lj, cache_j = _jax_decoder_run(jpipe, prompt, cross_j, 0, 3)
    cache_p = dec.new_kv_cache(1)
    assert cache_p.dtype == torch.int8 and cache_j.dtype == jnp.int8
    lp, cache_p = dec(_t(prompt).long(), cache_p, cross_p, 0, 3)
    np.testing.assert_allclose(lp.numpy(), lj, atol=1e-4)
    np.testing.assert_array_equal(cache_p.numpy(), np.asarray(cache_j))
    # the calibrated range is used
    assert np.abs(cache_p.numpy().astype(int)).max() > 64
    for step, tok in enumerate((50364, 440, 1029)):
        pos = 3 + step
        lj, cache_j = _jax_decoder_run(
            jpipe, np.asarray([[tok]], np.int32), cross_j, pos, pos + 1,
            cache=cache_j)
        lp, cache_p = dec(torch.tensor([[tok]]), cache_p, cross_p, pos,
                          pos + 1)
        np.testing.assert_allclose(lp.numpy(), lj, atol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_p.numpy(), np.asarray(cache_j),
                                      err_msg=f"step {step}")


# -- (d) transcription --------------------------------------------------------

def _assert_same(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert out.tokens == [int(t) for t in ref.tokens], (out.tokens,
                                                            ref.tokens)
        assert len(out.tokens) > 1
        assert out.text == ref.text
        assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3


@pytest.mark.parametrize("recipe", ["kv8", KV8_RECIPE])
def test_kv8_transcribe_token_exact(recipe):
    """The layer-by-layer path (the CPU default)."""
    jpipe, mods = _build(recipe, _kv_step())
    pipe = WhisperPipeline(PCFG, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN))
    assert pipe.decoder.new_kv_cache(1).dtype == torch.int8
    _assert_same(pipe.transcribe(MEL), jpipe.transcribe(MEL))


def test_kv8_megakernel_plain_token_exact():
    """The megakernel's plain version over the int8 self cache
    (``decode_megakernel=True``) against the JAX pipeline, at the width the
    kernel takes (heads of 64)."""
    jpipe, mods = _build(KV8_RECIPE, _kv_step("mk"), jcfg=MK_JCFG,
                         pcfg=MK_PCFG, float_states=MK_STATES)
    pipe = WhisperPipeline(MK_PCFG, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN), decode_megakernel=True)
    blobs = pipe._megakernel_blobs()
    assert blobs is not None
    # the blobs carry the calibrated scales the kernel quantises with
    np.testing.assert_allclose(blobs.kv_qo.numpy(), _kv_step("mk"),
                               rtol=1e-6)
    _assert_same(pipe.transcribe(MEL), jpipe.transcribe(MEL))


def test_kv8_beam_transcribe_token_exact():
    jpipe, mods = _build("woq8+kv8+ckv8+lmq8", _kv_step(), beam_size=3)
    pipe = WhisperPipeline(PCFG, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN, beam_size=3))
    _assert_same(pipe.transcribe(MEL), jpipe.transcribe(MEL))


# -- (e) SmoothQuant smoothing ------------------------------------------------

def test_smoothing_functions_bit_equal_to_jax():
    rs = np.random.RandomState(9)
    w = (rs.randn(48, 32) * 0.1).astype(np.float32)
    w[3, 7] = 0.0
    act = np.abs(rs.randn(32)).astype(np.float32) + 0.01
    lw, lb = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    for per_channel in (True, False):
        for a, b in zip(p_sql.smooth_quantize_weights(w, per_channel),
                        j_sql.smooth_quantize_weights(w, per_channel)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    scales = np.abs(rs.randn(32)).astype(np.float32) + 0.5
    for args in ((scales, w, lw, lb), (scales, w)):
        out, ref = p_sql.apply_smoothing(*args), j_sql.apply_smoothing(*args)
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert np.array_equal(out[k], ref[k]), k
    for alpha in (0.5, 0.8):
        (s, out), (s_j, ref) = (f.smooth_gemm(w, act, lw, lb, alpha=alpha)
                                for f in (p_sql, j_sql))
        assert np.array_equal(s, s_j)
        for k in ref:
            assert np.array_equal(out[k], ref[k]), k


def test_smooth_quantize_state_dict_with_act_scales_matches_jax():
    """The tiny encoder's stacked state, smoothed with per-layer activation
    amax on the QKV and fc1 (each with its LayerNorm) and a shared amax on
    fc2 (no LayerNorm): every array equal to the JAX surgery's, and the
    encoder built from it agrees with the JAX encoder."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import (
        ENCODER_LINEARS)
    enc_sd = dict(FLOAT_STATES[0])
    rs = np.random.RandomState(12)
    L, d = DIMS["n_audio_layer"], DIMS["n_audio_state"]
    act = {"blocks.attn.qkv": np.abs(rs.randn(L, d)) + 0.1,
           "blocks.mlp1": np.abs(rs.randn(L, d)) + 0.1,
           "blocks.mlp2": np.abs(rs.randn(4 * d)) + 0.1}
    act = {k: v.astype(np.float32) for k, v in act.items()}
    ln_paths = {"blocks.attn.qkv": "blocks.attn_ln",
                "blocks.mlp1": "blocks.mlp_ln"}
    sq = JQuantMode.use_smooth_quant(per_token=True, per_channel=True)
    jenc = j_smooth_quantize(JEncoder(JCFG, JQuantMode(0)), sq)
    ref = j_smooth_quantize_state_dict(jenc, enc_sd, sq, act_scales=act,
                                       ln_paths=ln_paths, alpha=0.6)
    out = smooth_quantize_state_dict(
        enc_sd, ENCODER_LINEARS,
        QuantMode.use_smooth_quant(per_token=True, per_channel=True),
        act_scales=act, ln_paths=ln_paths, alpha=0.6)
    assert sorted(out) == sorted(ref)
    for k in ref:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # the LayerNorms took the inverse scaling
    assert not np.array_equal(out["blocks.attn_ln.weight"],
                              enc_sd["blocks.attn_ln.weight"])
    jenc.load_state_dict(ref, strict=False)
    xa_j = np.asarray(jenc(MEL))
    penc, _, _ = from_jax_state(out, FLOAT_STATES[1], FLOAT_STATES[2], PCFG,
                                recipe="sqenc", device="cpu")
    with torch.inference_mode():
        xa = penc(_t(MEL)).numpy()
    # test_torch_whisper's SmoothQuant encoder tolerance
    assert np.abs(xa - xa_j).max() < 2e-3 and np.abs(xa - xa_j).mean() < 1e-4


# -- (f) the decoder-only model under woq8 + an int8 KV cache ----------------

MQA = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=2,
           num_kv_heads=1, max_position_embeddings=64)      # 2 heads of 128


def test_decoder_only_woq8_kv8_token_exact_and_cache():
    """SantaCoder class (one KV head of 128): scales from the woq8 model's
    cache after a prefill (amax / 127), then greedy generation of 10 tokens
    for three ragged left-padded prompts with the int8 cache on both sides
    (tokens and lengths exact), and one prefill + step whose int8 caches
    are compared.  Here a pre-rounding K value lies within fp32 summation
    error of a rounding tie (-28.499998 in the port, -29 in JAX), and its
    +-1 moves the later layers' values by a few 1e-3: the caches may differ
    by one step in under 1e-3 of their values, the cumulative log-probs by
    1e-2 (test_cache_writes_quantise_as_jax holds the writes bit-equal on
    the same inputs)."""
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JDConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state as d_from_jax_state, quantize_state)
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig)
    rs = np.random.RandomState(2)
    state = {}
    for name, p in JModel(JDConfig(**MQA, dtype="float32")).named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    woq = QuantMode.use_weight_only()
    qstate = quantize_state(state, DecoderConfig(**MQA, quant_mode=woq))
    ids = rs.randint(0, 96, (3, 5)).astype(np.int32)
    lens = np.asarray([5, 2, 4], np.int32)
    pad = np.full((3, 3), 96, np.int32)
    prompt, start = np.concatenate([pad, ids], 1), 8 - lens
    # the scales: amax / 127 of the woq8 model's cache after the prefill
    pm8 = d_from_jax_state(qstate, DecoderConfig(
        **MQA, dtype="float32", quant_mode=woq), device="cpu")
    with torch.inference_mode():
        cache = pm8.new_kv_cache(3, 8)
        pm8(_t(prompt).long(), cache, 0, torch.full((3,), 8),
            attention_start=_t(start))
    t = (cache.float().abs().amax(dim=(1, 2, 3, 4, 5)) / 127).numpy() \
        .reshape(-1, 1)
    kv = {"blocks.attention.kv_orig_quant_scale": 1.0 / t,
          "blocks.attention.kv_quant_orig_scale": t}
    pm = d_from_jax_state({**qstate, **kv}, DecoderConfig(
        **MQA, dtype="float32", quant_mode=woq.set_int8_kv_cache()),
        device="cpu")
    jm = JModel(JDConfig(**MQA, dtype="float32",
                         quant_mode=JQuantMode.use_weight_only()
                         .set_int8_kv_cache()))
    jm, jq = j_weight_only_quantize_state(jm, {**state, **kv},
                                          JQuantMode.use_weight_only())
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jq.items()})
    assert pm.new_kv_cache(1, 4).dtype == torch.int8
    mc = dict(vocab_size=97, num_layers=2, num_heads=2, hidden_size=256,
              max_seq_len=64, num_kv_heads=1)
    pt, pl, pc = GenerationSession(ModelConfig(**mc), pm, SamplingConfig(
        end_id=-1, pad_id=96)).decode(ids, lens, max_new_tokens=10)
    jt, jl, jc = JSession(JMC(**mc), jm, JSampling(
        end_id=-1, pad_id=96)).decode(ids, lens, max_new_tokens=10)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, atol=1e-2)
    # one left-padded prefill and one step: the int8 caches
    params = jm.state_dict()
    _, j_cache = jm.apply(params, jnp.asarray(prompt), jm.new_kv_cache(3, 10),
                          0, jnp.full((3,), 8, jnp.int32),
                          attention_start=jnp.asarray(start))
    nxt = pt[:, 0, 5:6]
    _, j_cache = jm.apply(params, jnp.asarray(nxt), j_cache, 8,
                          jnp.full((3,), 9, jnp.int32),
                          attention_start=jnp.asarray(start))
    with torch.inference_mode():
        cache = pm.new_kv_cache(3, 10)
        _, cache = pm(_t(prompt).long(), cache, 0, torch.full((3,), 8),
                      attention_start=_t(start))
        _, cache = pm(_t(nxt).long(), cache, 8, 9, attention_start=_t(start))
    assert j_cache.dtype == jnp.int8
    diff = np.abs(cache.numpy().astype(int) - np.asarray(j_cache).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert np.abs(cache.numpy().astype(int)).max() > 64


@pytest.mark.parametrize("kv_heads", [4, 1])
def test_cache_writes_quantise_as_jax(kv_heads):
    """The self cache's writes on the same float K/V: the prefill's
    ``append_kv_stacked`` and the decode step's ``cast_kv_for_cache``, with
    values on exact rounding ties (half away from zero) and past the clip,
    bit-equal to the JAX functions."""
    from eddie_wang_hackathon2023_tpu.ops import attention as ja
    from eddie_wang_hackathon2023_tpu_torch.ops import attention as pa
    rs = np.random.RandomState(kv_heads)
    step = np.asarray([0.0625], np.float32)
    k, v = (rs.randn(2, kv_heads, 5, 16).astype(np.float32) * 3
            for _ in range(2))
    k[0, 0, 0, :6] = np.asarray([0.5, -0.5, 1.5, -2.5, 9.0, -9.0]) * step
    ref = ja.append_kv_stacked(jnp.zeros((3, 2, 2, kv_heads, 16, 8),
                                         jnp.int8), jnp.asarray(k),
                               jnp.asarray(v), 1, 2,
                               kv_orig_quant_scale=jnp.asarray(1 / step))
    out = pa.append_kv_stacked(torch.zeros(3, 2, 2, kv_heads, 16, 8,
                                           dtype=torch.int8), _t(k), _t(v),
                               1, 2, kv_orig_quant_scale=_t(1 / step))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[1, 0, 0, 0, :4, 2].tolist() == [1, -1, 2, -3]
    assert {-128, 127} <= set(out.numpy().ravel().tolist())
    one = (k[:, :, :1], v[:, :, :1])
    for a, b in zip(pa.cast_kv_for_cache(*map(_t, one), torch.int8,
                                         _t(1 / step)),
                    ja.cast_kv_for_cache(*map(jnp.asarray, one), jnp.int8,
                                         jnp.asarray(1 / step))):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- (g) chip_smoke.py's kv8 paths, rehearsed ---------------------------------

def test_chip_smoke_kv8_paths_on_cpu(monkeypatch):
    """``chip_smoke.py``'s kv8 paths at a tiny size with heads of 64 as on
    the card: the calibration on the main pipeline, the decoder rebuilt on
    the main model's weights (shared) with the int8 self cache, greedy
    transcription through the megakernel's plain version and layer by
    layer, each replayed against the plain scanned path (the megakernel's
    plain version quantises its own fresh K/V, so its gate is
    chip_smoke's; the layer-by-layer replay is exact on the CPU); then the
    decoder-only path under woq8 with an int8 cache, its scales from the
    woq8 run's cache after its prefill.  No kernel is launched from CPU
    tensors."""
    import dataclasses
    smoke = _smoke()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = WhisperConfig(**{**MK_DIMS, "n_text_ctx": 96})
        built = smoke.build_whisper(torch, np, cfg, "cpu", BENCH_RECIPE,
                                    "main")
        kv8, c1, scan, c2 = smoke.kv8_paths(torch, np, built, device="cpu")
        assert kv8["megakernel"] and not scan["megakernel"]
        assert kv8["recipe"] == scan["recipe"] == smoke.KV8_RECIPE
        assert 0 < kv8["self_kv_steps"][0] <= kv8["self_kv_steps"][1]
        assert kv8["logits_rel_err"] < 5e-2 and scan["logits_rel_err"] == 0.0
        assert kv8["slope_ms_per_token"] is not None
        assert [len(w) for w in kv8["in_turns_ms_per_utt"].values()] == [3, 3]
        assert scan["slope_ms_per_token"] is None
        assert set(c1.values()) == {0} and set(c2.values()) == {0}
        # the main decoder's weights are shared, not copied
        assert built["dec"].blocks[0].attn.use_int8_kv_cache is False
        dcfg = dataclasses.replace(
            smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
            num_layers=2, num_heads=2, max_position_embeddings=128)
        state = smoke.random_decoder_state(torch, np, dcfg,
                                           np.random.default_rng(0))
        woq8, _ = smoke.decoder_path(torch, np, config=dcfg, device="cpu",
                                     float_state=state)
        steps = np.asarray(woq8["kv_amax_after_prefill"], np.float32) / 127
        assert steps.shape == (2,) and (steps > 0).all()
        e2e, counts = smoke.decoder_path(
            torch, np, config=dataclasses.replace(
                dcfg, quant_mode=dcfg.quant_mode.set_int8_kv_cache()),
            device="cpu", label="decoder_kv8", float_state=state,
            kv_scales=steps)
        assert set(counts.values()) == {0}
        assert e2e["logits_rel_err"] == 0.0 and e2e["tokens_per_s"] > 0
        assert e2e["kv_amax_after_prefill"] is None
    finally:
        torch.set_num_threads(n)
