"""The PyTorch port's ops, quantisers, tokenizer and front end against the
JAX package on the CPU.  Inputs come from numpy seeds and go to both sides.

* the plain version of the decode-attention kernel against the Pallas
  kernel ``fused_decode_attention(..., interpret=True)``, fp32, 1e-5;
* the plain version of the flash kernel against ``flash_mha`` and the
  repo's Pallas FMHA (``custom_flash_mha(interpret=True)``), fp32, 1e-5;
* quantisers bit-equal (the cross-KV calibration is an fp32 GEMM: 1e-6);
* the tiktoken-free tokenizer against the tiktoken one;
* the port imports neither jax nor the JAX package, and its entry points
  refuse to run without a card unless asked for the CPU."""
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as pflash


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- (a) decode attention: plain version vs the Pallas kernel -------------

DECODE_CASES = {
    # cross-attention: int8 cache with its scale, full length, out-proj
    # int8 + bias; S=100 is not a multiple of the 32-column chunk
    "cross_int8_proj": dict(cache="int8", S=100, seq=[100, 100], fresh=False,
                            start=None, proj=True),
    # self-attention: float cache, fresh K/V, start index, out-proj
    "self_fresh_start_proj": dict(cache="f32", S=100, seq=[37, 64],
                                  fresh=True, start=[0, 5], proj=True),
    # no projection: the context itself, int8 with fresh K/V
    "int8_fresh_ctx": dict(cache="int8", S=70, seq=[1, 70], fresh=True,
                           start=None, proj=False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas_kernel(case):
    from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import \
        fused_decode_attention as j_fused
    c = DECODE_CASES[case]
    rs = np.random.RandomState(sorted(DECODE_CASES).index(case))
    L, B, H, D, S, N = 3, 2, 4, 16, c["S"], 48
    layer = 1
    q = rs.randn(B, H, 1, D).astype(np.float32)
    if c["cache"] == "int8":
        cache = rs.randint(-127, 128, (L, B, 2, H, D, S)).astype(np.int8)
        kscale = np.asarray(0.02, np.float32)
    else:
        cache = rs.randn(L, B, 2, H, D, S).astype(np.float32)
        kscale = None
    seq = np.asarray(c["seq"], np.int32)
    fresh = None
    if c["fresh"]:
        fresh = tuple(
            (rs.randint(-127, 128, (B, H, D, 1)).astype(np.int8)
             if c["cache"] == "int8"
             else rs.randn(B, H, D, 1).astype(np.float32)) for _ in range(2))
    start = None if c["start"] is None else np.asarray(c["start"], np.int32)
    proj = None
    if c["proj"]:
        proj = (rs.randint(-127, 128, (L, H * D, N)).astype(np.int8),
                (rs.rand(N) * 0.01).astype(np.float32),
                rs.randn(N).astype(np.float32))
    scale = D ** -0.5
    ref = j_fused(_j(cache), layer, _j(q), _j(seq), scale,
                  kv_quant_orig_scale=None if kscale is None else _j(kscale),
                  fresh_kv=None if fresh is None else tuple(map(_j, fresh)),
                  start_index=None if start is None else _j(start),
                  proj=None if proj is None else tuple(map(_j, proj)),
                  chunk=32, interpret=True)
    before = dict(pdec.launches)
    out = pdec.fused_decode_attention(
        _t(cache), layer, _t(q), _t(seq), scale,
        kv_quant_orig_scale=None if kscale is None else _t(kscale),
        fresh_kv=None if fresh is None else tuple(map(_t, fresh)),
        start_index=None if start is None else _t(start),
        proj=None if proj is None else tuple(map(_t, proj)))
    assert pdec.launches == before      # CPU tensors: no kernel launch
    assert out.shape == np.asarray(ref).shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["tail_kv", "group_shared", "gqa"])
def test_decode_modes_not_ported_raise(mode):
    cache = torch.zeros(1, 1, 2, 2, 16, 8)
    q = torch.zeros(1, 2, 1, 16)
    kw = {}
    if mode == "tail_kv":
        kw[mode] = (cache, 0)
    elif mode == "group_shared":
        q = torch.zeros(2, 2, 1, 16)        # two rows share one cache row
    else:
        # more query heads than KV heads (the grouped mode, ported) with the
        # K-step tail, which the grouped mode does not port either
        q = torch.zeros(1, 4, 1, 16)
        kw["fresh_kv"] = (torch.zeros(1, 2, 16, 1), torch.zeros(1, 2, 16, 1))
        kw["tail_kv"] = (cache, 0)
    with pytest.raises(NotImplementedError):
        pdec.fused_decode_attention(cache, 0, q, 4, 0.25, **kw)


# -- (b) flash attention: plain version vs flash_mha and the Pallas FMHA --

@pytest.mark.parametrize("valid", [200, 256])
def test_flash_plain_matches_jax_and_pallas_fmha(valid):
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "custom_kernel"))
    try:
        from pallas_fmha import custom_flash_mha
    finally:
        sys.path.pop(0)
    from eddie_wang_hackathon2023_tpu.ops.flash_attention import \
        flash_mha as j_flash
    rs = np.random.RandomState(valid)
    q, k, v = (rs.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3))
    scale = 0.125
    out = pflash.flash_mha(_t(q), _t(k), _t(v), scale=scale,
                           kv_valid_len=valid).numpy()
    ref = np.asarray(j_flash(_j(q), _j(k), _j(v), scale=scale,
                             kv_valid_len=valid))
    ref_fmha = np.asarray(custom_flash_mha(_j(q), _j(k), _j(v), scale=scale,
                                           kv_valid_len=valid,
                                           interpret=True))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref_fmha, rtol=1e-5, atol=1e-5)
    assert pflash.launches["flash_attention"] == 0


def test_flash_cpu_writes_into_out_view():
    """The encoder passes a transposed [B, L, H, D] buffer as ``out``."""
    rs = np.random.RandomState(3)
    q, k, v = (_t(rs.randn(1, 2, 40, 64).astype(np.float32))
               for _ in range(3))
    buf = torch.empty(1, 40, 2, 64)
    res = pflash.flash_mha(q, k, v, kv_valid_len=33, out=buf.transpose(1, 2))
    ref = pflash.plain_flash_mha(q, k, v, kv_valid_len=33)
    assert torch.equal(buf.transpose(1, 2), ref) and torch.equal(res, ref)


# -- (c) quantisers bit-equal ---------------------------------------------

def test_round_half_away_on_ties():
    from eddie_wang_hackathon2023_tpu.functional import round_half_away as jr
    from eddie_wang_hackathon2023_tpu_torch.functional import round_half_away
    x = np.asarray([-3.5, -2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.5, 3.5,
                    126.5, -127.5], np.float32)
    out = round_half_away(_t(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jr(_j(x))))
    np.testing.assert_array_equal(out[[1, 6, 8]], [-3.0, 1.0, 3.0])
    assert not torch.equal(round_half_away(_t(x)), torch.round(_t(x)))


def test_weight_only_int8_quantiser_bit_equal():
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        quantize_weights_int8 as jq
    from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import \
        quantize_weights_int8
    rs = np.random.RandomState(0)
    w = rs.randn(64, 48).astype(np.float32)
    w[:, 3] = 0.0                           # zero column: unit scale
    w[:, 7] = np.arange(64) * 0.5 / 63      # half-step multiples: ties
    for a, b in zip(quantize_weights_int8(w), jq(w)):
        np.testing.assert_array_equal(a, b)


def test_activation_quantisers_bit_equal():
    from eddie_wang_hackathon2023_tpu.quantization import functional as jf
    from eddie_wang_hackathon2023_tpu_torch.quantization import \
        functional as pf
    rs = np.random.RandomState(1)
    x = rs.randn(4, 7, 64).astype(np.float32)
    x[0, 0, :4] = [127.0, 0.5, -1.5, 2.5]   # per-token ties
    q, s = pf.quantize_per_token(_t(x))
    jq_, js = jf.quantize_per_token(_j(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pf.quantize(_t(x), 40.0).numpy(),
                                  np.asarray(jf.quantize(_j(x), 40.0)))
    w = rs.randint(-127, 128, (64, 24)).astype(np.int8)
    sw = (rs.rand(24) * 0.01).astype(np.float32)
    out = pf.smooth_quant_gemm(q, _t(w), s, _t(sw)).numpy()
    ref = np.asarray(jf.smooth_quant_gemm(jq_, _j(w), js, _j(sw)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def _dims():
    from eddie_wang_hackathon2023_tpu.models.whisper import WhisperConfig
    return WhisperConfig(n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                         n_audio_layer=2, n_text_ctx=16, n_text_state=64,
                         n_text_head=4, n_text_layer=2, dtype="float32")


def _state(module, seed):
    rs = np.random.RandomState(seed)
    return {n: (rs.standard_normal(p._shape) * 0.05).astype(np.float32)
            for n, p in module.named_parameters()}


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_weight_only_state_surgery_bit_equal():
    from eddie_wang_hackathon2023_tpu.models.whisper import WhisperDecoder
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        DECODER_LINEARS
    from eddie_wang_hackathon2023_tpu_torch.quantization import \
        QuantMode as PQuantMode
    from eddie_wang_hackathon2023_tpu_torch.quantization.surgery import \
        weight_only_quantize_state
    dec = WhisperDecoder(_dims())
    state = _state(dec, 0)
    _, ref = j_woq(dec, dict(state), QuantMode.use_weight_only())
    out = weight_only_quantize_state(state, DECODER_LINEARS,
                                     PQuantMode.use_weight_only())
    _assert_states_equal(out, ref)


def test_smoothquant_state_surgery_bit_equal():
    from eddie_wang_hackathon2023_tpu.models.whisper import WhisperEncoder
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode
    from eddie_wang_hackathon2023_tpu.quantization.surgery import (
        smooth_quantize, smooth_quantize_state_dict)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        ENCODER_LINEARS
    from eddie_wang_hackathon2023_tpu_torch.quantization import \
        QuantMode as PQuantMode
    from eddie_wang_hackathon2023_tpu_torch.quantization.surgery import \
        smooth_quantize_state_dict as p_sq
    enc = WhisperEncoder(_dims())
    state = _state(enc, 1)
    mode = QuantMode.use_smooth_quant(per_token=True, per_channel=True)
    ref = smooth_quantize_state_dict(smooth_quantize(enc, mode),
                                     dict(state), mode)
    out = p_sq(state, ENCODER_LINEARS,
               PQuantMode.use_smooth_quant(per_token=True, per_channel=True))
    _assert_states_equal(out, ref)


def test_lm_head_quantiser_bit_equal():
    from eddie_wang_hackathon2023_tpu.models.whisper.model import \
        quantize_lm_head_state as jq
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        quantize_lm_head_state
    rs = np.random.RandomState(2)
    state = {"token_embedding.weight":
             rs.randn(300, 64).astype(np.float32)}
    _assert_states_equal(quantize_lm_head_state(state), jq(state))


@pytest.mark.parametrize("batch", [1, 2])
def test_static_cross_kv_quantiser_bit_equal(batch):
    """Exactly representable inputs (products and sums exact in fp32), so
    both CrossAttnKV(static scale) outputs are bit-equal, ties included,
    at batch 1 (the stacked GEMM) and batch 2 (the einsum); and the port's
    calibration reproduces the JAX scales."""
    from eddie_wang_hackathon2023_tpu.models.whisper import \
        CrossAttnKV as JCrossAttnKV
    from eddie_wang_hackathon2023_tpu.quantization.calibration import \
        calibrate_cross_kv_scales as j_cal
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        WhisperConfig, cross_kv_from_jax_state)
    from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import \
        calibrate_cross_kv_scales
    jcfg = _dims()
    rs = np.random.RandomState(4)
    d, L, S = 64, 2, 24
    ckv_sd = {
        "blocks.k_linear.weight":
            (rs.randint(-2, 3, (L, d, d)) * 0.5).astype(np.float32),
        "blocks.v_linear.weight":
            (rs.randint(-2, 3, (L, d, d)) * 0.5).astype(np.float32),
        "blocks.v_linear.bias": (rs.randint(-4, 5, (L, d)) * 0.25)
        .astype(np.float32),
    }
    xa = (rs.randint(-8, 9, (batch, S, d)) * 0.25).astype(np.float32)
    scales = calibrate_cross_kv_scales(ckv_sd, [xa], device="cpu")
    jckv = JCrossAttnKV(jcfg, int8_output=True, static_scale=True)
    np.testing.assert_allclose(scales, j_cal(jckv, ckv_sd, [xa]), rtol=1e-6)
    # a scale that puts many values on exact .5 ties
    ckv_sd["kv_scale"] = np.full((L,), 0.5, np.float32)
    jckv.load_state_dict(ckv_sd)
    jq, js = jckv(_j(xa))
    pcfg = WhisperConfig(**{k: v for k, v in vars(jcfg).items()})
    pckv = cross_kv_from_jax_state(ckv_sd, pcfg, recipe="ckv8", device="cpu")
    pq, ps = pckv(_t(xa))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # the float K values are multiples of 0.25, so kv / 0.5 often lands on
    # an exact .5 tie, where half-away and half-to-even rounding differ
    k = np.einsum("bsi,loi->lbos", xa, ckv_sd["blocks.k_linear.weight"])
    assert (np.abs(k / 0.5) % 1 == 0.5).mean() > 0.1


def test_checkpoint_converters_match_jax():
    """HF -> OpenAI names -> JAX-layout state dicts, both packages, from a
    random transformers Whisper model."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperModel
    from eddie_wang_hackathon2023_tpu.models.whisper import convert as jconv
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        WhisperConfig, convert)
    jcfg = _dims()
    torch.manual_seed(0)
    hf = WhisperModel(HFConfig(
        vocab_size=jcfg.n_vocab, num_mel_bins=80, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, d_model=64, encoder_ffn_dim=256,
        decoder_ffn_dim=256, max_source_positions=jcfg.n_audio_ctx,
        max_target_positions=jcfg.n_text_ctx)).eval()
    sd = hf.state_dict()
    p_sd = convert.hf_to_openai_state_dict(sd)
    _assert_states_equal(p_sd, jconv.hf_to_openai_state_dict(sd))
    pcfg = WhisperConfig(**{k: v for k, v in vars(jcfg).items()})
    for name in ("encoder_state_dict", "decoder_state_dict",
                 "cross_kv_state_dict"):
        _assert_states_equal(getattr(convert, name)(p_sd, pcfg),
                             getattr(jconv, name)(p_sd, jcfg))


# -- (f) tokenizer ---------------------------------------------------------

def test_tokenizer_matches_tiktoken():
    from eddie_wang_hackathon2023_tpu.text.tokenizer import \
        get_tokenizer as j_get
    from eddie_wang_hackathon2023_tpu_torch.text.tokenizer import \
        get_tokenizer
    for lang, task in (("en", "transcribe"), ("de", "translate"),
                       ("ja", "transcribe")):
        p, j = get_tokenizer(True, lang, task), j_get(True, lang, task)
        assert p.sot_sequence == j.sot_sequence
        assert (p.sot_sequence_including_notimestamps
                == j.sot_sequence_including_notimestamps)
    p, j = get_tokenizer(True, "en", "transcribe"), j_get(True, "en",
                                                           "transcribe")
    assert p.special_tokens == j.special_tokens
    for name in ("eot", "sot", "sot_prev", "sot_lm", "no_speech",
                 "no_timestamps", "timestamp_begin", "transcribe",
                 "translate"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.non_speech_tokens == j.non_speech_tokens
    for text in (" ", " -", " '", "<<", " ♪♪♪", " hello", "world",
                 " 2024", "「", "<|endoftext|>"):
        assert p.encode(text) == j.encoding.encode(
            text, allowed_special="all"), text
    with pytest.raises(ValueError):
        p.encode("two words")
    rs = np.random.RandomState(0)
    for _ in range(200):
        ids = rs.randint(0, p.eot, rs.randint(1, 20)).tolist()
        assert p.decode(ids) == j.decode(ids), ids
    ids = [50364, 440, p.eot + 5, 1000, 50400]   # timestamps are dropped
    assert p.decode(ids) == j.decode(ids)


def test_suppress_tokens_match_jax():
    from eddie_wang_hackathon2023_tpu.models.whisper import (
        CrossAttnKV, WhisperDecoder, WhisperEncoder)
    from eddie_wang_hackathon2023_tpu.models.whisper.pipeline import (
        DecodingOptions as JOptions, WhisperPipeline as JPipeline)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        WhisperConfig, from_jax_state)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
        DecodingOptions, WhisperPipeline)
    jcfg = _dims()
    jmods = (WhisperEncoder(jcfg), WhisperDecoder(jcfg), CrossAttnKV(jcfg))
    states = [_state(m, i) for i, m in enumerate(jmods)]
    pcfg = WhisperConfig(**{k: v for k, v in vars(jcfg).items()})
    pmods = from_jax_state(*states, pcfg, device="cpu")
    for wt in (False, True):
        jp = JPipeline(jcfg, *jmods, JOptions(language="en",
                                              without_timestamps=wt))
        pp = WhisperPipeline(pcfg, *pmods, DecodingOptions(
            language="en", without_timestamps=wt))
        assert pp._get_suppress_tokens() == jp._get_suppress_tokens()
        assert pp.initial_tokens == jp.initial_tokens
        assert pp.max_initial_timestamp_index == \
            jp.max_initial_timestamp_index
        np.testing.assert_array_equal(pp._blank_mask.numpy(),
                                      jp._blank_mask)
        np.testing.assert_array_equal(pp._suppress_mask.numpy(),
                                      jp._suppress_mask)


def test_log_mel_matches_jax_frontend():
    from eddie_wang_hackathon2023_tpu.audio.mel import \
        log_mel_spectrogram as j_mel
    from eddie_wang_hackathon2023_tpu_torch.audio.mel import (
        log_mel_spectrogram, mel_filters)
    from eddie_wang_hackathon2023_tpu.audio.mel import mel_filters as j_fb
    np.testing.assert_array_equal(mel_filters(), j_fb())
    rs = np.random.RandomState(5)
    audio = (rs.randn(16000) * 0.1).astype(np.float32)
    out = log_mel_spectrogram(audio, device="cpu").numpy()
    np.testing.assert_allclose(out, j_mel(audio), atol=1e-5)


# -- (g) isolation and device choice --------------------------------------

def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import eddie_wang_hackathon2023_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "eddie_wang_hackathon2023_tpu"
               or m.startswith("eddie_wang_hackathon2023_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        assert len(names) > 25, names
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert res.returncode == 0 and res.stdout.startswith("ok"), (
        res.stdout + res.stderr)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from eddie_wang_hackathon2023_tpu_torch import default_device
    from eddie_wang_hackathon2023_tpu_torch.audio.mel import \
        log_mel_spectrogram
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        WhisperConfig, from_jax_state)
    from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import \
        calibrate_cross_kv_scales
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = np.zeros(1600, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            log_mel_spectrogram(audio, device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            from_jax_state({}, {}, {}, WhisperConfig(), device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate_cross_kv_scales({}, [], device=device)
    assert log_mel_spectrogram(audio, device="cpu").device.type == "cpu"
