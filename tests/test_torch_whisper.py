"""The PyTorch port's Whisper path against the JAX package, at a tiny size
on the CPU: the same numpy state dicts (float, or quantised by the JAX
package's surgery) go through both, for the recipes ``none`` and
``woq8+ckv8+lmq8+sqenc`` (the bench recipe).

Tolerances: the float path is fp32 on both sides and agrees to 1e-5.
With the recipe, activations are quantised to int8 per token; a value
that lands within an fp32 ulp of a rounding tie may round one step apart
in the two frameworks, so those comparisons allow a few steps of one int8
quantum (stated per test).  Greedy transcription must be token-exact."""
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JConfig,
    WhisperDecoder as JDecoder, WhisperEncoder as JEncoder)
from eddie_wang_hackathon2023_tpu.models.whisper.model import (
    quantize_lm_head_state as j_quantize_lm_head_state)
from eddie_wang_hackathon2023_tpu.models.whisper.pipeline import (
    DecodingOptions as JOptions, WhisperPipeline as JPipeline)
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQuantMode
from eddie_wang_hackathon2023_tpu.quantization.surgery import (
    smooth_quantize as j_smooth_quantize,
    smooth_quantize_state_dict as j_smooth_quantize_state_dict,
    weight_only_quantize_state as j_weight_only_quantize_state)
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    BENCH_RECIPE, WhisperConfig, from_jax_state)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import (
    calibrate_cross_kv_scales)

# n_audio_ctx 150 >= 128: the encoder takes the pad-once flash path
# (150 -> 256 rows, keys masked by valid_len)
DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=150, n_audio_state=64,
            n_audio_head=4, n_audio_layer=2, n_text_ctx=48,
            n_text_state=64, n_text_head=4, n_text_layer=2, dtype="float32")
JCFG = JConfig(**DIMS)
PCFG = WhisperConfig(**DIMS)
SAMPLE_LEN = 12
RECIPES = ["none", BENCH_RECIPE]


def _random_state(module, rs, scale=0.05):
    """numpy normals for every declared parameter of a JAX module."""
    return {n: (rs.standard_normal(p._shape) * scale).astype(np.float32)
            for n, p in module.named_parameters()}


FLOAT_STATES = tuple(
    _random_state(m, np.random.RandomState(seed))
    for m, seed in ((JEncoder(JCFG), 0), (JDecoder(JCFG), 1),
                    (JCrossAttnKV(JCFG), 2)))
MEL = (np.random.RandomState(7).randn(1, 80, 2 * DIMS["n_audio_ctx"])
       .astype(np.float32))


def _jax_build(recipe, without_timestamps=False, kv_step=None, jcfg=JCFG,
               float_states=FLOAT_STATES, **options):
    """The JAX pipeline for ``recipe`` (and further ``DecodingOptions``),
    built as examples/whisper/wer_matrix.py builds it, and the quantised
    numpy state dicts it was loaded from; ``kv8`` with the per-layer self-KV
    steps ``kv_step``, another model with ``jcfg`` and its
    ``float_states``."""
    parts = set(recipe.split("+")) - {"none"}
    enc_sd, dec_sd, ckv_sd = (dict(s) for s in float_states)
    qmode = (JQuantMode.use_weight_only() if "woq8" in parts
             else JQuantMode(0))
    if "kv8" in parts:
        qmode = qmode.set_int8_kv_cache()
        t = np.asarray(kv_step, np.float32).reshape(-1, 1)
        dec_sd["blocks.attn.kv_orig_quant_scale"] = 1.0 / t
        dec_sd["blocks.attn.kv_quant_orig_scale"] = t
    sqenc = "sqenc" in parts
    enc = JEncoder(jcfg, JQuantMode(0) if sqenc else qmode)
    dec = JDecoder(jcfg, qmode, quantize_lm_head="lmq8" in parts)
    ckv8 = "ckv8" in parts
    ckv = JCrossAttnKV(jcfg, int8_output=ckv8, static_scale=ckv8)
    if qmode.is_weight_only():
        if not sqenc:
            enc, enc_sd = j_weight_only_quantize_state(enc, enc_sd, qmode)
        dec, dec_sd = j_weight_only_quantize_state(dec, dec_sd, qmode)
    if sqenc:
        sq = JQuantMode.use_smooth_quant(per_token=True, per_channel=True)
        enc = j_smooth_quantize(enc, sq)
        enc_sd = j_smooth_quantize_state_dict(enc, enc_sd, sq)
    if "lmq8" in parts:
        dec_sd = j_quantize_lm_head_state(dec_sd)
    enc.load_state_dict(enc_sd, strict=False)
    if ckv8:
        # static scales calibrated by the port on this encoder's output
        # (test_torch_ops holds them against the JAX calibration)
        xa = np.array(enc(MEL))
        ckv_sd["kv_scale"] = calibrate_cross_kv_scales(ckv_sd, [xa],
                                                       device="cpu")
    dec.load_state_dict(dec_sd, strict=False)
    ckv.load_state_dict(ckv_sd)
    pipe = JPipeline(jcfg, enc, dec, ckv,
                     JOptions(language="en", sample_len=SAMPLE_LEN,
                              without_timestamps=without_timestamps,
                              **options),
                     qmode)
    pipe.bind_params()
    return pipe, (enc_sd, dec_sd, ckv_sd)


@pytest.fixture(scope="module", params=RECIPES)
def built(request):
    recipe = request.param
    jpipe, states = _jax_build(recipe)
    mods = from_jax_state(*states, PCFG, recipe=recipe, device="cpu")
    return recipe, jpipe, mods


def _close(a, b, atol, rtol=0.0, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max()
    assert np.allclose(a, b, atol=atol, rtol=rtol), f"{what}: max err {err}"


@torch.inference_mode()
def test_encoder_matches_jax(built):
    recipe, jpipe, (enc, _, _) = built
    ref = np.asarray(jpipe.get_audio_features(MEL))
    out = enc(torch.from_numpy(MEL)).numpy()
    assert out.shape == ref.shape == (1, DIMS["n_audio_ctx"], 64)
    # LN output ~N(0,1); one int8 step of a per-token SmoothQuant input is
    # amax/127 ~ 0.03, and a rare one-step flip moves the output by far
    # less than that (measured 2.8e-4 here)
    _close(out, ref, atol=1e-5 if recipe == "none" else 2e-3, what="xa")
    if recipe != "none":
        assert np.abs(out - ref).mean() < 1e-4


@torch.inference_mode()
def test_cross_kv_matches_jax(built):
    recipe, jpipe, (_, _, ckv) = built
    xa = np.array(jpipe.get_audio_features(MEL))
    ref = jpipe.precompute_cross_kv(xa)
    out = ckv(torch.from_numpy(xa))
    if recipe == "none":
        _close(out.numpy(), np.asarray(ref), atol=1e-5, what="cross kv")
        assert out.shape == (2, 1, 2, 4, 16, DIMS["n_audio_ctx"])
        return
    q_ref, s_ref = (np.asarray(t) for t in ref)
    q_out, s_out = out
    np.testing.assert_array_equal(s_out.numpy(), s_ref)
    diff = np.abs(q_out.numpy().astype(int) - q_ref.astype(int))
    # same float inputs: only ties at fp32 rounding may land one step apart
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _jax_decoder_run(jpipe, tokens, cross, write_index, seq_len, cache=None):
    import jax.numpy as jnp
    dec = jpipe.decoder
    if cache is None:
        cache = dec.new_kv_cache(tokens.shape[0])
    logits, cache = dec.apply(jpipe._params_dec, jnp.asarray(tokens),
                              cache, cross, write_index,
                              jnp.full((tokens.shape[0],), seq_len,
                                       jnp.int32))
    return np.asarray(logits), cache


@torch.inference_mode()
def test_decoder_prefill_and_step_match_jax(built):
    """Prefill of the prompt, then two single-token steps (the
    deferred-write decode path), on the same cross K/V and tokens."""
    recipe, jpipe, (_, dec, _) = built
    xa = np.asarray(jpipe.get_audio_features(MEL))
    cross_j = jpipe.precompute_cross_kv(xa)
    cross_p = (tuple(torch.from_numpy(np.array(t)) for t in cross_j)
               if isinstance(cross_j, tuple)
               else torch.from_numpy(np.array(cross_j)))
    prompt = np.asarray([[50258, 50259, 50359]], np.int32)
    lj, cache_j = _jax_decoder_run(jpipe, prompt, cross_j, 0, 3)
    cache_p = dec.new_kv_cache(1)
    lp, cache_p = dec(torch.from_numpy(prompt).long(), cache_p, cross_p, 0, 3)
    _close(lp.numpy(), lj, atol=1e-4, what="prefill logits")
    _close(cache_p.numpy(), np.asarray(cache_j), atol=1e-5, what="cache")
    for step, tok in enumerate((50364, 440)):
        pos = 3 + step
        lj, cache_j = _jax_decoder_run(
            jpipe, np.asarray([[tok]], np.int32), cross_j, pos, pos + 1,
            cache=cache_j)
        lp, cache_p = dec(torch.tensor([[tok]]), cache_p, cross_p, pos,
                          pos + 1)
        assert lp.shape == (1, 1, DIMS["n_vocab"])
        _close(lp.numpy(), lj, atol=1e-4, what=f"step {step} logits")
        _close(cache_p.numpy(), np.asarray(cache_j), atol=1e-5,
               what=f"step {step} cache")


@pytest.mark.parametrize("recipe,without_timestamps,batch",
                         [(BENCH_RECIPE, False, 1), (BENCH_RECIPE, True, 1),
                          ("none", False, 1), (BENCH_RECIPE, False, 2)])
def test_transcribe_token_exact(recipe, without_timestamps, batch):
    """Batch 2 takes the batched cross-KV einsum and the unfused dense
    layers (the out-projection fuses at batch 1 only)."""
    mel = MEL
    if batch == 2:
        mel = np.concatenate([MEL, np.random.RandomState(8).randn(
            *MEL.shape).astype(np.float32)])
    jpipe, states = _jax_build(recipe, without_timestamps)
    refs = jpipe.transcribe(mel)
    mods = from_jax_state(*states, PCFG, recipe=recipe, device="cpu")
    pipe = WhisperPipeline(PCFG, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN,
        without_timestamps=without_timestamps))
    outs = pipe.transcribe(mel)
    assert len(outs) == len(refs) == batch
    for out, ref in zip(outs, refs):
        assert out.tokens == [int(t) for t in ref.tokens], (out.tokens,
                                                            ref.tokens)
        assert out.text == ref.text
        assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3
        assert abs(out.no_speech_prob - ref.no_speech_prob) < 1e-5


@pytest.fixture
def one_cpu_thread():
    """One intra-op thread for a rehearsal of thousands of tiny ops: under
    the test runner's parallel workers, several threads per op oversubscribe
    the cores and slow such a test some twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_main_path_on_cpu(one_cpu_thread, monkeypatch):
    """``chip_smoke.py``'s paths, rehearsed on the CPU at a tiny size
    with head dim 64 as on the card (the decoder path cut to 2 layers of
    width 256, vocab 97; the serve path is rehearsed on its own in
    ``test_torch_serving.py``, the custom path in
    ``test_torch_custom_kernel.py``, the probes path in
    ``test_torch_megakernel_probes.py``, the kv8 paths in
    ``test_torch_kv8.py`` and the detect, long and best_of paths in
    ``test_torch_whisper_pipeline.py``, the gen_beam path in
    ``test_torch_generation.py`` and the llama paths in
    ``test_torch_llama_megakernel.py``, the santacoder paths in
    ``test_torch_mqa_megakernel.py`` and the bloom and chatglm paths in
    ``test_torch_families_b.py``, the serve_modes path in
    ``test_torch_serving_modes.py``, the woq4, float and woq4_scanned paths
    in ``test_torch_whisper_woq4.py``, the fp8 path in
    ``test_torch_fp8.py``, and all fifteen are stubbed here; the
    fp8_scanned and decoder_fp8 paths run):
    model
    builds (the bench recipe with the megakernel decode; the recipe without
    sqenc on the scanned and beam paths), transcription (greedy, and beam
    search with 5 beams), the teacher-forced replay against the plain scanned path (exact on the
    scanned and beam paths; the megakernel's plain version sums in another
    order) and the end-to-end timing.  No kernel is launched from CPU
    tensors, and the beam path does not take the megakernel it asks for."""
    import dataclasses
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = WhisperConfig(**{**DIMS, "n_audio_state": 128, "n_audio_head": 2,
                           "n_text_state": 128, "n_text_head": 2,
                           "n_text_ctx": 96})
    results = {}
    dec_cfg = dataclasses.replace(
        smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128)
    monkeypatch.setattr(smoke, "serve_path", lambda *a, **k: (
        {}, {"paged_decode_attention": 0}))
    monkeypatch.setattr(smoke, "serve_modes_path", lambda *a, **k: (
        {}, {"serve_paged_mixed": {"paged_window_attention": 0},
             "serve_paged_beam": {"paged_beam_attention": 0},
             "serve_dense_beam": {"beam_decode_attention": 0},
             "serve_paged_fp8": {"paged_decode_attention_e4m3": 0},
             "serve_paged_fp8_mixed": {"paged_window_attention_e4m3": 0},
             "serve_paged_fp8_beam": {"paged_beam_attention_e4m3": 0},
             "serve_dense_fp8_beam": {"beam_decode_attention_e4m3": 0}}))
    monkeypatch.setattr(smoke, "custom_path", lambda *a, **k: (
        {}, {"flash_attention_causal": 0, "custom_fmha": 0,
             "custom_fmha_f32": 0}))
    monkeypatch.setattr(smoke, "probes_path", lambda *a, **k: (
        {}, {"probe_flat_gemv": 0, "probe_hm_gemv": 0, "probe_relayout": 0,
             "probe_pair_proj": 0}))
    monkeypatch.setattr(smoke, "kv8_paths", lambda *a, **k: (
        {"self_kv_amax": [1.0]}, {"decoder_megakernel": 0}, {},
        {"decode_attention_int8": 0}))
    monkeypatch.setattr(smoke, "fp8_path", lambda *a, **k: (
        {}, {"decoder_megakernel": 0}))
    monkeypatch.setattr(smoke, "whisper_variant_paths", lambda *a, **k: (
        {}, {"woq4": {"decoder_megakernel": 0},
             "float": {"decoder_megakernel": 0}}))
    monkeypatch.setattr(smoke, "woq4_scanned_path", lambda *a, **k: (
        {}, {"int4_quant_matmul": 0}))
    monkeypatch.setattr(smoke, "long_paths", lambda *a, **k: ({}, {}, {},
                                                               {}))
    monkeypatch.setattr(smoke, "gen_beam_path", lambda *a, **k: (
        {}, {"beam_decode_attention": 0}))
    monkeypatch.setattr(smoke, "llama_path", lambda *a, **k: (
        {}, {"llama": {"decoder_megakernel": 0},
             "llama_woq8": {"decoder_megakernel": 0},
             "llama_fp8": {"decoder_megakernel": 0},
             "llama_b8": {"decode_attention_bf16": 0}}))
    monkeypatch.setattr(smoke, "santacoder_path", lambda *a, **k: (
        {}, {"santacoder": {"decoder_megakernel": 0},
             "santacoder_woq8": {"decoder_megakernel": 0}}))
    monkeypatch.setattr(smoke, "bloom_path", lambda *a, **k: (
        {}, {"decoder_megakernel": 0}))
    monkeypatch.setattr(smoke, "chatglm_path", lambda *a, **k: (
        {}, {"decode_attention_bf16": 0}))
    e2e = smoke.paths(torch, np, results, config=cfg, device="cpu",
                      decoder_config=dec_cfg)
    assert {k: v["launches"] for k, v in results.items()} == {
        k: 0 for k in smoke.KERNELS}
    assert e2e["main"]["megakernel"] and not e2e["scanned"]["megakernel"]
    assert not e2e["beam"]["megakernel"] and e2e["beam"]["beam"] == 5
    assert e2e["main"]["logits_rel_err"] < 1e-5
    assert e2e["scanned"]["logits_rel_err"] == 0.0
    assert e2e["beam"]["logits_rel_err"] == 0.0
    assert e2e["beam"]["slope_ms_per_token"] is None
    for path in ("main", "scanned", "beam"):
        assert e2e[path]["encoder_block_rms_rel_err"] == 0.0
        assert e2e[path]["utt_per_s"] > 0
    assert e2e["decoder"]["logits_rel_err"] == 0.0
