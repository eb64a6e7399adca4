"""The rest of the port's Whisper pipeline against the JAX package on the
CPU, at the JAX pipeline tests' config (real vocabulary, d 64, 2+2 layers,
fp32), the weights carried across from one numpy state:

* ``detect_language``: the languages equal, the probabilities within 1e-5
  (batch 1 and 2, ``task="lang_id"``, the short cut with a language);
* greedy ``transcribe`` with ``language=None`` (detection, then the
  language slot of the prompt) token-exact;
* sampling (``temperature`` 0.7, with and without ``best_of=3``)
  token-exact when the port is handed the JAX noise: per sampled step
  ``rng, sub = jax.random.split(rng)`` from ``PRNGKey(seed)``, then
  ``jax.random.gumbel(sub, (rows, V))`` (``jax.random.categorical`` is
  ``argmax(logits + gumbel)``, held first); the port's own seeded noise
  repeats itself;
* ``transcribe_long``: the JAX test's fake-``transcribe`` case, 4 s of
  seeded noise end to end and a clip shorter than one window, segments,
  window count and text equal to the JAX package's;
* HF ``generate`` parity (no timestamps, the timestamp rules, batch 3),
  the cases of ``tests/test_hf_generate_parity.py``, on the port's own
  ``hf_to_openai_state_dict``;
* the options the JAX package refuses raise, the others are taken;
* ``chip_smoke.py``'s detect, long and best_of paths, rehearsed at a tiny
  size on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JConfig,
    WhisperDecoder as JDecoder, WhisperEncoder as JEncoder)
from eddie_wang_hackathon2023_tpu.models.whisper.pipeline import (
    DecodingOptions as JOptions, DecodingResult as JResult,
    WhisperPipeline as JPipeline)
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    BENCH_RECIPE, WhisperConfig, from_jax_state, hf_to_openai_state_dict)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.convert import (
    cross_kv_state_dict, decoder_state_dict, encoder_state_dict)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, DecodingResult, WhisperPipeline)
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

# tests/test_whisper_pipeline.py's config
DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=60, n_audio_state=64,
            n_audio_head=4, n_audio_layer=2, n_text_ctx=48, n_text_state=64,
            n_text_head=4, n_text_layer=2, dtype="float32")
JCFG = JConfig(**DIMS)
PCFG = WhisperConfig(**DIMS)
SAMPLE_LEN = 12
N_FRAMES = 2 * DIMS["n_audio_ctx"]


def _random_state(module, rs, scale=0.05):
    return {n: (rs.standard_normal(p._shape) * scale).astype(np.float32)
            for n, p in module.named_parameters()}


STATES = tuple(_random_state(m, np.random.RandomState(seed))
               for m, seed in ((JEncoder(JCFG), 10), (JDecoder(JCFG), 11),
                               (JCrossAttnKV(JCFG), 12)))
MELS = np.random.RandomState(13).randn(2, 80, N_FRAMES).astype(np.float32)


def _jax_pipeline(states=STATES, **options):
    enc, dec, ckv = JEncoder(JCFG), JDecoder(JCFG), JCrossAttnKV(JCFG)
    for m, sd in zip((enc, dec, ckv), states):
        m.load_state_dict(dict(sd))
    pipe = JPipeline(JCFG, enc, dec, ckv,
                     JOptions(sample_len=SAMPLE_LEN, **options))
    pipe.bind_params()
    return pipe


@pytest.fixture(scope="module")
def mods():
    return from_jax_state(*STATES, PCFG, device="cpu")


def _port_pipeline(mods, **options):
    return WhisperPipeline(PCFG, *mods,
                           DecodingOptions(sample_len=SAMPLE_LEN, **options))


def _same_results(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert out.tokens == [int(t) for t in ref.tokens], (out.tokens,
                                                            ref.tokens)
        assert out.language == ref.language
        assert out.text == ref.text
        assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3
        assert abs(out.no_speech_prob - ref.no_speech_prob) < 1e-5


# -- detection ---------------------------------------------------------------

@pytest.mark.parametrize("n_audio,options", [
    (1, dict()), (2, dict()), (2, dict(language="fr", task="lang_id"))])
def test_detect_language_matches_jax(mods, n_audio, options):
    jp = _jax_pipeline(**options)
    pp = _port_pipeline(mods, **options)
    mel = MELS[:n_audio]
    xa_j = jp.get_audio_features(mel)
    xa_p = pp.get_audio_features(mel)
    langs_j, probs_j = jp.detect_language(xa_j)
    langs_p, probs_p = pp.detect_language(xa_p)
    assert langs_p == langs_j and len(langs_p) == n_audio
    for pj, pp_ in zip(probs_j, probs_p):
        assert list(pp_) == list(pj) and len(pp_) == 99
        assert max(abs(pp_[c] - pj[c]) for c in pj) < 1e-5
        assert abs(sum(pp_.values()) - 1.0) < 1e-5
        # the detected language is the most probable one, by a margin
        # the tolerance cannot flip
        top = sorted(pp_.values())
        assert top[-1] - top[-2] > 2e-5


def test_detect_language_short_cut_with_a_language(mods):
    pp = _port_pipeline(mods, language="de")
    xa = pp.get_audio_features(MELS)
    assert pp.detect_language(xa) == (["de", "de"], None)
    assert _jax_pipeline(language="de").detect_language(
        np.asarray(xa)) == (["de", "de"], None)


@pytest.mark.parametrize("without_timestamps", [False, True])
def test_transcribe_with_detection_token_exact(mods, without_timestamps):
    """language=None: the detected language fills the prompt's slot."""
    jp = _jax_pipeline(without_timestamps=without_timestamps)
    pp = _port_pipeline(mods, without_timestamps=without_timestamps)
    assert pp.options.language is None
    refs = jp.transcribe(MELS)
    outs = pp.transcribe(MELS)
    _same_results(outs, refs)
    langs, _ = pp.detect_language(pp.get_audio_features(MELS))
    assert [o.language for o in outs] == langs


# -- sampling ----------------------------------------------------------------

def test_jax_categorical_is_argmax_of_logits_plus_gumbel():
    rs = np.random.RandomState(5)
    logits = jnp.asarray(rs.randn(4, 300).astype(np.float32) * 3)
    logits = logits.at[:, ::7].set(-jnp.inf)
    key = jax.random.PRNGKey(9)
    for _ in range(5):
        key, sub = jax.random.split(key)
        want = jax.random.categorical(sub, logits)
        got = jnp.argmax(logits + jax.random.gumbel(sub, logits.shape,
                                                     jnp.float32), axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_noise(seed):
    """The noise the JAX loop draws, one [rows, V] array a sampled step."""
    state = dict(rng=jax.random.PRNGKey(seed))

    def gumbel(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))
    return gumbel


@pytest.mark.parametrize("best_of,language,seed", [
    (None, "en", 0), (None, None, 3), (3, "en", 1), (3, None, 2)])
def test_sampling_token_exact_with_the_jax_noise(mods, best_of, language,
                                                  seed, monkeypatch):
    options = dict(temperature=0.7, best_of=best_of, language=language)
    jp = _jax_pipeline(**options)
    pp = _port_pipeline(mods, **options)
    assert pp.n_group == (best_of or 1) and pp.beam == 1
    monkeypatch.setattr(pp, "_gumbel", _jax_noise(seed))
    refs = jp.transcribe(MELS, seed=seed)
    outs = pp.transcribe(MELS, seed=seed)
    _same_results(outs, refs)
    assert all(o.temperature == 0.7 for o in outs)
    # the samples are not the greedy tokens
    greedy = _port_pipeline(mods, language=language).transcribe(MELS)
    assert [o.tokens for o in outs] != [g.tokens for g in greedy]


def test_sampling_repeats_with_the_same_seed(mods):
    """The port's own noise: a generator seeded from ``seed``."""
    pp = _port_pipeline(mods, language="en", temperature=1.0, best_of=2)
    runs = [[o.tokens for o in pp.transcribe(MELS, seed=s)]
            for s in (4, 4, 5)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    g = pp._gumbel((200, 1000))
    assert abs(float(g.mean()) - 0.5772) < 0.02       # Euler's constant
    assert bool(torch.isfinite(g).all())


# -- long-form transcription --------------------------------------------------

def _fake_transcribe(tok, calls, result_type):
    tsb = tok.timestamp_begin
    hello = tok.encode(" hello")

    def transcribe(mel, seed=0, **kw):
        calls.append(tuple(np.asarray(mel).shape))
        # window = 120 mel frames (1.2 s), 0.02 s a timestamp unit
        if len(calls) == 1:
            toks = ([tsb] + hello + [tsb + 24, tsb + 24] + hello
                    + [tsb + 40, tsb + 40])
        else:
            toks = [tsb] + hello + [tsb + 10]           # an open segment
        return [result_type(audio_features=None, language="en",
                            tokens=toks, text="hello")]
    return transcribe


def test_transcribe_long_sliding_window(mods, monkeypatch):
    """The JAX test's case: the first window seeks to its last pair (0.8
    s), the second consumes the rest; the same segments as JAX's."""
    audio = np.zeros(32000, np.float32)                # 2 s, 200 frames
    outs = []
    for pipe, result_type in ((_jax_pipeline(language="en"), JResult),
                              (_port_pipeline(mods, language="en"),
                               DecodingResult)):
        calls = []
        monkeypatch.setattr(pipe, "transcribe", _fake_transcribe(
            pipe.tokenizer, calls, result_type))
        outs.append((pipe.transcribe_long(audio), calls))
    (ref, ref_calls), (out, calls) = outs
    assert calls == ref_calls == [(1, 80, N_FRAMES)] * 2
    assert out == ref
    segs = out["segments"]
    assert segs[0]["start"] == 0.0 and abs(segs[0]["end"] - 0.48) < 1e-6
    assert abs(segs[1]["start"] - 0.48) < 1e-6
    assert abs(segs[1]["end"] - 0.80) < 1e-6
    assert abs(segs[2]["start"] - 0.80) < 1e-6
    assert out["language"] == "en" and "hello" in out["text"]


@pytest.mark.parametrize("seconds,language", [(4.0, None), (4.0, "en"),
                                              (0.5, None)])
def test_transcribe_long_matches_jax(mods, seconds, language, monkeypatch):
    """Seeded noise end to end (4 s: several windows; 0.5 s: shorter than
    one window, padded): the same windows, segments, text and language."""
    audio = (np.random.RandomState(21).randn(int(16000 * seconds))
             * 0.05).astype(np.float32)
    jp = _jax_pipeline(language=language)
    pp = _port_pipeline(mods, language=language)
    counts = []
    for pipe in (jp, pp):
        calls = []
        real = pipe.transcribe

        def counting(mel, seed=0, real=real, calls=calls, **kw):
            calls.append(int(np.asarray(mel).shape[-1]))
            return real(mel, seed=seed, **kw)
        monkeypatch.setattr(pipe, "transcribe", counting)
        counts.append(calls)
    ref = jp.transcribe_long(audio)
    out = pp.transcribe_long(audio)
    assert counts[1] == counts[0] and len(counts[1]) >= 1
    assert all(n == N_FRAMES for n in counts[1])
    if seconds < 1.2:
        assert len(counts[1]) == 1
    assert set(out) == {"text", "segments", "language"}
    assert out["language"] == ref["language"]
    assert out["text"] == ref["text"]
    assert len(out["segments"]) == len(ref["segments"])
    for s, r in zip(out["segments"], ref["segments"]):
        assert s == r


# -- HF generate parity (tests/test_hf_generate_parity.py's cases) -----------

EOT = 50257


@pytest.fixture(scope="module")
def hf_gen_model():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    torch.manual_seed(3)
    cfg = HFConfig(
        vocab_size=PCFG.n_vocab, num_mel_bins=PCFG.n_mels,
        encoder_layers=PCFG.n_audio_layer,
        encoder_attention_heads=PCFG.n_audio_head,
        decoder_layers=PCFG.n_text_layer,
        decoder_attention_heads=PCFG.n_text_head,
        d_model=PCFG.n_audio_state, decoder_ffn_dim=4 * PCFG.n_text_state,
        encoder_ffn_dim=4 * PCFG.n_audio_state,
        max_source_positions=PCFG.n_audio_ctx,
        max_target_positions=PCFG.n_text_ctx,
        activation_function="gelu", init_std=0.06,
        pad_token_id=EOT, bos_token_id=EOT, eos_token_id=EOT,
        decoder_start_token_id=50258)
    return WhisperForConditionalGeneration(cfg).eval()


def _hf_pipeline(hf_gen_model, without_timestamps):
    sd = hf_to_openai_state_dict(hf_gen_model.model.state_dict())
    mods = from_jax_state(encoder_state_dict(sd, PCFG),
                          decoder_state_dict(sd, PCFG),
                          cross_kv_state_dict(sd, PCFG), PCFG, device="cpu")
    return _port_pipeline(mods, language="en",
                          without_timestamps=without_timestamps)


def _hf_tokens(hf_gen_model, pipe, mel, **gen_kw):
    tok = pipe.tokenizer
    init = list(pipe.initial_tokens)
    with torch.no_grad():
        out = hf_gen_model.generate(
            input_features=torch.from_numpy(mel),
            decoder_input_ids=torch.tensor([init]),
            do_sample=False, num_beams=1, max_new_tokens=SAMPLE_LEN,
            suppress_tokens=list(pipe._get_suppress_tokens()),
            begin_suppress_tokens=tok.encode(" ") + [tok.eot],
            **gen_kw)
    got = [int(t) for t in out[0]]
    if got[:len(init)] == init:
        got = got[len(init):]
    if EOT in got:
        got = got[:got.index(EOT)]
    return got


@pytest.fixture(scope="module")
def hf_mel():
    return np.random.RandomState(11).randn(
        1, PCFG.n_mels, N_FRAMES).astype(np.float32) * 0.5


def test_hf_generate_parity_no_timestamps(hf_gen_model, hf_mel):
    pipe = _hf_pipeline(hf_gen_model, without_timestamps=True)
    ours = pipe.transcribe(hf_mel)[0].tokens
    hf = _hf_tokens(hf_gen_model, pipe, hf_mel, return_timestamps=False)
    assert ours == hf, (ours, hf)
    assert len(ours) > 0


def test_hf_generate_parity_with_timestamp_rules(hf_gen_model, hf_mel):
    pipe = _hf_pipeline(hf_gen_model, without_timestamps=False)
    tok = pipe.tokenizer
    gc = hf_gen_model.generation_config
    gc.no_timestamps_token_id = tok.no_timestamps
    gc.max_initial_timestamp_index = pipe.max_initial_timestamp_index
    gc.prev_sot_token_id = tok.sot_prev
    gc.decoder_start_token_id = tok.sot
    ours = pipe.transcribe(hf_mel)[0].tokens
    hf = _hf_tokens(hf_gen_model, pipe, hf_mel, return_timestamps=True)
    # as in the JAX test: HF may strip trailing timestamp pairs, so ours
    # must be a prefix of HF's, and nearly all of it
    assert ours == hf[:len(ours)], (ours, hf)
    assert len(ours) >= min(len(hf), SAMPLE_LEN) - 2
    assert any(t >= tok.timestamp_begin for t in ours)


def test_hf_generate_parity_batch3(hf_gen_model):
    pipe = _hf_pipeline(hf_gen_model, without_timestamps=True)
    mels = np.random.RandomState(5).randn(
        3, PCFG.n_mels, N_FRAMES).astype(np.float32) * 0.5
    ours = [r.tokens for r in pipe.transcribe(mels)]
    for i in range(3):
        hf = _hf_tokens(hf_gen_model, pipe, mels[i:i + 1],
                        return_timestamps=False)
        assert ours[i] == hf, (i, ours[i], hf)


# -- options ------------------------------------------------------------------

OPTION_CASES = {
    "beam_and_best_of": dict(beam_size=2, best_of=2, temperature=0.5),
    "greedy_best_of": dict(best_of=2),
    "patience_without_beam": dict(patience=2.0),
    "patience_not_one": dict(beam_size=2, patience=2.0),
    "sampling_patience": dict(temperature=0.5, patience=2.0),
    "language_none": dict(),
    "lang_id": dict(task="lang_id"),
    "sampling": dict(temperature=0.7),
    "best_of": dict(temperature=0.7, best_of=5),
    "best_of_no_language": dict(temperature=1.0, best_of=2,
                                task="translate"),
}


def _outcome(make):
    try:
        make()
    except (ValueError, NotImplementedError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_refused_only_where_jax_refuses(mods, case):
    opts = OPTION_CASES[case]
    j_out = _outcome(lambda: JPipeline(JCFG, JEncoder(JCFG), JDecoder(JCFG),
                                       JCrossAttnKV(JCFG), JOptions(**opts)))
    p_out = _outcome(lambda: WhisperPipeline(PCFG, *mods,
                                             DecodingOptions(**opts)))
    assert p_out == j_out
    refused = {"beam_and_best_of", "greedy_best_of", "patience_without_beam",
               "patience_not_one", "sampling_patience"}
    assert (p_out is not None) == (case in refused)


# -- chip_smoke.py's detect, long and best_of paths ---------------------------

def test_chip_smoke_long_paths_on_cpu(one_cpu_thread):  # noqa: F811
    """``chip_smoke.long_paths`` at a tiny size with head dim 64, as on the
    card, on the main path's model (the bench recipe, the megakernel's
    plain version): detection, 2.5 windows of seeded audio (3 windows of 3
    s), best_of 5 with two runs of one seed equal and the teacher-forced
    replay; no kernel is launched from CPU tensors."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = WhisperConfig(**{**DIMS, "n_audio_ctx": 150, "n_audio_state": 128,
                           "n_audio_head": 2, "n_text_state": 128,
                           "n_text_head": 2, "n_text_ctx": 96})
    built = smoke.build_whisper(torch, np, cfg, "cpu", BENCH_RECIPE, "main")
    long_e2e, counts, best_e2e, best_counts = smoke.long_paths(
        torch, np, built, device="cpu")
    assert long_e2e["windows"] == 3 and long_e2e["seconds"] == 7.5
    assert long_e2e["segments"] <= 3
    assert abs(long_e2e["detect_prob_sum"] - 1.0) < 1e-5
    assert len(long_e2e["detect_top3"]) == 3
    assert best_e2e["best_of"] == 5
    assert best_e2e["decode_steps"] == smoke.SAMPLE_LEN - 1
    assert best_e2e["logits_rel_err"] == 0.0
    for c in (counts, best_counts, long_e2e["detect_launches"]):
        assert c and not any(c.values())
