"""The port's ``GenerationSession`` with sampling and beam search against
the JAX package's on the CPU, on tiny fp32 decoders built from one numpy
state on both sides (``test_torch_decoder._models``).

* sampling (every knob of ``SamplingConfig`` but ``num_beams``: the
  temperature, top-k, top-p, both penalties, min-length, bad and stop
  words, scalar and per row) token-exact with the JAX session, the port's
  noise replaced by the JAX loop's (``gumbel(sub, (rows, V))`` with
  ``rng, sub = split(rng)`` from ``PRNGKey(seed)`` each step), ragged
  left-padded prompts, an equal-heads and the MQA model, float and
  ``woq8``: lengths exact, cum log-probs within 1e-5;
* beam search at 3 and 4 beams token-exact with the JAX session's XLA
  path and its ``_beam_kernel`` path in interpret mode
  (``EWT_PALLAS_DECODE=1``), length penalties 1.0, 0.0 and 0.6, stop
  words and a repetition penalty, in indirection and gather modes, with
  ``best_sequences`` equal to JAX's;
* beams over MQA/GQA caches raise on both sides (the JAX package's
  ``TypeError``, the port's ``NotImplementedError``);
* a CPU rehearsal of ``chip_smoke.py``'s ``gen_beam`` path and of the
  decoder path's sampled run."""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig)
from test_torch_decoder import GQA, MQA, _jax_noise, _models
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

MHA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=4, max_position_embeddings=64)      # 4 heads of 32
FAMILIES = dict(mha=MHA, mqa=MQA, gqa=GQA)
IDS = np.random.RandomState(4).randint(0, 96, (3, 5)).astype(np.int32)
LENS = np.asarray([5, 2, 4], np.int32)
NEW = 10


def _mc(kw):
    return dict(vocab_size=kw["vocab_size"], num_layers=kw["num_layers"],
                num_heads=kw["num_heads"], hidden_size=kw["hidden_size"],
                max_seq_len=kw["max_position_embeddings"],
                num_kv_heads=kw["num_kv_heads"])


def _sessions(family, woq, sc, pallas="0", monkeypatch=None, seed=2, **kw):
    """(JAX session, port session) on one model; the JAX decode path
    chosen by ``EWT_PALLAS_DECODE`` before its first trace."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    monkeypatch.setenv("EWT_PALLAS_DECODE", pallas)
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    jax.clear_caches()
    cfg = FAMILIES[family]
    jm, pm, _ = _models(cfg, woq, seed=seed)
    js = JSession(JMC(**_mc(cfg)), jm, JSampling(**dataclasses.asdict(sc)),
                  **kw)
    ps = GenerationSession(ModelConfig(**_mc(cfg)), pm, sc, **kw)
    return js, ps


def _decode_both(js, ps, seed, **kw):
    ps._gumbel = _jax_noise(seed)
    out = ps.decode(IDS, LENS, max_new_tokens=NEW, seed=seed, **kw)
    ref = js.decode(IDS, LENS, max_new_tokens=NEW, seed=seed, **kw)
    return out, ref


def _assert_same(out, ref):
    (pt, pl, pc), (jt, jl, jc) = out, ref
    assert pt.shape == jt.shape
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-5)


# -- sampling -----------------------------------------------------------------

SCALAR = dict(temperature=0.8, top_k=6, top_p=0.9, repetition_penalty=1.3,
              presence_penalty=0.4, min_length=3)
PER_ROW = dict(temperature=[0.0, 0.7, 1.1], top_k=[0, 4, 40],
               top_p=[0.9, 0.0, 0.95], repetition_penalty=[1.0, 1.4, 0.8],
               presence_penalty=[0.0, 0.5, -0.2], min_length=[0, 3, 6])


@pytest.mark.parametrize("knobs", ["scalar", "per_row"])
@pytest.mark.parametrize("woq", [False, True], ids=["float", "woq8"])
@pytest.mark.parametrize("family", ["mha", "mqa"])
def test_sampling_token_exact_with_jax(family, woq, knobs, monkeypatch,
                                       one_cpu_thread):  # noqa: F811
    """Ten sampled tokens for three ragged prompts.  The words come from
    earlier runs, so that they bite: from a run without words, a bad word
    of two tokens that row 1 generated (its last token is then banned
    after the first), one of a token row 2 generated and the end id (a
    token row 2 generated, held back by min_length where it is set); from
    a run with those, a stop word of two tokens that row 0 generated (it
    finishes there) and one of a single token."""
    seed = 7
    base = SamplingConfig(end_id=-1, pad_id=96,
                          **(SCALAR if knobs == "scalar" else PER_ROW))
    js, ps = _sessions(family, woq, base, monkeypatch=monkeypatch)

    def generated(sc):
        ps._gumbel = _jax_noise(seed)
        return ps.decode(IDS, LENS, sc, max_new_tokens=NEW, seed=seed)[0]

    free = generated(base)
    gen = free[:, 0, 5:]
    sc = dataclasses.replace(
        base, end_id=int(gen[2, 6]),
        bad_words_list=[[int(gen[1, 2]), int(gen[1, 3])], [int(gen[2, 1])]])
    gen = generated(sc)[:, 0, 5:]
    sc = dataclasses.replace(sc, stop_words_list=[
        [int(gen[0, 4]), int(gen[0, 5])], [int(gen[1, 8])]])
    out, ref = _decode_both(js, ps, seed, sampling_config=sc)
    _assert_same(out, ref)
    assert out[1][0, 0] <= 5 + 6                    # row 0 stopped
    assert not np.array_equal(out[0], free)


def test_sampling_rows_that_are_greedy_match_the_greedy_session(
        monkeypatch, one_cpu_thread):  # noqa: F811
    """Greedy rows of a mixed call (temperature 0) take the greedy tokens;
    the same seed twice gives the same tokens with the port's own noise."""
    _, ps = _sessions("mha", False, SamplingConfig(end_id=-1, pad_id=96),
                      monkeypatch=monkeypatch)
    greedy, _, _ = ps.decode(IDS, LENS, max_new_tokens=NEW)
    mixed = SamplingConfig(end_id=-1, pad_id=96, temperature=[0.0, 1.0, 1.0],
                           top_k=[1, 0, 20], top_p=[0.0, 0.9, 0.0])
    a = ps.decode(IDS, LENS, mixed, max_new_tokens=NEW, seed=3)[0]
    b = ps.decode(IDS, LENS, mixed, max_new_tokens=NEW, seed=3)[0]
    c = ps.decode(IDS, LENS, mixed, max_new_tokens=NEW, seed=4)[0]
    np.testing.assert_array_equal(a[0], greedy[0])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# -- beams ----------------------------------------------------------------------

BEAMS = [(3, 1.0, {}), (4, 0.6, dict(repetition_penalty=1.3)),
         (4, 0.0, dict(stop_words_list="stop"))]


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "beam_kernel"])
@pytest.mark.parametrize("beam,lp,extra", BEAMS,
                         ids=["b3", "b4_lp0.6_rep", "b4_lp0_stop"])
def test_beams_token_exact_with_jax(beam, lp, extra, pallas, monkeypatch,
                                    one_cpu_thread):  # noqa: F811
    """Beam search over the ragged prompts (the end id one a beam
    generates, so that beams finish), against the JAX session's XLA
    formulation or its ``_beam_kernel`` in interpret mode; the port in
    indirection mode and in gather mode; ``best_sequences`` as JAX's."""
    sc = SamplingConfig(end_id=-1, pad_id=96, num_beams=beam,
                        length_penalty=lp,
                        **{k: v for k, v in extra.items()
                           if k != "stop_words_list"})
    js, ps = _sessions("mha", False, sc, pallas, monkeypatch)
    free, _, _ = ps.decode(IDS, LENS, max_new_tokens=NEW)
    gen = free[:, :, 5:]
    sc = dataclasses.replace(sc, end_id=int(gen[0, 1, 3]))
    if extra.get("stop_words_list"):
        sc = dataclasses.replace(sc, stop_words_list=[
            [int(gen[1, 0, 2]), int(gen[1, 0, 3])], [int(gen[2, 2, 5])]])
    out, ref = _decode_both(js, ps, 0, sampling_config=sc)
    _assert_same(out, ref)
    assert out[0].shape == (3, beam, 5 + NEW) and out[1].min() < 5 + NEW
    best, best_ref = ps.best_sequences(*out), js.best_sequences(*ref)
    for a, b in zip(best, best_ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    gathered = GenerationSession(ps.model_config, ps.model, sc,
                                 use_cache_indirection=False).decode(
        IDS, LENS, max_new_tokens=NEW)
    np.testing.assert_array_equal(gathered[0], out[0])
    np.testing.assert_array_equal(gathered[1], out[1])
    np.testing.assert_allclose(gathered[2], out[2], rtol=1e-6, atol=1e-6)


def test_a_reused_session_reads_the_new_end_id(monkeypatch,
                                               one_cpu_thread):  # noqa: F811
    """The JAX session bakes ``sampling_config.end_id`` into its beam
    program at the first trace (``beam_search_step(..., sc.end_id, ...)``,
    JAX ``runtime/generation.py:204-206``; the jit is keyed by its
    arguments only), so a session reused with another end id under beams
    freezes its beams on the old one.  The port reads the config at every
    call: reused, it equals a fresh JAX session."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    first = SamplingConfig(end_id=-1, pad_id=96, num_beams=3)
    js, ps = _sessions("mha", False, first, monkeypatch=monkeypatch)
    free, _, _ = js.decode(IDS, LENS, max_new_tokens=NEW)
    ps.decode(IDS, LENS, max_new_tokens=NEW)
    sc = dataclasses.replace(first, end_id=int(free[0, 1, 5 + 3]))
    stale = js.decode(IDS, LENS, JSampling(**dataclasses.asdict(sc)),
                      max_new_tokens=NEW)
    fresh = JSession(js.model_config, js.model, JSampling(
        **dataclasses.asdict(sc))).decode(IDS, LENS, max_new_tokens=NEW)
    assert not np.array_equal(stale[1], fresh[1])
    _assert_same(ps.decode(IDS, LENS, sc, max_new_tokens=NEW), fresh)


@pytest.mark.parametrize("family", ["mqa", "gqa"])
def test_beams_over_mqa_gqa_raise_on_both_sides(family, monkeypatch):
    """The JAX package's XLA beam attention reshapes the cache with the
    query head count (``ops/attention.py:440-441``), a ``TypeError``; the
    port refuses such beams with ``NotImplementedError``."""
    sc = SamplingConfig(end_id=-1, pad_id=96, num_beams=2)
    js, ps = _sessions(family, False, sc, monkeypatch=monkeypatch)
    with pytest.raises(TypeError, match="reshape"):
        js.decode(IDS, LENS, max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="MQA/GQA"):
        ps.decode(IDS, LENS, max_new_tokens=4)


def test_unbucketed_prompts_and_the_cache_width(monkeypatch):
    """``bucket_prompts=False`` keeps the prompt at its length, and the
    cache's S is rounded up to a multiple of 4 (5 + 10 -> 16 here): the
    tokens equal the JAX session's with the same switch."""
    sc = SamplingConfig(end_id=-1, pad_id=96, num_beams=3)
    js, ps = _sessions("mha", False, sc, monkeypatch=monkeypatch,
                       bucket_prompts=False)
    widths = []
    new = ps.model.new_kv_cache
    monkeypatch.setattr(ps.model, "new_kv_cache", lambda b, s=None: (
        widths.append(s), new(b, s))[1])
    out, ref = _decode_both(js, ps, 0)
    _assert_same(out, ref)
    assert widths == [16]


# -- chip_smoke's paths, rehearsed ------------------------------------------

def _smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_gen_beam_path_on_cpu(one_cpu_thread):  # noqa: F811
    """``chip_smoke.py``'s gen_beam path at 2 layers of width 128 (head dim
    64 as GPT-350M's, vocab 97, 64 positions), a prompt of 40 tokens and
    4 beams: it builds, decodes 3 and 6 new tokens in both of
    ``beam_bench.py``'s modes (indirection and gather), launches no kernel
    from CPU tensors, and its teacher-forced replay through the plain path
    is exact (on the CPU both are the plain version).  The last step's
    table points every beam at row 0 over the prompt's columns."""
    smoke = _smoke()
    config = dataclasses.replace(
        smoke.gpt_350m_beam_config(), vocab_size=97, hidden_size=128,
        num_layers=2, num_heads=2, num_kv_heads=2,
        max_position_embeddings=64)
    e2e, counts = smoke.gen_beam_path(torch, np, config=config,
                                      device="cpu", prompt_len=40,
                                      new_tokens=(3, 6))
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0
    assert e2e["beam"] == 4 and e2e["cache_columns"] == 48 + 8
    assert e2e["marginal_ms_per_token"] is not None
    g = e2e["gather"]
    assert g["launches"] == {} and g["marginal_ms_per_token"] is not None
    assert g["tokens_equal_share"] == 1.0
    # the last step reads the prompt's 40 columns, each at one row, and
    # the 4 generated before its own, each at one to four rows
    pairs = round(e2e["table_pair_share"] * 4 * 44)
    assert 40 + 4 <= pairs <= 40 + 4 * 4


def test_chip_smoke_sampled_run_on_cpu(one_cpu_thread):  # noqa: F811
    """The decoder path's sampled run at a tiny size: the greedy rows equal
    the greedy call's tokens, one seed twice the same tokens, no banned
    word, rows stop at their stop word, and the replay is exact."""
    smoke = _smoke()
    config = dataclasses.replace(
        smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128)
    e2e, counts = smoke.decoder_path(torch, np, config=config, device="cpu",
                                     sampled=True)
    assert set(counts.values()) == {0}
    s = e2e["sampled"]
    assert s["logits_rel_err"] == 0.0 and s["greedy_rows_equal"]
    assert s["repeatable"] and s["stopped_rows"] >= 1
