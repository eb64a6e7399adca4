"""The port's beam search against the JAX package on the CPU, with the same
numpy-seeded inputs on both sides:

* the beam step, ``gather_beams``, ``update_indirection`` and
  ``finalize_beams``: integers bit-equal, fp32 scores exactly equal
  (finished beams, a length penalty, per-row end ids and cursors, and
  constructed ties, where the lower flat index must win as in
  ``jax.lax.top_k``);
* the plain beam attention (``plain_beam_decode_attention``) against the
  JAX XLA formulation ``beam_indirect_decode_attention`` and the Pallas
  ``_beam_kernel`` in interpret mode, fp32, rtol/atol 2e-5 (the JAX
  package's own tolerance for that kernel, tests/test_pallas_decode.py);
* Whisper beam transcription token-exact against the JAX pipeline, with
  avg_logprob within 1e-3 as in test_torch_whisper.py;
* the pipeline's option errors match the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.ops.attention import (
    beam_indirect_decode_attention as j_beam_attention, layer_kv_views)
from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import (
    fused_decode_attention as j_fused)
from eddie_wang_hackathon2023_tpu.runtime import sampling as js
from eddie_wang_hackathon2023_tpu_torch.models.whisper import from_jax_state
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops.attention import (
    beam_indirect_decode_attention as p_beam_attention,
    layer_kv_views as p_layer_kv_views)
from eddie_wang_hackathon2023_tpu_torch.runtime import sampling as ps
from test_torch_whisper import MEL, PCFG, SAMPLE_LEN, _jax_build

BEAM_RECIPE = "woq8+ckv8+lmq8"


def _t(x):
    return torch.from_numpy(np.array(x))


# -- (a) the beam step and the indirection table ---------------------------

def _logprobs(rs, shape, ties=False):
    x = (rs.randint(0, 3, shape) if ties else rs.randn(*shape)) \
        .astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True)).astype(np.float32)


STEP_CASES = {
    "plain": dict(),
    "finished": dict(finished=True),
    "length_penalty": dict(finished=True, length_penalty=0.6, cur_len=7),
    "end_per_row": dict(finished=True, end_per_row=True),
    # logits from {0, 1, 2} and equal cumulative scores: many exact ties
    "ties": dict(ties=True),
    "ties_length_penalty": dict(ties=True, length_penalty=1.4, cur_len=3),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_beam_search_step_matches_jax(case):
    c = STEP_CASES[case]
    rs = np.random.RandomState(sorted(STEP_CASES).index(case))
    B, K, V = 3, 4, 40
    lp = _logprobs(rs, (B, K, V), c.get("ties", False))
    cum = (np.zeros((B, K)) if c.get("ties") else rs.randn(B, K) * 3) \
        .astype(np.float32)
    fin = (rs.rand(B, K) < 0.4) if c.get("finished") else np.zeros(
        (B, K), bool)
    end = (np.asarray([5, 7, 11], np.int32) if c.get("end_per_row")
           else 7)
    kw = {k: c[k] for k in ("length_penalty", "cur_len") if k in c}
    ref = js.beam_search_step(jnp.asarray(lp), jnp.asarray(cum),
                              jnp.asarray(fin), K,
                              jnp.asarray(end) if c.get("end_per_row")
                              else end, **kw)
    out = ps.beam_search_step(_t(lp), _t(cum), _t(fin), K,
                              _t(end) if c.get("end_per_row") else end, **kw)
    for name, o, r in zip(("parent", "token", "score", "finished"), out,
                          ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                      err_msg=name)
    if c.get("ties"):
        # the ties are real: some chosen scores repeat within a row
        assert any(len(set(row)) < K for row in out[2].tolist())


def test_beam_search_step_ties_take_the_lower_index():
    """Every candidate equal: the k lowest flat indices, in order."""
    lp = torch.zeros(1, 3, 5)
    parent, token, score, _ = ps.beam_search_step(lp, torch.zeros(1, 3),
                                                  torch.zeros(1, 3,
                                                              dtype=bool),
                                                  3, 4)
    assert parent.tolist() == [[0, 0, 0]] and token.tolist() == [[0, 1, 2]]


def test_gather_beams_and_update_indirection_match_jax():
    rs = np.random.RandomState(11)
    B, K, T, S = 2, 3, 9, 16
    tree = dict(tokens=rs.randint(0, 100, (B, K, T)).astype(np.int32),
                last_ts=rs.randint(0, 9, (B, K)).astype(np.int32),
                has_ts=rs.rand(B, K) < 0.5)
    parent = rs.randint(0, K, (B, K)).astype(np.int32)
    ref = js.gather_beams({k: jnp.asarray(v) for k, v in tree.items()},
                          jnp.asarray(parent))
    out = ps.gather_beams({k: _t(v) for k, v in tree.items()}, _t(parent))
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    ind = rs.randint(0, K, (B, K, S)).astype(np.int32)
    for cur in (5, np.asarray([3, 12], np.int32)):
        ref = js.update_indirection(jnp.asarray(ind), jnp.asarray(parent),
                                    jnp.asarray(cur))
        out = ps.update_indirection(_t(ind), _t(parent), _t(cur))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_finalize_beams_matches_jax(length_penalty):
    rs = np.random.RandomState(13)
    B, K, T = 3, 4, 6
    tokens = rs.randint(0, 100, (B, K, T)).astype(np.int32)
    cum = (rs.randn(B, K) * 4).astype(np.float32)
    cum[2] = -2.0                     # a row of ties: the first beam wins
    lengths = rs.randint(1, T, (B, K)).astype(np.int32)
    lengths[2] = 3
    ref_t, ref_b = js.finalize_beams(jnp.asarray(tokens), jnp.asarray(cum),
                                     jnp.asarray(lengths), length_penalty)
    out_t, out_b = ps.finalize_beams(_t(tokens), _t(cum), _t(lengths),
                                     length_penalty)
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(ref_t))
    assert int(out_b[2]) == 0


# -- (b) beam attention: the plain version vs the JAX formulations ---------

ATTN_CASES = {
    # one group, fp32 cache, several chunks of the Pallas kernel
    "f32_one_group": dict(cache="f32", groups=1, bw=4, start=False,
                          s_ind=32),
    # int8 cache with its scale, two groups, a start index
    "int8_two_groups_start": dict(cache="int8", groups=2, bw=3, start=True,
                                  s_ind=32),
    # a table narrower than S (padded), fp32, two groups
    "f32_short_table": dict(cache="f32", groups=2, bw=2, start=False,
                            s_ind=16),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_beam_attention_matches_jax(case):
    c = ATTN_CASES[case]
    rs = np.random.RandomState(20 + sorted(ATTN_CASES).index(case))
    L, H, D, S = 3, 4, 8, 32
    G, BW = c["groups"], c["bw"]
    B = G * BW
    cache = rs.randn(L, B, 2, H, D, S).astype(np.float32)
    fkv = rs.randn(2, B, H, D, 1).astype(np.float32)
    kscale = None
    if c["cache"] == "int8":
        cache = np.clip(np.round(cache * 20), -127, 127).astype(np.int8)
        fkv = np.clip(np.round(fkv * 20), -127, 127).astype(np.int8)
        kscale = np.asarray(0.05, np.float32)
    q = rs.randn(B, H, 1, D).astype(np.float32)
    seq_g = rs.randint(4, min(S, c["s_ind"]), (G,))
    seq = np.repeat(seq_g, BW).astype(np.int32)     # group-uniform lengths
    start = (np.repeat(rs.randint(0, 3, (G,)), BW).astype(np.int32)
             if c["start"] else None)
    ind = rs.randint(0, BW, (G, BW, c["s_ind"])).astype(np.int32)
    scale = D ** -0.5
    layer = 1
    jk = dict(kv_quant_orig_scale=None if kscale is None else
              jnp.asarray(kscale),
              start_index=None if start is None else jnp.asarray(start))
    pk = dict(kv_quant_orig_scale=None if kscale is None else _t(kscale),
              start_index=None if start is None else _t(start))
    fresh_j = (jnp.asarray(fkv[0]), jnp.asarray(fkv[1]))
    fresh_p = (_t(fkv[0]), _t(fkv[1]))
    ref_xla = j_beam_attention(jnp.asarray(q), layer_kv_views(
        jnp.asarray(cache), layer), jnp.asarray(seq), jnp.asarray(ind),
        scale=scale, fresh_kv=fresh_j, **jk)
    ref_kernel = j_fused(jnp.asarray(cache), layer, jnp.asarray(q),
                         jnp.asarray(seq), scale, fresh_kv=fresh_j,
                         beam_indirection=jnp.asarray(ind), chunk=8,
                         interpret=True, **jk)
    out = pdec.plain_beam_decode_attention(
        _t(cache), layer, _t(q), _t(seq), scale, fresh_kv=fresh_p,
        beam_indirection=_t(ind), **pk)
    before = dict(pdec.launches)
    out_entry = pdec.fused_decode_attention(
        _t(cache), layer, _t(q), _t(seq), scale, fresh_kv=fresh_p,
        beam_indirection=_t(ind), **pk)
    assert pdec.launches == before      # CPU tensors: no kernel launch
    assert out.shape == (B, H, 1, D)
    torch.testing.assert_close(out_entry, out, rtol=0, atol=0)
    for ref in (ref_xla, ref_kernel):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    # the XLA formulation's cached-only mode (no fresh K/V) as well
    ref = j_beam_attention(jnp.asarray(q), layer_kv_views(
        jnp.asarray(cache), layer), jnp.asarray(seq), jnp.asarray(ind),
        scale=scale, **jk)
    out = p_beam_attention(
        _t(q), p_layer_kv_views(_t(cache), layer), _t(seq), _t(ind),
        scale=scale, **pk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_beam_attention_refuses_what_is_not_ported():
    cache = torch.zeros(1, 2, 2, 2, 8, 8)
    q = torch.zeros(2, 2, 1, 8)
    fresh = (torch.zeros(2, 2, 8, 1),) * 2
    ind = torch.zeros(1, 2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):               # fresh K/V required
        pdec.fused_decode_attention(cache, 0, q, 4, 0.25,
                                    beam_indirection=ind)
    with pytest.raises(ValueError):               # no out-projection
        pdec.fused_decode_attention(cache, 0, q, 4, 0.25, fresh_kv=fresh,
                                    proj=(torch.zeros(16, 16), None, None),
                                    beam_indirection=ind)
    with pytest.raises(NotImplementedError):      # the K-step tail
        pdec.fused_decode_attention(cache, 0, q, 4, 0.25, fresh_kv=fresh,
                                    tail_kv=(cache, 0), beam_indirection=ind)
    with pytest.raises(NotImplementedError):      # GQA: 4 query heads
        pdec.fused_decode_attention(cache, 0, q.repeat(1, 2, 1, 1), 4, 0.25,
                                    fresh_kv=fresh, beam_indirection=ind)
    # an fp8 (e4m3) cache is ported: the beam read of e4m3 values equals
    # the read of the same values in fp32
    fp8 = torch.float8_e4m3fn
    g = torch.Generator().manual_seed(0)
    c8, f8 = (torch.randn(t.shape, generator=g).to(fp8)
              for t in (cache, fresh[0]))
    out = pdec.fused_decode_attention(c8, 0, q + 1, 4, 0.25,
                                      kv_quant_orig_scale=torch.tensor(1.0),
                                      fresh_kv=(f8, f8), beam_indirection=ind)
    ref = pdec.fused_decode_attention(c8.float(), 0, q + 1, 4, 0.25,
                                      fresh_kv=(f8.float(),) * 2,
                                      beam_indirection=ind)
    assert torch.isfinite(out).all() and torch.equal(out, ref)


# -- (c) the Whisper beam pipeline, token-exact ----------------------------

@pytest.mark.parametrize(
    "recipe,beam,without_timestamps,n_audio",
    [(r, b, w, 1) for r in ("none", BEAM_RECIPE) for b in (3, 5)
     for w in (False, True)]
    + [(BEAM_RECIPE, 5, False, 2), ("none", 1, False, 1)])
def test_beam_transcribe_token_exact(recipe, beam, without_timestamps,
                                     n_audio):
    """beam_size 1 is greedy, as in the JAX package."""
    mel = MEL
    if n_audio == 2:
        mel = np.concatenate([MEL, np.random.RandomState(8).randn(
            *MEL.shape).astype(np.float32)])
    jpipe, states = _jax_build(recipe, without_timestamps, beam_size=beam)
    refs = jpipe.transcribe(mel)
    mods = from_jax_state(*states, PCFG, recipe=recipe, device="cpu")
    pipe = WhisperPipeline(PCFG, *mods, DecodingOptions(
        language="en", sample_len=SAMPLE_LEN,
        without_timestamps=without_timestamps, beam_size=beam))
    assert pipe.beam == beam
    outs = pipe.transcribe(mel)
    assert len(outs) == len(refs) == n_audio
    for out, ref in zip(outs, refs):
        assert out.tokens == [int(t) for t in ref.tokens], (out.tokens,
                                                            ref.tokens)
        assert out.text == ref.text
        assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3
        assert abs(out.no_speech_prob - ref.no_speech_prob) < 1e-5


# -- (d) option errors -------------------------------------------------------

OPTION_CASES = {
    "beam_and_best_of": dict(beam_size=2, best_of=2),
    "greedy_best_of": dict(temperature=0.0, best_of=2),
    "patience_without_beam": dict(patience=2.0),
    "patience_not_one": dict(beam_size=2, patience=2.0),
    "patience_one": dict(beam_size=2, patience=1.0),
    "beam_with_length_penalty": dict(beam_size=3, length_penalty=0.8),
}


def _outcome(make):
    try:
        make()
    except (ValueError, NotImplementedError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_option_errors_match_jax(case):
    opts = OPTION_CASES[case]
    jpipe, states = _jax_build("none")
    mods = from_jax_state(*states, PCFG, recipe="none", device="cpu")
    j_out = _outcome(lambda: type(jpipe)(
        jpipe.config, jpipe.encoder, jpipe.decoder, jpipe.cross_kv,
        type(jpipe.options)(language="en", **opts)))
    p_out = _outcome(lambda: WhisperPipeline(
        PCFG, *mods, DecodingOptions(language="en", **opts)))
    assert p_out == j_out


def test_sampling_options_are_not_ported():
    """Sampling, which the JAX package takes, is ported now: the port takes
    the options and decodes the JAX package's rows per audio
    (``test_torch_whisper_pipeline.py`` holds the samples token-exact)."""
    jpipe, states = _jax_build("none")
    mods = from_jax_state(*states, PCFG, recipe="none", device="cpu")
    for opts in (dict(temperature=0.5), dict(temperature=0.5, best_of=3)):
        pipe = WhisperPipeline(PCFG, *mods, DecodingOptions(language="en",
                                                            **opts))
        ref = type(jpipe)(jpipe.config, jpipe.encoder, jpipe.decoder,
                          jpipe.cross_kv,
                          type(jpipe.options)(language="en", **opts))
        assert (pipe.n_group, pipe.beam) == (ref.n_group, ref.beam)
