"""The port's ``runtime/sampling.py`` filters and decoding step against the
JAX package's on the CPU: the same numpy inputs through both, the logits
and masks bit-equal, the tokens equal and the log-probabilities within
1e-6.  The sampled rows of ``dynamic_decode`` take the JAX noise
(``jax.random.categorical`` is argmax(logits + ``gumbel(key, shape)``)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.runtime import sampling as js
from eddie_wang_hackathon2023_tpu_torch.runtime import sampling as ps

B, V = 5, 61


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _logits(seed):
    """[B, V] fp32 logits with a tie at each row's maximum, a tie inside
    the tail, and some -inf."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, V) * 2).astype(np.float32)
    x[1, [7, 30]] = x[1].max() + 1
    x[2, [3, 4, 5]] = 0.5
    x[3, ::9] = -np.inf
    return x


def _counts(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 3, (B, V)) * (rs.rand(B, V) < 0.3)).astype(np.int32)


def _same(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype or out.dtype.kind == ref.dtype.kind
    np.testing.assert_array_equal(out, ref)


def _value(per_row, scalar, rows):
    """(JAX argument, port argument): a Python scalar, or the same per-row
    values as a [B] array and tensor."""
    if not per_row:
        return scalar, scalar
    a = np.asarray(rows)
    return _j(a), _t(a)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_penalties_bit_equal(per_row):
    x, c = _logits(0), _counts(1)
    for fn, scalar, rows in (
            ("apply_repetition_penalty", 1.3,
             np.asarray([1.0, 1.3, 0.7, 2.0, 1.1], np.float32)),
            ("apply_presence_penalty", 0.4,
             np.asarray([0.0, 0.4, -0.3, 1.5, 0.1], np.float32))):
        jv, pv = _value(per_row, scalar, rows)
        ref = getattr(js, fn)(_j(x), _j(c), jv)
        out = getattr(ps, fn)(_t(x), _t(c), pv)
        _same(out, ref)
        assert not np.array_equal(np.asarray(ref), x)
    # the neutral values are identities on both sides
    xt = _t(x)
    assert ps.apply_repetition_penalty(xt, _t(c), 1.0) is xt
    assert ps.apply_presence_penalty(xt, _t(c), 0.0) is xt


@pytest.mark.parametrize("cur_row", [False, True], ids=["cur", "cur_per_row"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_min_length_bit_equal(per_row, cur_row):
    x = _logits(2)
    jm, pm = _value(per_row, 4, np.asarray([0, 4, 2, 6, 3], np.int32))
    jc, pc = _value(cur_row, 3, np.asarray([3, 3, 1, 7, 2], np.int32))
    for end in (7, np.asarray([7, 30, 0, 60, 7], np.int32)):
        je, pe = (end, end) if np.ndim(end) == 0 else (_j(end), _t(end))
        ref = js.apply_min_length(_j(x), jc, jm, je)
        out = ps.apply_min_length(_t(x), pc, pm, pe)
        _same(out, ref)
        assert np.isneginf(np.asarray(ref)).sum() > np.isneginf(x).sum()


@pytest.mark.parametrize("k", [0, 1, 5, 8, V + 3])
def test_top_k_scalar_bit_equal(k):
    x = _logits(3)
    _same(ps.apply_top_k(_t(x), k), js.apply_top_k(_j(x), k))


@pytest.mark.parametrize("ks", [[0, 1, 3, 50, 8], [2, 2, 9, 1, 0],
                                [64, 70, 1, 5, 61]])
def test_top_k_per_row_bit_equal(ks):
    x = _logits(4)
    k = np.asarray(ks, np.int32)
    assert ps.max_top_k(ks) == js._max_top_k(ks)
    ref = js.apply_top_k(_j(x), _j(k), js._max_top_k(ks))
    out = ps.apply_top_k(_t(x), _t(k), ps.max_top_k(ks))
    _same(out, ref)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.9, 0.99, 1.0])
def test_top_p_scalar_bit_equal(p):
    for seed in range(4):
        x = _logits(10 + seed)
        _same(ps.apply_top_p(_t(x), p), js.apply_top_p(_j(x), p))


def test_top_p_per_row_bit_equal():
    p = np.asarray([0.0, 0.3, 0.9, 1.0, 0.95], np.float32)
    for seed in range(4):
        x = _logits(20 + seed)
        _same(ps.apply_top_p(_t(x), _t(p)), js.apply_top_p(_j(x), _j(p)))


def _words(three_d):
    """Bad or stop word tables: [N, M] shared, or [B, N, M] per request
    (rows with words of their own, one row with none), and their
    lengths."""
    shared = [[11, 12, 13], [4], [20, 21], [0]]
    if not three_d:
        w, l = js.pack_words(shared)
        pw, pl = ps.pack_words(shared)
        _same(pw, w)
        _same(pl, l)
        return (w, l), (pw, pl)
    rs = np.random.RandomState(5)
    words = rs.randint(0, 40, (B, 3, 3)).astype(np.int32)
    lens = rs.randint(1, 4, (B, 3)).astype(np.int32)
    lens[4] = 0
    return (_j(words), _j(lens)), (_t(words), _t(lens))


def _history(seed):
    """[B, T] token rows whose tails end with (parts of) the words."""
    rs = np.random.RandomState(seed)
    t = rs.randint(0, 40, (B, 12)).astype(np.int32)
    t[0, 6:8] = [11, 12]
    t[1, 5:8] = [20, 21, 4]
    t[2, 7] = 20
    return t


@pytest.mark.parametrize("cur_row", [False, True], ids=["cur", "cur_per_row"])
@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
def test_ban_bad_words_bit_equal(three_d, cur_row):
    x, toks = _logits(6), _history(7)
    (jw, jl), (pw, pl) = _words(three_d)
    jc, pc = _value(cur_row, 8, np.asarray([8, 8, 8, 3, 0], np.int32))
    if three_d:
        toks[:, 6:8] = np.asarray(pw)[:, 0, :2]
    ref = js.ban_bad_words(_j(x), _j(toks), jc, jw, jl)
    out = ps.ban_bad_words(_t(x), _t(toks).long(), pc, pw, pl)
    _same(out, ref)
    assert np.isneginf(np.asarray(ref)).sum() > np.isneginf(x).sum()


@pytest.mark.parametrize("cur_row", [False, True], ids=["cur", "cur_per_row"])
@pytest.mark.parametrize("three_d", [False, True], ids=["2d", "3d"])
def test_match_stop_words_equal(three_d, cur_row):
    """Per-row positions over a shared table: the JAX function takes them
    with the table repeated per row (its 2D branch takes a scalar)."""
    toks = _history(8)
    (jw, jl), (pw, pl) = _words(three_d)
    if three_d:                 # each row ends with its word 1 at 7
        for i, (w, n) in enumerate(zip(np.asarray(pw)[:, 1],
                                       np.asarray(pl)[:, 1])):
            toks[i, 8 - n:8] = w[:n]
    jc, pc = _value(cur_row, 7, np.asarray([7, 7, 7, 2, 0], np.int32))
    if cur_row and not three_d:
        jw, jl = (jnp.broadcast_to(a[None], (B,) + a.shape) for a in (jw, jl))
    ref = js.match_stop_words(_j(toks), jc, jw, jl)
    out = ps.match_stop_words(_t(toks).long(), pc, pw, pl)
    _same(out, ref)
    assert np.asarray(ref).any()


def test_decode_params_match_jax():
    sc = dict(end_id=3, temperature=[0.0, 0.7, 1.0, 0.5, 2.0], top_k=5,
              top_p=0.9, repetition_penalty=1.1, presence_penalty=0.2,
              min_length=[0, 1, 2, 3, 4], bad_words_list=[[1, 2], [5]],
              stop_words_list=[[7]])
    ref = js.DecodeParams.from_config(js.SamplingConfig(**sc), B)
    out = ps.DecodeParams.from_config(ps.SamplingConfig(**sc), B)
    for name in ("temperature", "top_k", "top_p", "repetition_penalty",
                 "presence_penalty", "min_length", "end_id", "bad_words",
                 "bad_word_lens", "stop_words", "stop_word_lens"):
        _same(getattr(out, name), getattr(ref, name))
    assert (out.max_top_k, out.greedy) == (ref.max_top_k, ref.greedy)
    rep = out.repeat_rows(3)
    assert rep.temperature.shape == (3 * B,) and rep.bad_words.shape == (2, 2)
    for top_k in (1, 2, 8, 9, [0, 1], [3, 40]):
        assert ps.max_top_k(top_k) == js._max_top_k(top_k)
    for kw in (dict(temperature=0.0), dict(top_k=1), dict(top_p=0.5),
               dict(temperature=[0.0, 1.0], top_k=[5, 1])):
        assert ps.all_greedy(ps.SamplingConfig(**kw)) == \
            js._all_greedy(js.SamplingConfig(**kw))


def _jax_gumbel(key, shape):
    return jax.random.gumbel(key, shape, jnp.float32)


@pytest.mark.parametrize("filters", [False, True], ids=["plain", "filtered"])
def test_dynamic_decode_mixed_rows_match_jax(filters):
    """Rows 0 and 3 greedy (temperature 0; top_k 1 with top_p 0), the
    others sampled with per-row temperature, top-k and top-p; with
    ``filters``, counts for the penalties, min-length and bad words too."""
    sc = dict(end_id=2, temperature=[0.0, 0.7, 1.2, 1.0, 0.9],
              top_k=[0, 5, 0, 1, 12], top_p=[0.0, 0.0, 0.8, 0.0, 0.9],
              repetition_penalty=[1.0, 1.3, 1.1, 1.0, 0.8],
              presence_penalty=[0.0, 0.2, 0.5, 0.0, -0.1],
              min_length=[0, 3, 1, 0, 9], bad_words_list=[[11, 12], [4]])
    jp = js.DecodeParams.from_config(js.SamplingConfig(**sc), B)
    pp = ps.DecodeParams.from_config(ps.SamplingConfig(**sc), B)
    c, toks = _counts(9), _history(10)
    key = jax.random.PRNGKey(3)
    for step in range(6):
        key, sub = jax.random.split(key)
        x = _logits(30 + step)
        kw = (dict(token_counts=c, cur_lengths=np.full((B,), 2, np.int32),
                   tokens=toks, cur=8) if filters else {})
        jt, jlp = js.dynamic_decode(_j(x), sub, jp, **{
            k: (v if k == "cur" else _j(v)) for k, v in kw.items()})
        noise = torch.from_numpy(np.array(_jax_gumbel(sub, (B, V))))
        pt, plp = ps.dynamic_decode(_t(x), noise, pp, **{
            k: (v if k == "cur" else _t(v).long() if k == "tokens"
                else _t(v)) for k, v in kw.items()})
        _same(pt.numpy().astype(np.int32), jt)
        np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=1e-6,
                                   atol=1e-6)
    # a generator in place of the noise: the same draw as gumbel_noise's
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a, _ = ps.dynamic_decode(_t(x), g1, pp)
    b, _ = ps.dynamic_decode(_t(x), ps.gumbel_noise((B, V), g2), pp)
    _same(a, b)
    with pytest.raises(ValueError, match="noise"):
        ps.dynamic_decode(_t(x), None, pp)


def test_filtered_logits_match_jax():
    """The filter half that the beam loop runs (the JAX package's
    ``_filtered_logits``): both penalties, min-length and bad words."""
    from eddie_wang_hackathon2023_tpu.runtime.generation import \
        _filtered_logits
    sc = dict(end_id=2, repetition_penalty=[1.0, 1.3, 1.1, 1.0, 0.8],
              presence_penalty=[0.0, 0.2, 0.5, 0.0, -0.1],
              min_length=[0, 3, 1, 0, 9], bad_words_list=[[11, 12], [4]])
    jp = js.DecodeParams.from_config(js.SamplingConfig(**sc), B)
    pp = ps.DecodeParams.from_config(ps.SamplingConfig(**sc), B)
    x, c, toks = _logits(41), _counts(42), _history(43)
    gen = np.full((B,), 2, np.int32)
    ref, _ = _filtered_logits(_j(x), jp, _j(c), _j(gen), _j(toks), 8)
    out = ps.filtered_logits(_t(x), pp, _t(c), 2, _t(toks).long(), 8)
    _same(out, ref)
    assert np.isneginf(np.asarray(ref)).sum() > np.isneginf(x).sum()


def test_sample_step_matches_jax():
    sc = dict(temperature=0.9, top_k=7, top_p=0.0)
    x = _logits(40)
    key = jax.random.PRNGKey(8)
    jt, jlp = js.sample_step(_j(x), key, js.SamplingConfig(**sc))
    noise = torch.from_numpy(np.array(_jax_gumbel(key, (B, V))))
    pt, plp = ps.sample_step(_t(x), noise, ps.SamplingConfig(**sc))
    _same(pt.numpy().astype(np.int32), jt)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=1e-6,
                               atol=1e-6)


def test_gumbel_noise_is_the_pipelines_draw():
    """The Whisper pipeline draws its noise through the same helper, so
    its draws for a seed are unchanged."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import \
        WhisperPipeline
    g = torch.Generator().manual_seed(11)
    u = torch.rand((3, 50), generator=g).clamp_(
        min=torch.finfo(torch.float32).tiny)
    pipe = WhisperPipeline.__new__(WhisperPipeline)
    pipe._rng, pipe.device = torch.Generator().manual_seed(11), \
        torch.device("cpu")
    _same(pipe._gumbel((3, 50)), -torch.log(-torch.log(u)))
