"""The fp8 (e4m3) KV cache through the port's ``GenerationSession`` and
``ContinuousBatchingManager`` against the JAX package on the CPU (tiny
decoder-only models, fp32, weights from numpy seeds on both sides, the
e4m3 self cache with per-layer scales 1 / s and s):

* ``GenerationSession``: greedy over MHA, MQA and GQA, and MHA beams,
  token-exact with the JAX session;
* serving: the dense slot cache token-exact with the JAX manager (scales
  from a float run's amax, with room: the JAX cache cast gives NaN past
  e4m3's range, the port saturates); the paged pool token-exact with the
  JAX manager at scale 1, and with the port's dense slot cache at the
  calibrated scale (the JAX pool writes and reads e4m3 without the
  scales, a fault of the reference that the port does not copy);
* the JAX pool's unscaled writes pinned beside the port's scaled ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.models.decoder import DecoderConfig
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
    from_jax_state
from eddie_wang_hackathon2023_tpu_torch.ops import paged_attention as ppa
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import \
    fp8_scales_from_amax
from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig)
from test_torch_serving_beams import serve
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

F8 = torch.float8_e4m3fn
MHA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=4, max_position_embeddings=64)
MQA = dict(MHA, hidden_size=256, num_heads=2, num_kv_heads=1)
GQA = dict(MHA, num_kv_heads=2)
IDS = np.random.RandomState(4).randint(0, 96, (3, 5)).astype(np.int32)
LENS = np.asarray([5, 2, 4], np.int32)
END = 96


@pytest.fixture(autouse=True)
def one_thread(one_cpu_thread):  # noqa: F811
    yield


def _state(kw, seed):
    from eddie_wang_hackathon2023_tpu.models.decoder import (
        DecoderConfig as JConfig, DecoderLMHead as JModel)
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    return state


def _amax(kw, state):
    """The float model's amax of |K|, |V| over the prompts' prefill and
    ten greedy steps (a calibration run)."""
    pm = from_jax_state(state, DecoderConfig(**kw, dtype="float32"),
                        device="cpu")
    sess = GenerationSession(ModelConfig(**_mc(kw)), pm,
                             SamplingConfig(end_id=-1, pad_id=END))
    seen = []
    forward = pm.forward

    def spy(*a, **k):
        out = forward(*a, **k)
        seen.append(float(out[1].float().abs().max()))
        return out
    pm.forward = spy
    sess.decode(IDS, LENS, max_new_tokens=10)
    return max(seen)


def _models(kw, scale, seed=2):
    """(JAX model, port model) with an e4m3 self cache, kv scales 1 / s
    and s in every layer."""
    from eddie_wang_hackathon2023_tpu.models.decoder import (
        DecoderConfig as JConfig, DecoderLMHead as JModel)
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    state = _state(kw, seed)
    if scale == "calibrated":
        # room past the calibration's amax: a step may go beyond it
        scale = fp8_scales_from_amax(1.5 * _amax(kw, state))
    s = np.full((kw["num_layers"], 1), scale, np.float32)
    state = {**state, "blocks.attention.kv_orig_quant_scale": 1.0 / s,
             "blocks.attention.kv_quant_orig_scale": s}
    jm = JModel(JConfig(**kw, dtype="float32",
                        quant_mode=JQ(0).set_fp8_kv_cache()))
    jm.load_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    pm = from_jax_state(state, DecoderConfig(
        **kw, dtype="float32", quant_mode=QuantMode(0).set_fp8_kv_cache()),
        device="cpu")
    assert pm.new_kv_cache(1, 8).dtype == F8
    return jm, pm


def _mc(kw):
    return dict(vocab_size=kw["vocab_size"], num_layers=kw["num_layers"],
                num_heads=kw["num_heads"], hidden_size=kw["hidden_size"],
                max_seq_len=kw["max_position_embeddings"],
                num_kv_heads=kw["num_kv_heads"])


def test_quantize_state_carries_the_fp8_scales_bit_equal_to_jax():
    """woq8 with an e4m3 KV cache: the port's ``quantize_state`` against
    the JAX surgery on the same float state with the scales, every array
    equal (the scales pass through both)."""
    from eddie_wang_hackathon2023_tpu.models.decoder import (
        DecoderConfig as JConfig, DecoderLMHead as JModel)
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        quantize_state
    jmode = JQ.use_weight_only().set_fp8_kv_cache()
    s = np.full((MQA["num_layers"], 1), fp8_scales_from_amax(9.0),
                np.float32)
    state = {**_state(MQA, 5), "blocks.attention.kv_orig_quant_scale": 1 / s,
             "blocks.attention.kv_quant_orig_scale": s}
    _, ref = j_woq(JModel(JConfig(**MQA, dtype="float32",
                                  quant_mode=jmode)), state, jmode)
    out = quantize_state(state, DecoderConfig(
        **MQA, dtype="float32",
        quant_mode=QuantMode.use_weight_only().set_fp8_kv_cache()))
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k


# -- (a) GenerationSession ------------------------------------------------------

@pytest.mark.parametrize("family,beams", [("mha", 1), ("mqa", 1),
                                          ("gqa", 1), ("mha", 3)],
                         ids=["mha", "mqa", "gqa", "mha_beams3"])
def test_session_token_exact_with_jax(family, beams, monkeypatch):
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    monkeypatch.setenv("EWT_PALLAS_DECODE", "0")
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    jax.clear_caches()
    kw = dict(mha=MHA, mqa=MQA, gqa=GQA)[family]
    jm, pm = _models(kw, "calibrated")
    sc = SamplingConfig(end_id=-1, pad_id=END, num_beams=beams)
    ps = GenerationSession(ModelConfig(**_mc(kw)), pm, sc)
    free, _, _ = ps.decode(IDS, LENS, max_new_tokens=10)
    # an end id that a row generates, so that rows finish apart
    sc = dataclasses.replace(sc, end_id=int(free[0, -1, 5 + 3]))
    pt, pl, pc = ps.decode(IDS, LENS, sc, max_new_tokens=10)
    jt, jl, jc = JSession(JMC(**_mc(kw)), jm, JSampling(
        **dataclasses.asdict(sc))).decode(IDS, LENS, max_new_tokens=10)
    assert pt.shape == (3, beams, 15) and pl.min() < 15
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


# -- (b) serving ---------------------------------------------------------------

PROMPTS = [[5, 11, 17, 23, 31], [40, 2], [7, 8, 9, 10, 11, 12, 13], [3]]
REQS = [(p, 10, None) for p in PROMPTS]
KW = dict(max_batch_size=2, max_seq_len=64)


def test_dense_slot_cache_token_exact_with_jax():
    jm, pm = _models(MHA, "calibrated")
    want = serve("jax", jm, REQS, end=END, **KW)
    got = serve("port", pm, REQS, end=END, **KW)
    assert got == want and sorted(got) == [0, 1, 2, 3]


def test_pool_token_exact_with_jax_at_scale_1_and_dense_when_calibrated():
    """At scale 1 the JAX pool's unscaled casts are the scaled ones, and
    its manager's tokens equal the port's pool's; at the calibrated scale
    and with paged beams (the beam entry's plain version), its manager's
    tokens equal the port's pool's; at the calibrated scale the port's
    pool gives its dense slot cache's tokens, greedy and under mixed
    admission (the window entry's plain version).  (A whole prompt's
    prefill attends over its float K/V on the pool, as JAX's does, and
    over the e4m3 cache it has written on the dense cache: beams, which
    rank close log-probabilities, may part there.)"""
    jm, pm = _models(MHA, 1.0)
    paged = dict(paged=True, tokens_per_block=8)
    want = serve("jax", jm, REQS, end=END, **KW, **paged)
    assert serve("port", pm, REQS, end=END, **KW, **paged) == want
    beams = [(p, 8, dict(num_beams=2)) for p in PROMPTS[:3]]
    kw = dict(KW, max_beam_width=2)
    assert (serve("port", pm, beams, end=END, **kw, **paged)
            == serve("jax", jm, beams, end=END, **kw, **paged))
    _, pm = _models(MHA, "calibrated")
    dense = serve("port", pm, REQS, end=END, **KW)
    assert serve("port", pm, REQS, end=END, **KW, **paged) == dense
    mixed = dict(mixed_admission=True, chunk_width=4)
    assert (serve("port", pm, REQS, end=END, **KW, **mixed, **paged)
            == serve("port", pm, REQS, end=END, **KW, **mixed))


def test_jax_pool_writes_e4m3_without_the_scale():
    """The JAX pool's ``paged_append_kv`` casts e4m3 without
    ``kv_orig_quant_scale`` (its int8 branch scales): a fault of the
    reference.  The port's write is the scaled cast, as its dense cache's
    and the JAX dense cache's."""
    from eddie_wang_hackathon2023_tpu.ops import attention as ja
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        paged_append_kv as j_append
    rs = np.random.RandomState(3)
    k, v = (rs.randn(2, 2, 1, 16).astype(np.float32) for _ in range(2))
    table = np.asarray([[0, 1], [2, -1]], np.int32)
    pos = np.asarray([3, 5], np.int32)
    s = np.asarray([8.0], np.float32)
    jpool = j_append(jnp.zeros((3, 2, 2, 8, 16), jnp.float8_e4m3fn),
                     jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                     jnp.asarray(pos), kv_orig_quant_scale=jnp.asarray(s))
    ppool = ppa.paged_append_kv(torch.zeros(4, 2, 2, 8, 16, dtype=F8),
                                torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(table),
                                torch.from_numpy(pos),
                                kv_orig_quant_scale=torch.from_numpy(s))
    got_j = np.asarray(jpool[0, :, :, 3].astype(jnp.float32))
    got_p = ppool[0, :, :, 3].float().numpy()
    unscaled = np.asarray(ja.quantize_cache_values(
        jnp.asarray(np.stack([k[0, :, 0], v[0, :, 0]])), jnp.float8_e4m3fn,
        jnp.asarray([1.0], jnp.float32)).astype(jnp.float32))
    scaled = np.asarray(ja.quantize_cache_values(
        jnp.asarray(np.stack([k[0, :, 0], v[0, :, 0]])), jnp.float8_e4m3fn,
        jnp.asarray(s)).astype(jnp.float32))
    np.testing.assert_array_equal(got_j, unscaled)
    np.testing.assert_array_equal(got_p, scaled)
    assert not np.array_equal(scaled, unscaled)
