"""The port's int4 weight-only path (``woq4``, groups of 128 rows) against
the JAX package on the CPU.  Inputs come from numpy seeds and go to both
sides.

* the quantiser and the unpacking bit-equal to the JAX package's:
  per-channel and grouped, weights on .5 boundaries (``np.round`` rounds
  half to even), the 0x8 nibble (-8), all 256 byte values;
* the plain int4 matmul (what the wrapper runs for CPU tensors) against the
  Pallas ``quant_matmul_int4_pallas`` in interpret mode, fp32, rtol 1e-3 and
  atol 1e-4 as ``tests/test_pallas_quant_matmul.py`` holds it; in bf16
  against the JAX XLA path with two groups or more (at most one bf16 step
  apart: the fp32 sums run in another order); with one group ([1, N]
  scales) equal to the Pallas kernel and not to the XLA path, which scales
  the weight in bf16 before the product;
* ``quantize_state`` bit-equal to the JAX ``weight_only_quantize_state``
  under ``use_weight_only(True)``: grouped (hidden 256), one group (hidden
  128) and per channel (hidden 64);
* ``DecoderLMHead`` logits and caches against the JAX model, fp32, 1e-4,
  with the JAX side on its XLA path and, for one step, on the Pallas kernel
  in interpret mode;
* greedy generation token-exact with the JAX ``GenerationSession``: MQA and
  GQA at batch 3 with ragged prompts and an end id, and MHA at batch 1,
  whose dense layer must not take the int8 out-projection GEMV;
* an int4 block is not megakernel-eligible; Whisper's ``woq4`` recipe
  raises;
* a CPU rehearsal of ``chip_smoke.py``'s ``decoder_woq4`` path."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from eddie_wang_hackathon2023_tpu_torch.models.decoder import DecoderConfig
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
    from_jax_state, quantize_state)
from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
from eddie_wang_hackathon2023_tpu_torch.ops import quant_matmul as pqm
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig)

WOQ4 = QuantMode.use_weight_only(True)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- (a) the quantiser and the unpacking -------------------------------------

@pytest.mark.parametrize("group_size", [None, 64, 128])
def test_int4_quantiser_bit_equal_to_jax(group_size):
    """Random weights with some placed exactly on .5 steps of their scale
    (ties round half to even) and some at 0 (all-zero columns get scale
    1.0)."""
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        quantize_weights_int4 as j_quant
    rs = np.random.RandomState(0)
    k, n = 256, 48
    w = rs.randn(k, n).astype(np.float32)
    w[:, 3] = 0.0
    # column 5: amax 7 in every group, so the scales are 1 and the values
    # -6.5 .. 6.5 sit on ties
    w[:, 5] = np.resize(np.arange(-6.5, 7.0, 1.0), k)
    w[::16, 5] = 7.0
    q, s = pqm.quantize_weights_int4(w, group_size=group_size)
    jq, js = j_quant(w, group_size=group_size)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert q.shape == (k // 2, n)
    assert s.shape == ((n,) if group_size is None else (k // group_size, n))
    assert np.array_equal(q, jq) and np.array_equal(s, js)
    assert np.all(s[..., 3] == 1.0)
    # ties to even: -6.5 -> -6, -5.5 -> -6, 0.5 -> 0, 1.5 -> 2
    col = pqm.unpack_int4(_t(q)).numpy()[:, 5]
    ties = w[:, 5] != 7.0
    assert np.array_equal(col[ties], np.round(w[ties, 5]))


def test_unpack_int4_bit_equal_to_jax_over_all_bytes():
    """Every byte value, as a column of a [1, 256] packed weight: the low
    nibble sign-extended as row 0, the high one as row 1.  0x8 unpacks to
    -8 (the quantiser never makes it); torch's int8 shifts agree with
    numpy's bit for bit."""
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        unpack_int4 as j_unpack
    b = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(1, 256)
    got = pqm.unpack_int4(_t(b)).numpy()
    assert got.dtype == np.int8
    assert np.array_equal(got, np.asarray(j_unpack(_j(b))))
    assert np.array_equal(((_t(b) << 4) >> 4).numpy(),
                          (b << 4).astype(np.int8) >> 4)
    # column i holds the byte i - 128: 0x08 at 136, 0x80 at 0, 0xFF at 127
    assert got[0, 136] == -8 and got[1, 136] == 0
    assert got[0, 0] == 0 and got[1, 0] == -8
    assert got[:, 127].tolist() == [-1, -1]


# -- (b) the plain int4 matmul against the Pallas kernel ---------------------

@pytest.mark.parametrize("m,k,n,g", [(1, 256, 512, None), (1, 1280, 1280, None),
                                     (20, 256, 1280, None), (8, 384, 256, 128),
                                     (4, 256, 640, 64)])
def test_plain_int4_matmul_matches_pallas_kernel(m, k, n, g):
    """fp32, rtol 1e-3 and atol 1e-4 (the sums run in another order); the
    (8, 384, 256) case has the two nibbles of a byte in different groups."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_quant_matmul import \
        quant_matmul_int4_pallas
    rs = np.random.RandomState(1)
    packed, scales = pqm.quantize_weights_int4(
        rs.randn(k, n).astype(np.float32), group_size=g)
    x = rs.randn(m, k).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = quant_matmul_int4_pallas(_j(x), _j(packed), _j(scales))
    got = iq.plain_quant_matmul_int4(_t(x), _t(packed), _t(scales))
    # the wrapper runs the plain version for CPU tensors, launching nothing
    before = iq.launches["int4_quant_matmul"]
    via = pqm.weight_only_quant_matmul(_t(x)[None], _t(packed), _t(scales),
                                       bits=4)
    assert iq.launches["int4_quant_matmul"] == before
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(via[0], got)


@pytest.mark.parametrize("k,g", [(256, 128), (256, 64), (384, 128)])
def test_plain_int4_matmul_bf16_matches_xla_path(k, g):
    """bf16 with two groups or more: the XLA path scales each group of the
    weight in bf16 before an fp32-accumulated product, as the port does;
    the results are at most one bf16 step apart."""
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        weight_only_quant_matmul as j_woq_mm
    rs = np.random.RandomState(k + g)
    n = 384
    packed, scales = pqm.quantize_weights_int4(
        rs.randn(k, n).astype(np.float32), group_size=g)
    x = rs.randn(6, k).astype(np.float32)
    want = np.asarray(j_woq_mm(_j(x).astype(jnp.bfloat16), _j(packed),
                               _j(scales), bits=4).astype(jnp.float32))
    got = iq.plain_quant_matmul_int4(_t(x).bfloat16(), _t(packed),
                                     _t(scales))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7)
    assert np.mean(got == want) > 0.99


def test_one_group_follows_the_pallas_kernel():
    """One group ([1, N] scales, in-features 128): the TPU kernel takes
    ``groups = scales.shape[0] = 1`` and puts the fp32 scale on the fp32
    accumulator; the JAX XLA path sees 2-D scales and scales the weight in
    bf16 first.  In bf16 the port equals the kernel bit for bit and differs
    from the XLA path (M 8, K 128, N 256)."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_quant_matmul import \
        quant_matmul_int4_pallas
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        weight_only_quant_matmul as j_woq_mm
    rs = np.random.RandomState(7)
    packed, scales = pqm.quantize_weights_int4(
        rs.randn(128, 256).astype(np.float32), group_size=128)
    assert scales.shape == (1, 256)
    xb = _j(rs.randn(8, 128).astype(np.float32)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        kern = quant_matmul_int4_pallas(xb, _j(packed), _j(scales))
    xla = j_woq_mm(xb, _j(packed), _j(scales), bits=4)
    got = iq.plain_quant_matmul_int4(
        _t(np.asarray(xb.astype(jnp.float32))).bfloat16(), _t(packed),
        _t(scales)).float().numpy()
    kern = np.asarray(kern.astype(jnp.float32))
    xla = np.asarray(xla.astype(jnp.float32))
    assert np.array_equal(got, kern)
    assert np.mean(got != xla) > 0.1


def test_split_plan_covers_k():
    """The kernel's split of K along 64-row chunks covers every chunk once,
    at the path's shapes and at the edges the card tests use."""
    for m, k, n in [(8, 2048, 2304), (8, 2048, 2048), (8, 2048, 8192),
                    (8, 8192, 2048), (512, 2048, 2304), (512, 8192, 2048),
                    (1, 384, 256), (20, 1280, 1280), (8, 128, 256)]:
        mt, splits, per = iq.split_plan(m, n, k, 132)
        chunks = k // iq.CHUNK_K
        assert mt == (1 if m <= 32 else 4)
        assert (splits - 1) * per < chunks <= splits * per
        assert splits == 1 or per >= iq.MIN_CHUNKS_PER_SPLIT[mt]


def test_int4_quant_matmul_refuses_bad_shapes():
    with pytest.raises(ValueError):
        iq.plain_quant_matmul_int4(torch.zeros(2, 64), torch.zeros(
            16, 8, dtype=torch.int8), torch.ones(8))
    with pytest.raises(ValueError):
        iq.plain_quant_matmul_int4(torch.zeros(2, 64), torch.zeros(
            32, 8, dtype=torch.int8), torch.ones(3, 8))
    with pytest.raises(ValueError):
        pqm.weight_only_quant_matmul(torch.zeros(2, 64), torch.zeros(
            64, 8, dtype=torch.int8), torch.ones(8), bits=2)


# -- (c) the models, built from one numpy state on both sides ----------------

MQA = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=2,
           num_kv_heads=1, max_position_embeddings=64)   # groups of 128
GQA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, max_position_embeddings=64)   # one group; proj 4
MHA64 = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=64)                 # per channel
MHA = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=4,
           max_position_embeddings=64)                   # equal heads, groups
FAMILIES = dict(mqa=MQA, gqa=GQA, mha64=MHA64, mha=MHA)


def _float_state(jm, seed):
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    return state


def _models(kw, seed: int = 0):
    """(JAX model, port model, JAX state) for one decoder config, fp32,
    random weights (LayerNorm weights 1 + N(0, 0.02), the rest N(0, 0.2)),
    int4 weight-only on both sides, each quantised by its own package."""
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    jm = JModel(JConfig(**kw, dtype="float32"))
    state = _float_state(jm, seed)
    jm, jstate = j_woq(jm, state, JQ.use_weight_only(True))
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jstate.items()})
    pc = DecoderConfig(**kw, dtype="float32", quant_mode=WOQ4)
    pm = from_jax_state(quantize_state(state, pc), pc, device="cpu")
    return jm, pm, jstate


@pytest.mark.parametrize("family", ["mqa", "gqa", "mha64"])
def test_int4_quantize_state_bit_equal_to_jax(family):
    """Grouped (hidden 256: the QKV/dense/fc scales [2, N], proj [8, N]),
    one group (hidden 128: [1, N], proj [4, N]) and per channel (hidden 64:
    [N], proj [2, N]); the separate-KV QKV is flattened q | k | v before
    packing."""
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    kw = FAMILIES[family]
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(3)
    state = {n: rs.randn(*p.shape).astype(np.float32)
             for n, p in jm.named_parameters()}
    _, jq = j_woq(jm, state, JQ.use_weight_only(True))
    pq = quantize_state(state, DecoderConfig(**kw, quant_mode=WOQ4))
    assert sorted(pq) == sorted(jq)
    for k in pq:
        a, b = np.asarray(pq[k]), np.asarray(jq[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    hidden, ffn = kw["hidden_size"], 4 * kw["hidden_size"]
    scale = pq["blocks.attention.qkv.per_channel_scale"]
    assert scale.shape[1:-1] == (() if hidden % 128 else (hidden // 128,))
    assert pq["blocks.mlp.proj.per_channel_scale"].shape[1] == ffn // 128
    assert pq["blocks.mlp.fc.qweight"].shape == (2, hidden // 2, ffn)


@pytest.mark.parametrize("family", ["mqa", "gqa", "mha64", "mha"])
def test_int4_decoder_logits_match_jax(family):
    """A left-padded prefill of 6 tokens, then one decode step: logits and
    the updated caches, fp32, 1e-4 (the JAX side on its XLA path, as off
    the TPU)."""
    jm, pm, _ = _models(FAMILIES[family])
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
    assert pm.blocks[0].mlp.fc.bits == 4
    np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=1e-4)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(j_lg2), atol=1e-4)
    np.testing.assert_allclose(cache.numpy(), np.asarray(j_cache),
                               atol=1e-4)


def test_int4_step_logits_match_jax_pallas_kernel():
    """The JAX model with the Pallas int4 kernel itself on (interpret
    mode): a prefill of 5 tokens and one step, MQA with groups of 128, fp32,
    1e-4."""
    from eddie_wang_hackathon2023_tpu.plugin import plugin_config
    jm, pm, _ = _models(MQA, seed=5)
    rs = np.random.RandomState(2)
    B, P, S = 2, 5, 8
    ids = rs.randint(0, 97, (B, P)).astype(np.int32)
    step = rs.randint(0, 97, (B, 1)).astype(np.int32)
    params = jm.state_dict()
    jax.clear_caches()
    try:
        with plugin_config(int4_pallas=True), \
                pltpu.force_tpu_interpret_mode():
            _, j_cache = jm.apply(params, _j(ids), jm.new_kv_cache(B, S), 0,
                                  jnp.full((B,), P, jnp.int32))
            j_lg, _ = jm.apply(params, _j(step), j_cache, P,
                               jnp.full((B,), P + 1, jnp.int32))
    finally:
        jax.clear_caches()
    with torch.inference_mode():
        cache = pm.new_kv_cache(B, S)
        _, cache = pm(_t(ids).long(), cache, 0, torch.full((B,), P))
        lg, _ = pm(_t(step).long(), cache, P, P + 1)
    np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=1e-4)


# -- (d) greedy generation ---------------------------------------------------

def _generate_both(kw, ids, lens, seed):
    """(port, JAX) greedy results for 10 new tokens with an end id that row
    0 makes on its fourth step."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    jm, pm, _ = _models(kw, seed=seed)
    mc = dict(vocab_size=97, num_layers=2, num_heads=kw["num_heads"],
              hidden_size=kw["hidden_size"], max_seq_len=64,
              num_kv_heads=kw.get("num_kv_heads"))
    sess = GenerationSession(ModelConfig(**mc), pm,
                             SamplingConfig(end_id=-1, pad_id=96))
    free, _, _ = sess.decode(ids, lens, max_new_tokens=10)
    end_id = int(free[0, 0, ids.shape[1] + 3])
    port = sess.decode(ids, lens, SamplingConfig(end_id=end_id, pad_id=96),
                       max_new_tokens=10)
    jax_side = JSession(JMC(**mc), jm, JSampling(end_id=end_id,
                                                 pad_id=96)).decode(
        ids, lens, max_new_tokens=10)
    return port, jax_side, pm


@pytest.mark.parametrize("family", ["mqa", "gqa"])
def test_int4_generation_token_exact_with_jax(family, monkeypatch):
    """Three ragged prompts (5, 2 and 4 tokens, left-padded, bucketed to 8),
    10 new tokens, rows ending at different steps.  The JAX session takes
    its XLA unpack path (as off the TPU), with the decode tail off."""
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 96, (3, 5)).astype(np.int32)
    lens = np.asarray([5, 2, 4], np.int32)
    (pt, pl, pc), (jt, jl, jc), _ = _generate_both(FAMILIES[family], ids,
                                                   lens, seed=2)
    assert pt.shape == (3, 1, 15) and pl.min() < 15
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


def test_int4_mha_batch1_runs_the_dense_layer_unfused(monkeypatch):
    """MHA at batch 1 (equal heads): an int8 dense layer would be fused into
    the decode kernel's out-projection GEMV; an int4 one must not be (its
    packed nibbles are no int8 weight), as in the JAX package.  Greedy
    decode is token-exact with the JAX session."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    ids = np.random.RandomState(6).randint(0, 96, (1, 6)).astype(np.int32)
    (pt, pl, _), (jt, jl, _), pm = _generate_both(
        MHA, ids, np.asarray([6], np.int32), seed=3)
    attn = pm.blocks[0].attention
    assert attn.dense.bits == 4 and attn._decode_proj_operands(1) is None
    woq8 = DecoderLMHead(DecoderConfig(**MHA, dtype="float32",
                                       quant_mode=QuantMode.use_weight_only()))
    assert woq8.blocks[0].attention._decode_proj_operands(1) is not None
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)


# -- (e) what int4 does not reach --------------------------------------------

def test_int4_block_is_not_megakernel_eligible():
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.ops.decoder_layer import \
        woq_block_eligible
    for mode, eligible in ((QuantMode.use_weight_only(), True),
                           (WOQ4, False)):
        b = DecoderLMHead(DecoderConfig(**MHA, dtype="float32",
                                        quant_mode=mode)).blocks[0]
        mods = [b.attention.dense, b.mlp.fc, b.mlp.proj]
        assert woq_block_eligible(b.attention.qkv, mods, 256) is eligible


def test_whisper_woq4_recipe_raises():
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.convert import \
        Recipe
    for recipe in ("woq4", "woq4+ckv8+lmq8"):
        with pytest.raises(NotImplementedError, match="int4 panels"):
            Recipe.parse(recipe)
    assert Recipe.parse("woq8").decoder == QuantMode.use_weight_only()


# -- (f) chip_smoke.py's decoder_woq4 path, rehearsed -------------------------

def test_chip_smoke_decoder_woq4_path_on_cpu():
    """The int4 decoder path of ``chip_smoke.py`` at 2 layers of width 256
    (SantaCoder's head dim 128, one KV head, groups of 128, vocab 97), bf16
    as on the card: it builds, generates 20 tokens for 8 prompts, launches
    no kernel from CPU tensors, and its teacher-forced replay through the
    plain path is exact (on the CPU both are the plain version)."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = dataclasses.replace(
        smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128,
        quant_mode=WOQ4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e2e, counts = smoke.decoder_path(torch, np, config=config,
                                         device="cpu", label="decoder_woq4")
    finally:
        torch.set_num_threads(n)
    assert counts["int4_quant_matmul"] == 0
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0
    assert e2e["logits_argmax_agreement"] == 1.0
    assert e2e["tokens_per_s"] > 0
