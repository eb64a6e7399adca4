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


# the prefill entry's C limits (csrc/int4_quant_matmul.cu)
_PREFILL_ENTRY_SMEM = 227 * 1024


def _prefill_entry_accepts(plan, m):
    """What the C entry ``int4_quant_matmul`` checks of a plan."""
    r, s = plan["rows"], plan["stages"]
    return (r in (32, 64, 80, 128, 160, 256) and 2 <= s <= 8
            and iq.prefill_smem(r, s) <= _PREFILL_ENTRY_SMEM
            and -(-m // r) <= 65535)


# the shapes the removed split of K was held at, then the path's linears at
# the M the card tests use
_PREFILL_SHAPES = [(512, 2048, 2304), (512, 2048, 2048), (512, 2048, 8192),
                   (512, 8192, 2048), (33, 384, 256), (40, 1280, 1280),
                   (64, 128, 256)] + [
    (m, k, n) for m in (33, 100, 1000)
    for k, n in [(2048, 2304), (2048, 2048), (2048, 8192), (8192, 2048)]]


@pytest.mark.parametrize("m,k,n", _PREFILL_SHAPES)
def test_prefill_plan_covers_the_output_and_k(m, k, n):
    """The prefill entry's plan: the blocks' [rows, 128] tiles cover every
    output element once; a block's chunks (64 packed rows, the last 32 or 64: its low nibbles
    rows p0.., its high ones K/2 + p0.. of K) cover every row of K once;
    the plan is one the C entry takes."""
    plan = iq.prefill_plan(m, n, k, 132)
    r = plan["rows"]
    assert _prefill_entry_accepts(plan, m)
    assert plan["stages"] <= max(2, -(-(k // 2) // iq.PREFILL_CHUNK))
    grid = (-(-n // iq.TILE_N), -(-m // r))
    assert plan["tiles"] == grid[0] * grid[1]
    cover = np.zeros((m, n), dtype=np.int32)
    for bx in range(grid[0]):
        for by in range(grid[1]):
            cover[by * r:(by + 1) * r, bx * iq.TILE_N:(bx + 1) * iq.TILE_N] \
                += 1
    assert (cover == 1).all()
    kh = k // 2
    rows_k = []
    for p0 in range(0, kh, iq.PREFILL_CHUNK):
        live = min(iq.PREFILL_CHUNK, kh - p0)
        assert live in (32, 64)
        rows_k += list(range(p0, p0 + live)) + list(range(kh + p0,
                                                          kh + p0 + live))
    assert sorted(rows_k) == list(range(k))


@pytest.mark.parametrize("m", [33, 100, 512, 1000])
@pytest.mark.parametrize("k,n", [(2048, 2304), (2048, 2048), (2048, 8192),
                                 (8192, 2048)],
                         ids=["qkv", "dense", "fc", "proj"])
def test_prefill_plan_fills_one_wave(m, k, n):
    """On 132 SMs the plan's tiles are one wave at the SantaCoder-1B
    linears at M 33, 100, 512 and 1000, except fc at M 1000, where no tile
    of the entry (at most 256 rows x 128 columns: the accumulators live in
    registers) makes one wave of 8192 x 1000 outputs: there two waves, the
    fewest.  At M 512 every tile is a block of the one wave: qkv 126 tiles
    of 80 rows, dense and proj 128 of 64, fc 128 of 256."""
    plan = iq.prefill_plan(m, n, k, 132)
    cols = -(-n // iq.TILE_N)
    if (m, n) == (1000, 8192):
        assert min(cols * -(-m // r) for r in iq.PREFILL_ROWS) > 132
        assert plan["tiles"] <= 2 * 132
    else:
        assert plan["tiles"] <= 132
    if m == 512:
        assert (plan["rows"], plan["tiles"]) == {
            2304: (80, 126), 2048: (64, 128), 8192: (256, 128)}[n]


# the SantaCoder-1B linears (K, N) and the card tests' edges
_DECODE_SHAPES = [(2048, 2304), (2048, 2048), (2048, 8192), (8192, 2048),
                  (384, 256), (1280, 1280), (128, 256), (64, 256),
                  (256, 1000), (2048, 1040)]


@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("k,n", _DECODE_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_decode_plan_covers_k_within_the_entry_limits(m, k, n, sms):
    """The decode entry's plan: every packed row of K in exactly one step
    of one warp of one block of the cluster (cluster * warps * steps * 8
    = K/2), within the C entry's limits (a cluster of 1-8, 4 or 8 warps,
    the partial sums' shared memory within 227 KB); the warps' rows
    listed as the kernel walks them cover K/2 once."""
    plan = iq.decode_plan(m, n, k, sms)
    c, w, s = plan["cluster"], plan["warps"], plan["steps"]
    assert c in (1, 2, 4, 8) and w in (4, 8) and s >= 1
    assert c * w * s * iq.DECODE_STEP == k // 2
    nt = iq._decode_tiles(m)
    assert nt * 8 >= m and nt in (1, 2, 4)
    assert (w + c - 1) * 8 * nt * 32 * 16 <= iq.DECODE_MAX_SMEM
    rows = sorted(((r * w + wp) * s + st) * iq.DECODE_STEP + i
                  for r in range(c) for wp in range(w) for st in range(s)
                  for i in range(iq.DECODE_STEP))
    assert rows == list(range(k // 2))


def test_decode_plan_at_the_path_shapes():
    """On 132 SMs the SantaCoder-1B linears at M 8: one block an SM, the
    smallest cluster whose warps keep their 4 steps in flight (qkv 18
    column tiles x 4, dense 16 x 4), else the largest (fc 64 x 2, proj
    16 x 8), blocks of 8 warps."""
    got = {name: iq.decode_plan(8, n, k, 132) for name, k, n in [
        ("qkv", 2048, 2304), ("dense", 2048, 2048), ("fc", 2048, 8192),
        ("proj", 8192, 2048)]}
    assert got == {
        "qkv": dict(cluster=4, warps=8, steps=4),
        "dense": dict(cluster=4, warps=8, steps=4),
        "fc": dict(cluster=2, warps=8, steps=8),
        "proj": dict(cluster=8, warps=8, steps=8)}
    with pytest.raises(ValueError):
        iq.decode_plan(33, 2048, 2048, 132)


def test_int4_probe_stamps_the_decode_entry():
    """``tools/int4_kernel_probe.py``'s stamped copy of the kernel: one stamp
    after each of its anchors in the decode entry (each found once), the
    stamps' reader, and the phases read back from a run's stamps."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "int4_kernel_probe", os.path.join(root, "tools",
                                          "int4_kernel_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = open(os.path.join(root, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "int4_quant_matmul.cu")).read()
    for anchor, _ in probe.STAMPED:
        assert src.count(anchor) == 1, anchor
    out = probe.stamped_source(src)
    assert out.count(probe.STAMP) == len(probe.STAMPED)
    assert out.count("int stamp_i = 0;") == 1
    assert 'extern "C" int read_stamps' in out
    assert out.replace(probe.STAMP + "\n", "").replace(
        "int stamp_i = 0;\n", "").startswith("__device__ long long g_st")
    got = probe.phases([0, 5, 15, 30, 40, 41, 50, 52], 3)
    assert got == {"issue": 5, "steps": [10, 15, 10], "warp sums": 1,
                   "cluster sums landed": 9, "out": 2}
    with pytest.raises(ValueError):
        probe.phases([0, 1, 2], 3)


def test_int4_probe_stamps_the_prefill_entry():
    """``tools/int4_kernel_probe.py``'s stamped copy of the prefill entry:
    each of its anchors found once in the source, every stamp put in, the
    arrays and their reader declared, and the phases read back from a run's
    stamps (two chunks: the consumer waited for the second)."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "int4_kernel_probe", os.path.join(root, "tools",
                                          "int4_kernel_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = open(os.path.join(root, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "int4_quant_matmul.cu")).read()
    for anchor, _ in probe.PREFILL_STAMPS:
        assert src.count(anchor) == 1, anchor
    out = probe.prefill_stamped_source(src)
    assert out.count("clock64()") == 11
    assert 'extern "C" int read_prefill_stamps' in out
    n = probe.PREFILL_CHUNKS
    st = [0] * (5 * n + 4)
    st[0:2] = [5, 7]                       # producer waits
    st[n:n + 2] = [100, 300]               # issues
    st[2 * n:2 * n + 2] = [110, 400]       # consumer wait starts
    st[3 * n:3 * n + 2] = [150, 900]       # ... ends
    st[4 * n:4 * n + 2] = [350, 1200]      # chunks done
    st[5 * n:5 * n + 3] = [90, 1200, 1500]
    got = probe.prefill_phases(st, 2)
    assert got == {"producer waits for free stages": 12,
                   "consumer waits for chunks": 40 + 500,
                   "consumer on chunks": 200 + 300,
                   "chunks waited for": 1,
                   "copy latency where waited (mean)": 600,
                   "start to loop end": 1110, "epilogue": 300}


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
    """The decoder-only models keep int4 layer by layer, as the JAX
    package does (``woq_block_eligible(allow_int4=False)``, JAX
    models/decoder.py:248-254); the structural check itself admits an int4
    block whose groups divide d/2 (Whisper's gate passes it)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.ops.decoder_layer import \
        woq_block_eligible
    for mode, eligible in ((QuantMode.use_weight_only(), True),
                           (WOQ4, False)):
        model = DecoderLMHead(DecoderConfig(**MHA, dtype="float32",
                                            quant_mode=mode))
        b = model.blocks[0]
        mods = [b.attention.dense, b.mlp.fc, b.mlp.proj]
        assert woq_block_eligible(b.attention.qkv, mods, 256,
                                  allow_int4=False) is eligible
        assert woq_block_eligible(b.attention.qkv, mods, 256)
        assert model.megakernel_eligible() is eligible


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
