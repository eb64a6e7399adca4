"""The fp8 (e4m3) KV cache and the FP8 QDQ linears of the port against the
JAX package on the CPU, with the same numpy-seeded inputs on both sides:

* the cache cast: bit-equal to JAX's wherever JAX's cast is finite
  (|scaled| < 464), all 256 bytes decoded equal, and the overflow pinned:
  the JAX cache cast gives NaN past the range (a fault of the reference:
  its docstring promises a saturating cast), the port +-448, as Hopper's
  ``cvt.rn.satfinite`` and the JAX package's own ``quantize_fp8``;
* ``quantization/fp8_layers``: ``quantize_fp8`` bit-equal (the clip
  too), ``FP8Linear`` / ``FP8RowLinear`` / ``FP8MLP`` at fp32 rtol 1e-5;
* the ``Attention`` layer over an e4m3 cache: a prefill and 3 steps, the
  cache bytes equal (uint8 views), the outputs within 1e-5;
* each kernel's plain version against the JAX Pallas kernel in interpret
  mode over e4m3 (``_kernel`` with the fresh K/V, ``_beam_kernel``,
  ``_gqa_kernel``, ``_paged_kernel``), fp32 q, to 1e-5 of the largest
  output.  The columns that no length covers hold zeros there: the
  Pallas kernels multiply a masked probability of 0 by them, and 0 * NaN
  is NaN.  Filled with the NaN byte 0x7F instead, the port's outputs stay
  finite and equal to the zero-filled ones, bit for bit (every mode
  selects masked columns away, as the CUDA kernels do).  The paged
  window and beam reads against the JAX XLA reads at scale 1 (where the
  JAX pool's unscaled e4m3 reads agree with a scaled one);
* the megakernel's plain e4m3 mode against the JAX megakernel in
  interpret mode: Whisper's set (the fresh K/V bytes equal) and the
  decoder-only set (the JAX ``test_megakernel_fp8_kv_matches_scan``
  model: the written cache bytes equal, the logits at 2e-4 / 2e-3);
* Whisper greedy over an e4m3 self cache (``woq8+ckv8+lmq8+sqenc``, the
  per-layer scales from the kv8 calibration's amax) token-exact with the
  JAX pipeline, layer by layer and through the megakernel's plain
  version;
* a CPU rehearsal of ``chip_smoke.py``'s fp8 paths.

Serving and ``GenerationSession`` are in ``test_torch_fp8_serving.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.ops import attention as ja
from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
    paged_decode_attention as j_paged_xla
from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import (
    fused_decode_attention as j_fused,
    paged_decode_attention_pallas as j_paged_pallas)
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQuantMode
from eddie_wang_hackathon2023_tpu.quantization import fp8_layers as jfp8
from eddie_wang_hackathon2023_tpu_torch.ops import attention as pa
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.quantization import fp8_layers as pfp8
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

F8, JF8 = torch.float8_e4m3fn, jnp.float8_e4m3fn


def _t(x):
    return torch.from_numpy(np.array(x))


def _bytes(x):
    """An e4m3 array of either side as its uint8 bytes."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _jf8(t):
    """A torch e4m3 tensor as the same bytes in a JAX e4m3 array."""
    return jnp.asarray(_bytes(t)).view(JF8)


def _e4m3(rs, shape, amax=40.0):
    """Random e4m3 values up to about amax (torch)."""
    return torch.from_numpy(
        (rs.randn(*shape) * amax / 3).astype(np.float32)).to(F8)


def _nan_past(cache, lens, axis=-1):
    """A copy of an e4m3 cache [.., B, .., S] (B its axis 1 after the
    layer axis) whose columns at and past each row's length hold the NaN
    byte 0x7F."""
    u = cache.view(torch.uint8).clone()
    for b, n in enumerate(lens):
        u[:, b, ..., int(n):] = 0x7F
    return u.view(F8)


def _zero_past(cache, lens):
    u = cache.view(torch.uint8).clone()
    for b, n in enumerate(lens):
        u[:, b, ..., int(n):] = 0
    return u.view(F8)


def _err(out, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - ref).max()
                 / np.abs(ref).max())


# -- (a) the cast ---------------------------------------------------------------

def test_cache_cast_bit_equal_to_jax_where_jax_is_finite():
    """2 * 10^5 values across the magnitudes 2^-14 .. 2^6 times a scale,
    both signs, through each side's ``quantize_cache_values``; and every
    byte decoded, NaNs in the same places."""
    rs = np.random.RandomState(0)
    x = (np.exp2(rs.uniform(-14, 6, 200000))
         * rs.choice([-1.0, 1.0], 200000)).astype(np.float32)
    s = np.asarray([3.7], np.float32)
    assert np.abs(x * s).max() < 464
    out = pa.quantize_cache_values(_t(x), F8, _t(s))
    ref = ja.quantize_cache_values(jnp.asarray(x), JF8, jnp.asarray(s))
    assert out.dtype == F8
    np.testing.assert_array_equal(_bytes(out), _bytes(ref))
    every = torch.arange(256, dtype=torch.uint8).view(F8)
    dec = pa.dequantize_cache_values(every, torch.tensor([1.0]),
                                     torch.float32).numpy()
    jdec = np.asarray(jnp.asarray(np.arange(256, dtype=np.uint8)).view(JF8)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(dec, jdec)
    assert np.isnan(dec[0x7F]) and np.isnan(dec[0xFF])
    assert dec[0x7E] == 448.0 and dec[0x01] == 2.0 ** -9


def test_cache_cast_overflow_saturates_where_jax_gives_nan():
    """Past the e4m3 range the JAX cache cast gives NaN (its docstring
    says saturating; its quantize_fp8 clips first); the port gives +-448,
    as the CUDA kernels' cvt.rn.satfinite does."""
    x = np.asarray([480.0, -1000.0, 3e4, -np.inf, np.inf], np.float32)
    one = np.asarray([1.0], np.float32)
    ref = np.asarray(ja.quantize_cache_values(jnp.asarray(x), JF8,
                                              jnp.asarray(one))
                     .astype(jnp.float32))
    out = pa.quantize_cache_values(_t(x), F8, _t(one)).float().numpy()
    assert np.isnan(ref).all()
    np.testing.assert_array_equal(out, [448, -448, 448, -448, 448])
    # inside the range the two agree up to 448's rounding interval
    y = np.asarray([447.0, 450.0, -455.0], np.float32)
    np.testing.assert_array_equal(
        pa.quantize_cache_values(_t(y), F8, _t(one)).float().numpy(),
        np.asarray(ja.quantize_cache_values(jnp.asarray(y), JF8,
                                            jnp.asarray(one))
                   .astype(jnp.float32)))


# -- (b) the FP8 QDQ linears ------------------------------------------------

def test_quantize_fp8_bit_equal_with_its_clip():
    rs = np.random.RandomState(1)
    x = (rs.randn(4096) * 300).astype(np.float32)
    x[:4] = [5000.0, -5000.0, 448.0 * 0.5, 1e-6]
    scale = jfp8.fp8_scales_from_amax(200.0)
    assert pfp8.fp8_scales_from_amax(200.0) == scale
    assert pfp8.FP8_MAX == jfp8.FP8_MAX
    out = pfp8.quantize_fp8(_t(x), scale)
    ref = jfp8.quantize_fp8(jnp.asarray(x), scale)
    np.testing.assert_array_equal(_bytes(out), _bytes(ref))
    assert float(out[0].float()) == 448.0 and float(out[1].float()) == -448
    np.testing.assert_array_equal(
        pfp8.fp8_qdq(_t(x), scale).numpy(),
        np.asarray(jfp8.fp8_qdq(jnp.asarray(x), scale)))
    np.testing.assert_array_equal(
        pfp8.dequantize_fp8(out, scale).numpy(),
        np.asarray(jfp8.dequantize_fp8(ref, scale)))


def _fp8_state(rs, named_shapes):
    state = {}
    for name, shape in named_shapes:
        if name.endswith("scaling_factor"):
            state[name] = np.asarray(
                [jfp8.fp8_scales_from_amax(rs.uniform(1, 6))], np.float32)
        else:
            state[name] = (rs.randn(*shape) * 0.3).astype(np.float32)
    return state


@pytest.mark.parametrize("which", ["linear", "row", "mlp"])
def test_fp8_linears_match_jax(which):
    rs = np.random.RandomState(2)
    if which == "mlp":
        jm = jfp8.FP8MLP(32, 64, "gelu", dtype="float32")
        pm = pfp8.FP8MLP(32, 64, "gelu")
    else:
        jcls, pcls = ((jfp8.FP8Linear, pfp8.FP8Linear) if which == "linear"
                      else (jfp8.FP8RowLinear, pfp8.FP8RowLinear))
        jm, pm = jcls(32, 48, dtype="float32"), pcls(32, 48)
    state = _fp8_state(rs, [(n, p.shape) for n, p in jm.named_parameters()])
    jm.load_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    pm.load_state_dict({k: _t(v) for k, v in state.items()})
    x = (rs.randn(2, 5, 32) * 2).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    out = pm(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


# -- (c) the Attention layer over an e4m3 cache -------------------------------

@torch.inference_mode()
def test_attention_layer_fp8_cache_prefill_and_steps():
    import jax
    from eddie_wang_hackathon2023_tpu.layers import Attention as JAttention
    from eddie_wang_hackathon2023_tpu.layers import AttentionMaskType
    from eddie_wang_hackathon2023_tpu_torch.layers.attention import Attention
    rs = np.random.RandomState(4)
    ja_ = JAttention(32, 4, 64, attention_mask_type=AttentionMaskType.causal,
                     dtype="float32", use_fp8_kv_cache=True)
    ja_.random_init(jax.random.PRNGKey(5), 0.3)
    sd = {k: np.asarray(v) for k, v in ja_.state_dict().items()}
    # K/V up to a few units: inside e4m3's range at 1 / 0.05, where the
    # JAX cache cast is finite
    sd["kv_orig_quant_scale"] = np.asarray([1 / 0.05], np.float32)
    sd["kv_quant_orig_scale"] = np.asarray([0.05], np.float32)
    ja_.load_state_dict(sd, strict=False)
    layer = Attention(32, 4, causal=True, use_fp8_kv_cache=True)
    layer.load_state_dict({k: _t(v) for k, v in sd.items()})
    assert layer.new_kv_cache(2, 16).dtype == F8
    x = rs.randn(2, 6, 32).astype(np.float32)
    jc = ja_.new_kv_cache(2, 16)
    yj, jc = ja_(jnp.asarray(x), past_key_value=jc,
                 sequence_length=jnp.asarray([6, 6]), cache_write_index=0,
                 use_cache=True)
    pc = layer.new_kv_cache(2, 16)[None]
    yp, pc = layer(_t(x), past_key_value=(pc, 0),
                   sequence_length=torch.tensor([6, 6]), cache_write_index=0,
                   use_cache=True)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_array_equal(_bytes(pc[0]), _bytes(jc))
    for step in range(3):
        x1 = rs.randn(2, 1, 32).astype(np.float32)
        n = 7 + step
        yj, jc = ja_(jnp.asarray(x1), past_key_value=jc,
                     sequence_length=jnp.asarray([n, n]),
                     cache_write_index=n - 1, use_cache=True)
        yp, pc = layer(_t(x1), past_key_value=(pc, 0),
                       sequence_length=torch.tensor([n, n]),
                       cache_write_index=n - 1, use_cache=True)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(_bytes(pc[0]), _bytes(jc))


# -- (d) the kernels' plain versions against the Pallas kernels ---------------

KSCALE = 0.05


def _dense_case(rs, B, H, Hq, D, S, lens):
    q = rs.randn(B, Hq, 1, D).astype(np.float32)
    cache = _zero_past(_e4m3(rs, (2, B, 2, H, D, S)), lens)
    fresh = tuple(_e4m3(rs, (B, H, D, 1)) for _ in range(2))
    return q, cache, fresh


@pytest.mark.parametrize("mode", ["kernel1", "gqa"])
def test_plain_decode_matches_pallas_over_e4m3(mode):
    """Kernel 1 (its plain version and the split's step-by-step version at
    1 and 2 slices) and the grouped kernel, fresh K/V, start indices."""
    rs = np.random.RandomState(10 + (mode == "gqa"))
    H, D, S = (4, 32, 64) if mode == "kernel1" else (2, 32, 70)
    Hq = H if mode == "kernel1" else 4 * H
    lens = np.asarray([3, 31, 40, S - 1], np.int32)
    starts = np.asarray([0, 2, 0, 7], np.int32)
    B = len(lens)
    q, cache, fresh = _dense_case(rs, B, H, Hq, D, S, lens)
    seq = lens + 1
    scale = D ** -0.5
    ref = np.asarray(j_fused(
        _jf8(cache), 1, jnp.asarray(q), jnp.asarray(seq), scale,
        kv_quant_orig_scale=jnp.asarray(KSCALE, jnp.float32),
        fresh_kv=tuple(_jf8(f) for f in fresh),
        start_index=jnp.asarray(starts), interpret=True), np.float32)
    kw = dict(kv_quant_orig_scale=torch.tensor(KSCALE), fresh_kv=fresh,
              start_index=_t(starts))

    def plain(c):
        return pdec.plain_decode_attention(c, 1, _t(q), _t(seq), scale, **kw)
    out = plain(cache)
    assert _err(out, ref) < 1e-5
    nan = _nan_past(cache, lens)
    out_nan = plain(nan)
    assert torch.isfinite(out_nan).all() and torch.equal(out_nan, out)
    if mode == "kernel1":
        for splits in (1, 2):
            sp = pdec.plain_split_decode_attention(nan, 1, _t(q), _t(seq),
                                                   scale, splits=splits, **kw)
            assert torch.isfinite(sp).all() and _err(sp, ref) < 1e-5


def test_plain_beam_matches_pallas_beam_kernel_over_e4m3():
    rs = np.random.RandomState(12)
    groups, bw, H, D, S = 2, 3, 2, 32, 48
    B = groups * bw
    lens = np.repeat(np.asarray([17, 40], np.int32), bw)
    q, cache, fresh = _dense_case(rs, B, H, H, D, S, lens)
    ind = rs.randint(0, bw, (groups, bw, S)).astype(np.int32)
    seq = lens + 1
    scale = D ** -0.5
    ref = np.asarray(j_fused(
        _jf8(cache), 0, jnp.asarray(q), jnp.asarray(seq), scale,
        kv_quant_orig_scale=jnp.asarray(KSCALE, jnp.float32),
        fresh_kv=tuple(_jf8(f) for f in fresh),
        beam_indirection=jnp.asarray(ind), interpret=True), np.float32)

    def plain(c):
        return pdec.plain_decode_attention(
            c, 0, _t(q), _t(seq), scale, torch.tensor(KSCALE), fresh,
            beam_indirection=_t(ind))
    out = plain(cache)
    assert _err(out, ref) < 1e-5
    out_nan = plain(_nan_past(cache, lens))
    assert torch.isfinite(out_nan).all() and torch.equal(out_nan, out)


def _pool_case(rs, hkv, L=2, T=8, D=16, NBLK=24, MB=5):
    seq = np.asarray([1, T - 1, T, T + 1, MB * T], np.int32)
    B = len(seq)
    pool = _e4m3(rs, (L, NBLK, 2, hkv, T, D))
    perm = rs.permutation(NBLK)
    table = np.full((B, MB), -1, np.int32)
    k = 0
    for i in range(B):
        nb = -(-int(seq[i]) // T)
        table[i, :nb] = perm[k:k + nb]
        k += nb
    return pool, table, seq


def _nan_pool_past(pool, table, seq):
    """The pool with every token slot that no row's length covers (in its
    own blocks, and every block no table names) at the NaN byte."""
    T = pool.shape[-2]
    u = pool.view(torch.uint8).clone()
    covered = torch.zeros(pool.shape[1], T, dtype=torch.bool)
    for row, n in zip(table, seq):
        for t in range(int(n)):
            covered[row[t // T], t % T] = True
    u[_slots(~covered, u)] = 0x7F
    return u.view(F8), covered


def _slots(mask, pool):
    """A [N, T] mask of token slots over a pool [L, N, 2, Hkv, T, D]."""
    return mask[None, :, None, None, :, None].expand(pool.shape)


@pytest.mark.parametrize("hkv,h", [(2, 2), (1, 4)])
def test_plain_paged_matches_pallas_paged_kernel_over_e4m3(hkv, h):
    rs = np.random.RandomState(41 + hkv)
    pool, table, seq = _pool_case(rs, hkv)
    D = pool.shape[-1]
    q = rs.randn(len(seq), h, 1, D).astype(np.float32)
    nan_pool, covered = _nan_pool_past(pool, table, seq)
    u = pool.view(torch.uint8).clone()
    u[_slots(~covered, u)] = 0
    pool = u.view(F8)
    scale = D ** -0.5
    ref = np.asarray(j_paged_pallas(
        _jf8(pool), 1, jnp.asarray(q), jnp.asarray(table), jnp.asarray(seq),
        scale, kv_quant_orig_scale=jnp.asarray(KSCALE, jnp.float32),
        interpret=True), np.float32)
    out = pdec.plain_paged_decode_attention(
        pool, 1, _t(q), _t(table), _t(seq), scale, torch.tensor(KSCALE))
    assert _err(out, ref) < 1e-5
    out_nan = pdec.plain_paged_decode_attention(
        nan_pool, 1, _t(q), _t(table), _t(seq), scale, torch.tensor(KSCALE))
    assert torch.isfinite(out_nan).all() and torch.equal(out_nan, out)


def test_plain_paged_window_and_beam_match_jax_xla_at_scale_1():
    """The window and beam reads of an e4m3 pool against the JAX XLA
    reads, which cast e4m3 without the scale: at scale 1 they agree."""
    rs = np.random.RandomState(44)
    pool, table, seq = _pool_case(rs, 2, L=1)
    D = pool.shape[-1]
    B = len(seq)
    one = torch.tensor(1.0)
    W = 3
    q = rs.randn(B, 2, W, D).astype(np.float32)
    off = np.maximum(seq - W, 0).astype(np.int32)
    ref = np.asarray(j_paged_xla(
        jnp.asarray(q), _jf8(pool[0]), jnp.asarray(table), jnp.asarray(seq),
        D ** -0.5, kv_quant_orig_scale=jnp.asarray(1.0),
        causal_offset=jnp.asarray(off)))
    out = pdec.plain_paged_window_attention(pool, 0, _t(q), _t(table),
                                            _t(seq), _t(off), D ** -0.5, one)
    assert _err(out, ref) < 1e-5
    # beams: 1 group of the first 4 rows (their lengths made equal)
    bw = 4
    seq_b = np.full((bw,), 7, np.int32)
    ind = rs.randint(0, bw, (1, bw, 16)).astype(np.int32)
    qb = rs.randn(bw, 2, 1, D).astype(np.float32)
    tb = table[:bw, :2]
    ref = np.asarray(j_paged_xla(
        jnp.asarray(qb), _jf8(pool[0]), jnp.asarray(tb), jnp.asarray(seq_b),
        D ** -0.5, kv_quant_orig_scale=jnp.asarray(1.0),
        beam_indirection=jnp.asarray(ind)))
    out = pdec.plain_paged_beam_attention(pool, 0, _t(qb), _t(tb),
                                          _t(seq_b), _t(ind), D ** -0.5, one)
    assert _err(out, ref) < 1e-5


# -- (e) the megakernel's plain e4m3 mode -------------------------------------

@pytest.mark.parametrize("s_self,seq", [(160, 5), (448, 300)])
def test_whisper_megakernel_plain_e4m3_matches_jax_kernel(s_self, seq):
    """Whisper's set (the JAX package's megakernel test decoder, d 256, 4
    heads of 64, 3 layers) over an e4m3 self cache with per-layer scales
    and the int8 cross cache: the fresh K/V bytes equal, the hidden state
    within the float mode's tolerance (test_torch_megakernel)."""
    import test_torch_megakernel as tm
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import (
        fused_decoder_stack as j_stack, pack_decoder_blobs as j_pack)
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    rs = np.random.RandomState(seq)
    x = rs.randn(1, tm.D).astype(np.float32)
    cache = _e4m3(rs, (tm.L, 1, 2, tm.H, tm.HD, s_self), amax=200.0)
    step = np.asarray([[0.005], [0.006], [0.0055]], np.float32)
    state = {**tm.BLOCK_STATE, "attn.kv_orig_quant_scale": 1.0 / step,
             "attn.kv_quant_orig_scale": step}
    cross, scales = tm._cross(True)
    hid_j, fresh_j = j_stack(
        jnp.asarray(x), j_pack(state, **tm.PACK_KW), _jf8(cache),
        jnp.asarray([seq], jnp.int32), tm.SCALE,
        cross_cache=jnp.asarray(cross), cross_scale=jnp.asarray(scales),
        head_dim=tm.HD)
    hid, fresh = mk.fused_decoder_stack(
        _t(x), mk.pack_decoder_blobs(state, **tm.PACK_KW), cache,
        torch.tensor([seq], dtype=torch.int32), tm.SCALE,
        cross_cache=_t(cross), cross_scale=_t(scales), head_dim=tm.HD)
    assert fresh.dtype == F8 and np.asarray(fresh_j).dtype == JF8
    np.testing.assert_array_equal(_bytes(fresh), _bytes(fresh_j))
    assert np.abs(fresh.float().numpy()).max() > 32     # the range is used
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j),
                               rtol=tm.RTOL, atol=tm.ATOL)


@functools.lru_cache(maxsize=None)
def _decoder_only_fp8():
    """The JAX package's fp8 megakernel test model
    (tests/test_megakernel.py:838): d 128, 2 heads of 64, 2 layers, kv
    scales 4 / 0.25; the port's model from the same state."""
    import jax
    from eddie_wang_hackathon2023_tpu.models.decoder import (
        DecoderConfig as JConfig, DecoderLMHead as JModel)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state)
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    kw = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
              ffn_hidden_size=256, position_embedding="learned",
              dtype="float32")
    jm = JModel(JConfig(**kw, quant_mode=JQuantMode(0).set_fp8_kv_cache()))
    jm.random_init(jax.random.PRNGKey(3), 0.05)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    sd["blocks.attention.kv_orig_quant_scale"] = np.full((2, 1), 4.0,
                                                         np.float32)
    sd["blocks.attention.kv_quant_orig_scale"] = np.full((2, 1), 0.25,
                                                         np.float32)
    jm.load_state_dict(sd, strict=False)
    pc = DecoderConfig(**kw, quant_mode=QuantMode(0).set_fp8_kv_cache())
    return jm, from_jax_state(sd, pc, device="cpu"), sd


@torch.inference_mode()
def test_decoder_only_megakernel_plain_e4m3_matches_jax():
    """The JAX test's step through each side's megakernel (the JAX kernel
    in interpret mode): the cache written by the step equal byte for byte
    on both sides and to the layer-by-layer step's, the logits within the
    JAX test's 2e-4 / 2e-3."""
    from eddie_wang_hackathon2023_tpu.plugin import plugin_config
    jm, pm, _ = _decoder_only_fp8()
    assert pm.megakernel_eligible()
    jblobs = jm.megakernel_blobs(_decoder_only_fp8()[2])
    pblobs = pm.megakernel_blobs()
    prompt = [[5, 9, 2, 7]]
    jc = jm.new_kv_cache(1, 32)
    jl, jc = jm(jnp.asarray(prompt, jnp.int32), jc, 0,
                jnp.asarray([4], jnp.int32))
    pc = pm.new_kv_cache(1, 32)
    assert pc.dtype == F8
    pl_, pc = pm(torch.tensor(prompt), pc, 0, torch.tensor([4]))
    np.testing.assert_array_equal(_bytes(pc), _bytes(jc))
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    assert tok == int(pl_[0, -1].argmax())
    with plugin_config(decode_megakernel=True):
        mj, mjc = jm(jnp.asarray([[tok]], jnp.int32), jc, 4,
                     jnp.asarray([5], jnp.int32), megakernel_blobs=jblobs)
    ref_l, ref_c = pm(torch.tensor([[tok]]), pc.clone(), 4,
                      torch.tensor([5]))
    mp, mpc = pm(torch.tensor([[tok]]), pc.clone(), 4, torch.tensor([5]),
                 megakernel_blobs=pblobs)
    np.testing.assert_array_equal(_bytes(mpc), _bytes(mjc))
    np.testing.assert_array_equal(_bytes(mpc), _bytes(ref_c))
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(mp.numpy(), ref_l.numpy(), rtol=2e-4,
                               atol=2e-3)


# -- (f) Whisper greedy over an e4m3 self cache ---------------------------------

FP8_RECIPE = "woq8+ckv8+lmq8+sqenc"


@functools.lru_cache(maxsize=None)
def _fp8_steps(which):
    """Per-layer e4m3 scales s = fp8_scales_from_amax(amax), amax the
    per-layer value the kv8 calibration measures (its step times 127)."""
    import test_torch_kv8 as tk
    amax = tk._kv_step(which) * 127.0
    return np.asarray([pfp8.fp8_scales_from_amax(a) for a in amax],
                      np.float32)


def _build_fp8(which):
    """(JAX pipeline, port modules) of FP8_RECIPE with the e4m3 self cache
    on both sides, scales 1 / s and s stored as the kv8 steps are."""
    import test_torch_kv8 as tk
    from eddie_wang_hackathon2023_tpu_torch.models._state import \
        unstack_blocks
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        Recipe, from_jax_state)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        WhisperDecoder
    from test_torch_whisper import _jax_build
    kw = (dict(jcfg=tk.MK_JCFG, float_states=tk.MK_STATES) if which == "mk"
          else {})
    pcfg = tk.MK_PCFG if which == "mk" else tk.PCFG
    # _jax_build's kv8 branch, with the fp8 mode in place of int8
    set_int8 = JQuantMode.set_int8_kv_cache
    JQuantMode.set_int8_kv_cache = JQuantMode.set_fp8_kv_cache
    try:
        jpipe, (enc_sd, dec_sd, ckv_sd) = _jax_build(
            FP8_RECIPE + "+kv8", kv_step=_fp8_steps(which), **kw)
    finally:
        JQuantMode.set_int8_kv_cache = set_int8
    assert jpipe.decoder.new_kv_cache(1).dtype == JF8
    scales = {k: dec_sd.pop(k) for k in list(dec_sd) if "kv_" in k}
    enc, dec, ckv = from_jax_state(enc_sd, dec_sd, ckv_sd, pcfg,
                                   recipe=FP8_RECIPE, device="cpu")
    mode = Recipe.parse(FP8_RECIPE).decoder.set_fp8_kv_cache()
    with torch.device("cpu"):
        fdec = WhisperDecoder(pcfg, mode, quantize_lm_head=True)
    fdec.load_state_dict(unstack_blocks({**dec_sd, **scales}))
    return jpipe, (enc, fdec.eval(), ckv), pcfg


def test_decoder_state_dict_with_fp8_scales_equals_jax():
    """The converter stores the e4m3 scales as it stores kv8's steps: 1 / s
    and s under the attention's names, array for array the JAX
    converter's."""
    import test_torch_kv8 as tk
    from eddie_wang_hackathon2023_tpu.models.whisper.convert import \
        decoder_state_dict as j_decoder_state_dict
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.convert import \
        decoder_state_dict
    sd = tk._smoke().random_openai_state(np, tk.PCFG,
                                         np.random.default_rng(4))
    s = np.asarray([jfp8.fp8_scales_from_amax(a) for a in (3.1, 17.5)],
                   np.float32)
    ref = j_decoder_state_dict(sd, tk.JCFG, int8_kv_scales=s)
    out = decoder_state_dict(sd, tk.PCFG, int8_kv_scales=s)
    assert sorted(out) == sorted(ref)
    for k in ref:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    np.testing.assert_array_equal(
        out["blocks.attn.kv_quant_orig_scale"][:, 0], s)


@pytest.mark.parametrize("which", ["tiny", "mk"], ids=["layers",
                                                       "megakernel"])
def test_fp8_whisper_greedy_token_exact(which):
    import test_torch_kv8 as tk
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
        DecodingOptions, WhisperPipeline)
    jpipe, mods, pcfg = _build_fp8(which)
    pipe = WhisperPipeline(pcfg, *mods, DecodingOptions(
        language="en", sample_len=tk.SAMPLE_LEN),
        decode_megakernel=which == "mk")
    assert pipe.decoder.new_kv_cache(1).dtype == F8
    if which == "mk":
        assert pipe._megakernel_blobs() is not None
    tk._assert_same(pipe.transcribe(tk.MEL), jpipe.transcribe(tk.MEL))


# -- (g) chip_smoke.py's fp8 paths, rehearsed ---------------------------------

def test_chip_smoke_fp8_paths_on_cpu(one_cpu_thread):  # noqa: F811
    """``chip_smoke.py``'s fp8 path on the CPU at the megakernel's Whisper
    (heads of 64): the decoder rebuilt on the main model's weights
    (shared) with an e4m3 self cache at scales from amax values, greedy
    through the megakernel's plain version, replayed against the plain
    scanned path, in turns with main; then its decoder_fp8 path (the
    decoder-only model with an e4m3 cache, its scales from a woq8 run's
    cache amax).  No kernel is launched from CPU tensors."""
    import dataclasses

    import test_torch_kv8 as tk
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        BENCH_RECIPE, WhisperConfig)
    smoke = tk._smoke()
    cfg = WhisperConfig(**{**tk.MK_DIMS, "n_text_ctx": 96})
    built = smoke.build_whisper(torch, np, cfg, "cpu", BENCH_RECIPE, "main")
    main, _ = smoke.main_path(torch, np, device="cpu", decode_megakernel=True,
                              label="main", built=built, slope=False)
    amax = smoke.self_kv_amax(torch, np, built, "cpu")
    assert amax.shape == (2,) and (amax > 0).all()
    e2e, counts = smoke.fp8_path(torch, np, built, amax, main, device="cpu")
    assert e2e["megakernel"] and e2e["logits_rel_err"] < 5e-2
    assert set(counts.values()) == {0}
    assert 0.0 <= e2e["tokens_equal_main"] <= 1.0
    assert [len(w) for w in e2e["in_turns_ms_per_utt"].values()] == [3, 3]
    assert built["dec"].blocks[0].attn.use_fp8_kv_cache is False
    dcfg = dataclasses.replace(
        smoke.santacoder_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128)
    state = smoke.random_decoder_state(torch, np, dcfg,
                                       np.random.default_rng(0))
    woq8, _ = smoke.decoder_path(torch, np, config=dcfg, device="cpu",
                                 float_state=state)
    e2e, counts = smoke.decoder_path(
        torch, np, config=dataclasses.replace(
            dcfg, quant_mode=dcfg.quant_mode.set_fp8_kv_cache()),
        device="cpu", label="decoder_fp8", float_state=state,
        kv_scales=[pfp8.fp8_scales_from_amax(a)
                   for a in woq8["kv_amax_after_prefill"]])
    assert set(counts.values()) == {0}
    assert e2e["logits_rel_err"] == 0.0 and e2e["tokens_per_s"] > 0
