"""Kernel 1's split over a thread-block cluster, on the CPU: the plain
version of its arithmetic, ``plain_split_decode_attention``, against the
JAX package, with the same numpy-seeded inputs on both sides.

* against the Pallas ``_kernel`` in interpret mode run as one chunk
  (``chunk=S``: one max over the whole row, as the cluster's), fp32 q so
  that P is not rounded, to 1e-6 of the largest output (fp32 sums in
  another order); over 1, 2, 6 and 8 slices, int8 and bf16 caches, with
  and without the fresh column, lengths at slice edges and a start inside
  a slice;
* against the plain version (``plain_decode_attention``) in bf16, to 2e-2
  of the largest output (the card tests' bf16 gate: P rounded against
  the max, not after the normalisation, and a bf16 output);
* P rounded to bf16 against the row's max (the construction of
  ``test_decode_kernel_rounds_p_before_pv``: a fp64 reference that rounds
  P equals it, one that does not differs in every element);
* the number of slices and their width, from the static S."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import \
    fused_decode_attention as j_fused
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(rs, cache_kind, B, H, D, S, q_dtype=np.float32):
    """q [B,H,1,D], the cache [2,B,2,H,D,S] and the fresh K/V [B,H,D,1] as
    numpy, with the cache's dequant scale (None for a float cache)."""
    q = rs.randn(B, H, 1, D).astype(q_dtype)
    if cache_kind == "int8":
        cache = rs.randint(-127, 128, (2, B, 2, H, D, S)).astype(np.int8)
        fresh = tuple(rs.randint(-127, 128, (B, H, D, 1)).astype(np.int8)
                      for _ in range(2))
        return q, cache, fresh, np.asarray(0.02, np.float32)
    cache = rs.randn(2, B, 2, H, D, S).astype(np.float32)
    fresh = tuple(rs.randn(B, H, D, 1).astype(np.float32) for _ in range(2))
    return q, cache, fresh, None


def _as_cache(x, kind, lib):
    """A numpy cache operand in its dtype for jax ("jax") or torch."""
    if kind != "bf16":
        return jnp.asarray(x) if lib == "jax" else _t(x)
    return (jnp.asarray(x).astype(jnp.bfloat16) if lib == "jax"
            else _t(x).bfloat16())


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("cache_kind", ["int8", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 6, 8])
def test_plain_split_matches_pallas_kernel_one_chunk(splits, cache_kind,
                                                     fresh):
    rs = np.random.RandomState(100 * splits + 10 * (cache_kind == "bf16")
                               + fresh)
    H, D, S = 3, 16, 64
    W = pdec.split_width(S, splits)
    # lengths of the cache at the edges of the first slice and all of S;
    # starts inside the first slice and, in the last row, past it (its
    # columns all masked; one slice: one valid column); no row wholly
    # masked (the JAX kernel divides 0 by 0 there)
    lens = np.minimum(np.asarray([1, W - 1, W, W + 1, S], np.int32), S)
    starts = np.asarray([0, 0, 1, W // 2 + 1, min(W + 3, S - 1)], np.int32)
    B = len(lens)
    q, cache, fkv, kscale = _inputs(rs, cache_kind, B, H, D, S)
    seq = lens + int(fresh)
    scale = D ** -0.5
    ref = j_fused(_as_cache(cache, cache_kind, "jax"), 1, jnp.asarray(q),
                  jnp.asarray(seq), scale,
                  kv_quant_orig_scale=None if kscale is None
                  else jnp.asarray(kscale),
                  fresh_kv=tuple(_as_cache(f, cache_kind, "jax")
                                 for f in fkv) if fresh else None,
                  start_index=jnp.asarray(starts), chunk=S, interpret=True)
    out = pdec.plain_split_decode_attention(
        _as_cache(cache, cache_kind, "torch"), 1, _t(q), _t(seq), scale,
        kv_quant_orig_scale=None if kscale is None else _t(kscale),
        fresh_kv=tuple(_as_cache(f, cache_kind, "torch") for f in fkv)
        if fresh else None, start_index=_t(starts), splits=splits)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape == (B, H, 1, D)
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("splits", [1, 2, 6, 8])
def test_plain_split_matches_plain_version_in_bf16(splits):
    """bf16 q over an int8 cross-like cache (no fresh) and a bf16 self-like
    one (fresh, start): within the bf16 gate of plain_decode_attention."""
    rs = np.random.RandomState(7 + splits)
    H, D, S = 4, 32, 96
    for kind, fresh, lens, starts in (
            ("int8", False, [96, 50, 1], None),
            ("bf16", True, [40, 95, 0], [0, 30, 0])):
        q, cache, fkv, kscale = _inputs(rs, kind, len(lens), H, D, S)
        kw = dict(kv_quant_orig_scale=None if kscale is None
                  else _t(kscale))
        if fresh:
            kw["fresh_kv"] = tuple(_as_cache(f, kind, "torch") for f in fkv)
        if starts is not None:
            kw["start_index"] = torch.tensor(starts)
        seq = torch.tensor(lens, dtype=torch.int32) + int(fresh)
        c = _as_cache(cache, kind, "torch")
        qb = _t(q).bfloat16()
        out = pdec.plain_split_decode_attention(c, 0, qb, seq, 0.125,
                                                splits=splits, **kw)
        ref = pdec.plain_decode_attention(c, 0, qb, seq, 0.125, **kw)
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        err = float((out.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
        assert err < 2e-2, (kind, err)


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_plain_split_rounds_p_against_the_row_max(cache_dtype):
    """One key scores s0 above the other 1499, whose probability
    exp(-s0) = 0.25088 sits 0.45 of a bf16 step above 0.25, and every value
    column is the same: the context is c (1 + 1499 bf16(p)) / (1 + 1499 p)
    = 0.9965 c with P rounded before P·V, and c without.  Over six slices
    of 252 the key of s0 is in the first: rounded against each slice's own
    max (0 past the first slice, where p = 1 rounds exactly and is scaled
    afterwards), only 251 columns would be rounded, and the output would be
    c as well."""
    H, D, S = 2, 64, 1500
    p_other = 128.45 * 2.0 ** -9
    scale = -float(np.log(p_other))
    cache = torch.zeros(1, 1, 2, H, D, S, dtype=cache_dtype)
    cache[0, 0, 0, :, 0, 0] = 1
    c = (torch.arange(D) % 7 + 1).to(cache_dtype)
    cache[0, 0, 1] = c[None, :, None]
    q = torch.zeros(1, H, 1, D, dtype=torch.bfloat16)
    q[..., 0] = 1
    kw = (dict(kv_quant_orig_scale=torch.tensor(1.0))
          if cache_dtype == torch.int8 else {})
    seq = torch.tensor([S], dtype=torch.int32)
    out = pdec.plain_split_decode_attention(
        cache, 0, q, seq, scale, splits=pdec.decode_splits(S), **kw)[:, :, 0]
    p = torch.full((S - 1,), float(np.exp(-scale)), dtype=torch.float64)
    n_first = pdec.split_width(S, pdec.decode_splits(S)) - 1
    c64 = c.double()
    rounded = p.float().bfloat16().double()
    per_slice = torch.cat([rounded[:n_first], p[n_first:]])
    for pv, equal in ((rounded, True), (p, False), (per_slice, False)):
        ref = (c64 * (1 + pv.sum()) / (1 + p.sum())).to(torch.bfloat16)
        if equal:
            assert torch.equal(out, ref[None].expand_as(out))
        else:
            assert bool((out != ref[None]).all())


@pytest.mark.parametrize("S,splits,width", [
    (1500, 6, 252), (448, 2, 224), (4, 1, 4), (2048, 8, 256),
    (4096, 8, 512)])
def test_split_count_and_width_come_from_s(S, splits, width):
    """ceil(S / 256) slices capped at 8, each ceil(S / slices) columns
    rounded up to 4; together they cover S and no slice is empty."""
    assert pdec.decode_splits(S) == splits
    assert pdec.split_width(S, splits) == width
    assert splits * width >= S > (splits - 1) * width
