"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip.  On a machine with one (and no
jax), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels keep fp32 softmax and accumulators and write bf16;
they are held against the plain version computed in fp32 from the same
bf16/int8 inputs, to 1e-2 of the largest output magnitude (a few bf16
roundings), and against the bf16 plain version to 2e-2.  Kernel 1's
rounding of P to bf16 before P·V is pinned exactly, on an input where that
rounding moves every output by a bf16 step.  The fp32 entry of
the flash kernel is held to 1e-4 of the fp32 plain version (fp32 accuracy
from split bf16 products).  The megakernel is held against its plain
version in bf16 to 1e-2 on one layer, 3e-2 on three and 5e-2 on 32
(roundings of the bf16 residual stream that differ by one step compound
over layers), with int8 and bf16 cross caches and self caches empty, at
the main path's 44 and at the edges of a 256-column slice; 100 launches in
a row are bit-equal (a fixed sum order: a barrier that let a block run
ahead would show).  Its int8 self mode (kv8) is held as the bf16 mode on
1, 2 and 32 layers at sequence 1, 44 and 448, its int8 fresh K/V equal to
the plain version's on one layer and within a step (2 layers) or the
bf16 mode's gate (32 layers) after it, and two calls bit-equal.  The
beam entry of kernel 1 is held to the same gates as kernel 1, and its
rounding of P before P·V is pinned the same way, through a mixing
indirection; so is the grouped (MQA/GQA) kernel, with the fresh column, and
the paged kernel, through a permuted block table.  The int4 dequant matmul
is held to the same gates (2e-2 bf16, 1e-2 fp32) at the SantaCoder-1B
shapes and the edges of its tiles, its decode entry at M 1, 8, 17 and 32
per channel, in one group and in groups of 128, and its two rounding rules
(the group scale rounded to bf16 before it scales the weight; the
per-channel scale in fp32 on the accumulator) are pinned bit for bit with
one-hot rows of x through both entries.
The causal mode of the flash kernel is held to the same gates as its
non-causal mode (its mask is ``causal_bias``'s, bottom-right), its bf16
entry under every plan it takes (keys over 1-4 warps) and refusing the
plans it does not.  The user
kernel of ``examples/custom_kernel_torch`` sums in fp32 whatever its
operands' type (its bf16 entry on the tensor cores, P as two bf16 terms;
its fp32 entry as three tf32 products, 3xTF32):
held to 1e-5 of the fp32 plain version with fp32 operands (views whose
rows start on 4 bytes included) and 1e-2 with
bf16 ones (its bf16 output rounds once), in both variants of the bf16
entry (short, tiled).  The grouped kernel is held to kernel 1's gates over
rep 1-32, head dims 64, 80 and 128, and S in one round or split over a
cluster.  The paged kernel is held to the same gates at rep 1, 4 and 16,
head dims 64 and 128, blocks of 16 and 32 tokens and table widths 1-8
(split over a cluster from 5 blocks of 32), at every length from 0 to a
full table of 4 blocks, under plans other than its wrapper's, and refusing
plans it does not take, and its window entry (mixed admission) at the
same gates with windows of 16 at offsets on and off the block edges over
a table of 9 blocks (a row of seq 0 zeros); the dense serving tick (kernel
2's causal mode in each admission, kernel 1 in each step) against the
plain versions as ``chip_smoke.py`` replays it; the beam entry at beam
widths 1 to 24 (one tile
of 16 query beams or two), one and two groups, lengths that fill one
slice, cross into the next, fill the cache, starts inside a slice or
masking one, and S 1500 walked in rounds; at head dim 128 and S 1500 with
the source rows staged in rounds and three tiles of query beams; from a
cache that starts on any element; and refusing plans it does not take.  The megakernel
probes of ``tools/megakernel_probes.py`` sum in fp32 in another order than
their plain versions and round once to bf16: held within one bf16 step
(|out - ref| <= 2^-7 |ref| + 1e-5 max|ref|), the relayout's per-panel
totals within 1e-2."""
import contextlib
import ctypes
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.ops import _build
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import (
    unpack_int4, weight_only_quant_matmul)
from eddie_wang_hackathon2023_tpu_torch.ops.paged_attention import (
    paged_append_kv, paged_prefill)

pytestmark = pytest.mark.cuda

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import megakernel_probes as mp  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "fmha_cuda", os.path.join(os.path.dirname(__file__), "..", "examples",
                              "custom_kernel_torch", "fmha_cuda.py"))
ck = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ck)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(out, ref):
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("kind", ["int8_cross_proj", "bf16_fresh_start"])
def test_decode_kernel_matches_plain(dev, kind):
    g = torch.Generator(device=dev).manual_seed(0)
    L, B, H, D, S, N = 3, 2, 4, 64, 300, 96
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    w = torch.randint(-127, 128, (L, H * D, N), generator=g, device=dev,
                      dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=dev) * 1e-3
    wb = torch.randn(N, generator=g, device=dev).bfloat16()
    if kind == "int8_cross_proj":
        cache = torch.randint(-127, 128, (L, B, 2, H, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        kw = dict(kv_quant_orig_scale=torch.tensor(0.03, device=dev))
        seq = torch.full((B,), S, dtype=torch.int32, device=dev)
        proj = (w, ws, wb)
    else:
        cache = torch.randn(L, B, 2, H, D, S, generator=g,
                            device=dev).bfloat16()
        fresh = tuple(torch.randn(B, H, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        kw = dict(fresh_kv=fresh,
                  start_index=torch.tensor([0, 7], device=dev))
        seq = torch.tensor([40, 260], device=dev)
        proj = None
    before = dict(da.launches)
    out = da.fused_decode_attention(cache, 1, q, seq, D ** -0.5, proj=proj,
                                    **kw)
    assert sum(da.launches.values()) > sum(before.values())
    kw32 = {k: (tuple(t.float() for t in v) if k == "fresh_kv" else v)
            for k, v in kw.items()}
    ref = da.plain_decode_attention(
        cache if cache.dtype == torch.int8 else cache.float(), 1, q.float(),
        seq, D ** -0.5, proj=None if proj is None
        else (w, ws, wb.float()), **kw32)
    ref16 = da.plain_decode_attention(cache, 1, q, seq, D ** -0.5,
                                      proj=proj, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


def _chunked_ctx(cache, layer, q, n, scale, kscale, round_p, chunk=1024,
                 fresh=None):
    """Kernel 1's context [B, H, D] in fp64, with its online softmax over
    chunks of ``chunk`` columns: P·V takes the unnormalised exp(s - running
    max) rounded to bf16 (``round_p``, as ``pallas_decode_attention.py:149``
    does) or kept unrounded; the denominator sums the unrounded values.
    ``fresh`` (k, v) [B, H, D] adds the current token's column last, in
    full precision, as the kernel does."""
    k, v = (cache[layer, :, i, ..., :n].double() for i in (0, 1))
    s = torch.einsum("bhd,bhds->bhs", q[:, :, 0].double(), k) \
        * (scale * kscale)
    m = torch.full(s.shape[:2], -1e30, dtype=torch.float64, device=s.device)
    tot = torch.zeros_like(m)
    acc = torch.zeros(k.shape[:3], dtype=torch.float64, device=s.device)
    for c0 in range(0, n, chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        pv = p.float().bfloat16().double() if round_p else p
        alpha = torch.exp(m - m_new)
        tot = tot * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhs,bhds->bhd", pv, v[..., c0:c0 + chunk])
        m = m_new
    if fresh is not None:
        fk, fv = (t.double() for t in fresh)
        s_f = (q[:, :, 0].double() * fk).sum(-1) * (scale * kscale)
        m_fin = torch.maximum(m, s_f)
        alpha, p_f = torch.exp(m - m_fin), torch.exp(s_f - m_fin)
        tot = tot * alpha + p_f
        acc = acc * alpha[..., None] + p_f[..., None] * fv
    return acc / tot[..., None] * kscale


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_decode_kernel_rounds_p_before_pv(dev, cache_dtype):
    """One key scores s0 above the other 1499, whose probability
    exp(-s0) = 0.25088 sits 0.45 of a bf16 step above 0.25, and every value
    column is the same: the context is then c (1 + 1499 bf16(p)) /
    (1 + 1499 p) = 0.9965 c with P rounded before P·V, and c without.  The
    kernel's bf16 output must be the first, not the second."""
    H, D, S = 2, 64, 1500
    p_other = 128.45 * 2.0 ** -9
    scale = -float(np.log(p_other))
    cache = torch.zeros(1, 1, 2, H, D, S, device=dev, dtype=cache_dtype)
    cache[0, 0, 0, :, 0, 0] = 1
    c = (torch.arange(D, device=dev) % 7 + 1).to(cache_dtype)
    cache[0, 0, 1] = c[None, :, None]
    q = torch.zeros(1, H, 1, D, device=dev, dtype=torch.bfloat16)
    q[..., 0] = 1
    kw = (dict(kv_quant_orig_scale=torch.tensor(1.0, device=dev))
          if cache_dtype == torch.int8 else {})
    seq = torch.tensor([S], dtype=torch.int32, device=dev)
    out = da.fused_decode_attention(cache, 0, q, seq, scale, **kw)[:, :, 0]
    ref16, ref32 = (_chunked_ctx(cache, 0, q, S, scale, 1.0, r).to(
        torch.bfloat16) for r in (True, False))
    torch.cuda.synchronize()
    assert torch.equal(out, ref16)
    assert bool((out != ref32).all())


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_decode_kernel_matches_chunked_reference(dev, cache_dtype):
    """Random inputs over two chunks: within the bf16 output's rounding
    (2^-8 of the largest output) of the chunked reference."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, D, S = 1, 4, 64, 1500
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    if cache_dtype == torch.int8:
        cache = torch.randint(-127, 128, (1, B, 2, H, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        kscale = 1 / 40.0
        kw = dict(kv_quant_orig_scale=torch.tensor(kscale, device=dev))
    else:
        cache = torch.randn(1, B, 2, H, D, S, generator=g,
                            device=dev).bfloat16() * 2
        kscale, kw = 1.0, {}
    seq = torch.full((B,), S, dtype=torch.int32, device=dev)
    out = da.fused_decode_attention(cache, 0, q, seq, 0.125, **kw)[:, :, 0]
    ref = _chunked_ctx(cache, 0, q, S, 0.125, kscale, True)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 2.0 ** -8


# kernel 1's split over a cluster: (dtype, S, lengths per row (cache columns
# before the fresh one), starts, fresh, head dim); S = 1500 is 4 modulo 16
# (6 slices of 252), 448 is 0 modulo 16 (2 slices of 224)
_SPLIT_CASES = {
    # lengths at 256-column and slice edges, batch 7, no fresh column
    "int8_1500_edges": (torch.int8, 1500, [1, 4, 255, 256, 257, 1499, 1500],
                        None, False, 64),
    "bf16_1500_edges_fresh": (torch.bfloat16, 1500,
                              [1, 4, 251, 252, 253, 1499, 1500], None, True,
                              64),
    # batch 5: a start inside slice 1, a start that masks all of slice 0,
    # nothing cached with the fresh column only, a start past the length
    "int8_1500_starts_fresh": (torch.int8, 1500, [700, 1500, 0, 300, 1500],
                               [260, 300, 0, 400, 0], True, 64),
    "bf16_448_starts": (torch.bfloat16, 448, [44, 448, 224, 225, 1],
                        [3, 224, 0, 224, 0], False, 64),
    "int8_448_fresh_b1": (torch.int8, 448, [43], None, True, 64),
    # the kv8 self call: an int8 cache with the fresh column, lengths at
    # the two slices' edge (224) and the cache's end
    "int8_448_self_edges": (torch.int8, 448, [447, 224, 223, 0], None, True,
                            64),
    "bf16_1500_b1": (torch.bfloat16, 1500, [1500], None, False, 64),
    # the head dims of the kernel's other instantiation (128) and below 64;
    # S = 2600: 8 slices of 328, more than one round of 256 columns each
    "bf16_2600_d128_fresh": (torch.bfloat16, 2600, [2600, 330, 1],
                             [0, 0, 0], True, 128),
    "int8_300_d40": (torch.int8, 300, [300, 151, 152], [0, 150, 0], False,
                     40),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_decode_split_kernel_equals_plain_split(dev, case):
    """Kernel 1 without beams is one cluster launch and equals
    plain_split_decode_attention bit for bit (the same roundings in the
    same order); against the plain version 1e-2 (fp32) and 2e-2 (bf16)."""
    dtype, S, lens, starts, fresh, D = _SPLIT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(11)
    B, H = len(lens), 20
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    if dtype == torch.int8:
        cache = torch.randint(-127, 128, (2, B, 2, H, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        fkv = tuple(torch.randint(-127, 128, (B, H, D, 1), generator=g,
                                  device=dev, dtype=torch.int8)
                    for _ in range(2))
        kw = dict(kv_quant_orig_scale=torch.tensor(1 / 40.0, device=dev))
    else:
        cache = torch.randn(2, B, 2, H, D, S, generator=g,
                            device=dev).bfloat16() * 2
        fkv = tuple(torch.randn(B, H, D, 1, generator=g,
                                device=dev).bfloat16() for _ in range(2))
        kw = {}
    if fresh:
        kw["fresh_kv"] = fkv
    if starts is not None:
        kw["start_index"] = torch.tensor(starts, device=dev)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev) + int(fresh)
    splits = da.decode_splits(S)
    assert splits == {1500: 6, 448: 2, 2600: 8, 300: 2}[S]
    before = dict(da.launches)
    out = da.fused_decode_attention(cache, 1, q, seq, 0.125, **kw)
    name = "decode_attention_" + ("int8" if dtype == torch.int8 else "bf16")
    assert da.launches[name] == before[name] + 1
    assert sum(da.launches.values()) == sum(before.values()) + 1
    split = da.plain_split_decode_attention(cache, 1, q, seq, 0.125,
                                            splits=splits, **kw)
    f32 = (lambda t: t) if dtype == torch.int8 else (lambda t: t.float())
    kw32 = {k: (tuple(f32(t) for t in v) if k == "fresh_kv" else v)
            for k, v in kw.items()}
    ref = da.plain_decode_attention(f32(cache), 1, q.float(), seq, 0.125,
                                    **kw32)
    ref16 = da.plain_decode_attention(cache, 1, q, seq, 0.125, **kw)
    torch.cuda.synchronize()
    assert out.shape == split.shape == (B, H, 1, D)
    assert torch.equal(out, split)
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


def test_decode_split_kernel_without_valid_column(dev):
    """Nothing cached and no fresh column: every slice reads nothing and
    the context is zero, as the first design wrote it."""
    cache = torch.ones(1, 1, 2, 2, 64, 448, device=dev).bfloat16()
    q = torch.ones(1, 2, 1, 64, device=dev).bfloat16()
    out = da.fused_decode_attention(
        cache, 0, q, torch.tensor([0], dtype=torch.int32, device=dev), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def _gathered(cache, ind):
    """[L, B, 2, H, D, S] cache -> the same with each row's positions read
    through the [groups, bw, S'] indirection (the reordered cache that the
    beam kernel never builds)."""
    L, B, _, H, D, S = cache.shape
    g, bw, s_ind = ind.shape
    idx = torch.nn.functional.pad(ind.long(), (0, S - s_ind))
    idx = (idx + torch.arange(g, device=ind.device)[:, None, None] * bw)
    idx = idx.reshape(1, B, 1, 1, 1, S).expand(L, B, 2, H, D, S)
    return torch.gather(cache, 1, idx)


@pytest.mark.parametrize("cache_dtype,groups",
                         [(torch.bfloat16, 1), (torch.int8, 1),
                          (torch.bfloat16, 2), (torch.int8, 2)])
def test_beam_kernel_matches_plain(dev, cache_dtype, groups):
    """Beam width 5, a table whose rows change from position to position,
    group-uniform lengths (the second group longer, with a start index):
    against the fp32 plain version (1e-2) and the bf16 one (2e-2), and the
    fp32 plain version of kernel 1 on the gathered cache (1e-2)."""
    g = torch.Generator(device=dev).manual_seed(5 + groups)
    L, bw, H, D, S = 2, 5, 20, 64, 448
    B = groups * bw
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    if cache_dtype == torch.int8:
        cache = torch.randint(-127, 128, (L, B, 2, H, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        fresh = tuple(torch.randint(-127, 128, (B, H, D, 1), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
        kw = dict(kv_quant_orig_scale=torch.tensor(1 / 40.0, device=dev))
    else:
        cache = torch.randn(L, B, 2, H, D, S, generator=g,
                            device=dev).bfloat16()
        fresh = tuple(torch.randn(B, H, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        kw = {}
    ind = torch.randint(0, bw, (groups, bw, S), generator=g, device=dev,
                        dtype=torch.int32)
    seq = torch.tensor([44, 300][:groups], device=dev).repeat_interleave(bw)
    if groups == 2:
        kw["start_index"] = torch.tensor([0, 9], device=dev) \
            .repeat_interleave(bw)
    before = da.launches["beam_decode_attention"]
    out = da.fused_decode_attention(cache, 1, q, seq, D ** -0.5,
                                    fresh_kv=fresh, beam_indirection=ind,
                                    **kw)
    assert da.launches["beam_decode_attention"] == before + 1
    f32 = (lambda t: t) if cache_dtype == torch.int8 else (lambda t: t.float())
    fresh32 = tuple(f32(t) for t in fresh)
    ref = da.plain_beam_decode_attention(
        f32(cache), 1, q.float(), seq, D ** -0.5, fresh_kv=fresh32,
        beam_indirection=ind, **kw)
    ref16 = da.plain_beam_decode_attention(
        cache, 1, q, seq, D ** -0.5, fresh_kv=fresh, beam_indirection=ind,
        **kw)
    ref_gather = da.plain_decode_attention(
        f32(_gathered(cache, ind)), 1, q.float(), seq, D ** -0.5,
        fresh_kv=fresh32, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (B, H, 1, D)
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2
    assert _rel(out, ref_gather) < 1e-2


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_beam_kernel_rounds_p_before_pv(dev, cache_dtype):
    """The construction of test_decode_kernel_rounds_p_before_pv through
    the beam entry: beam width 5, position 0 read from row 1 (the only row
    whose key scores s0) by every query beam, the other 1499 positions from
    rows that change with the position, every value column equal, and the
    fresh column scoring 0 with the same value: the context is c (1 + 1499
    bf16(p) + p) / (1 + 1500 p) = 0.9965 c with P rounded before P·V, and c
    without.  A kernel that ignored the table would read score 0 at
    position 0 for the query beams other than 1 and give c."""
    bw, H, D, S = 5, 2, 64, 1500
    p_other = 128.45 * 2.0 ** -9
    scale = -float(np.log(p_other))
    cache = torch.zeros(1, bw, 2, H, D, S, device=dev, dtype=cache_dtype)
    cache[0, 1, 0, :, 0, 0] = 1
    c = (torch.arange(D, device=dev) % 7 + 1).to(cache_dtype)
    cache[0, :, 1] = c[None, None, :, None]
    g = torch.Generator(device=dev).manual_seed(6)
    ind = torch.randint(0, bw, (1, bw, S), generator=g, device=dev,
                        dtype=torch.int32)
    ind[..., 0] = 1
    q = torch.zeros(bw, H, 1, D, device=dev, dtype=torch.bfloat16)
    q[..., 0] = 1
    fk = torch.zeros(bw, H, D, 1, device=dev, dtype=cache_dtype)
    fv = c[None, None, :, None].expand(bw, H, D, 1).contiguous()
    kw = (dict(kv_quant_orig_scale=torch.tensor(1.0, device=dev))
          if cache_dtype == torch.int8 else {})
    seq = torch.full((bw,), S + 1, dtype=torch.int32, device=dev)
    out = da.fused_decode_attention(cache, 0, q, seq, scale,
                                    fresh_kv=(fk, fv), beam_indirection=ind,
                                    **kw)[:, :, 0]
    ref16, ref32 = (_chunked_ctx(
        _gathered(cache, ind), 0, q, S, scale, 1.0, r,
        fresh=(fk[..., 0], fv[..., 0])).to(torch.bfloat16)
        for r in (True, False))
    torch.cuda.synchronize()
    assert torch.equal(out, ref16)
    assert bool((out != ref32).all())


def test_beam_kernel_refuses_what_it_does_not_take(dev):
    bw, H, D, S = 2, 2, 64, 16
    cache = torch.zeros(1, bw, 2, H, D, S, device=dev).bfloat16()
    q = torch.zeros(bw, H, 1, D, device=dev).bfloat16()
    fresh = (torch.zeros(bw, H, D, 1, device=dev).bfloat16(),) * 2
    seq = torch.full((bw,), 4, dtype=torch.int32, device=dev)
    ind = torch.zeros(1, bw, S, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):       # fp8 cache
        fp8 = torch.float8_e4m3fn
        da.fused_decode_attention(cache.to(fp8), 0, q, seq, 0.125,
                                  fresh_kv=tuple(t.to(fp8) for t in fresh),
                                  beam_indirection=ind)
    with pytest.raises(NotImplementedError):       # GQA: 4 query heads
        da.fused_decode_attention(cache, 0, q.repeat(1, 2, 1, 1), seq, 0.125,
                                  fresh_kv=fresh, beam_indirection=ind)
    with pytest.raises(NotImplementedError):       # the K-step tail
        da.fused_decode_attention(cache, 0, q, seq, 0.125, fresh_kv=fresh,
                                  tail_kv=(cache, 0), beam_indirection=ind)
    with pytest.raises(ValueError):                # no fresh K/V
        da.fused_decode_attention(cache, 0, q, seq, 0.125,
                                  beam_indirection=ind)
    with pytest.raises(ValueError):                # table wider than S
        da.fused_decode_attention(cache, 0, q, seq, 0.125, fresh_kv=fresh,
                                  beam_indirection=torch.zeros(
                                      1, bw, S + 4, dtype=torch.int32,
                                      device=dev))


def _beam_case(g, dev, cache_dtype, L, groups, bw, H, D, S, seqs, starts):
    """(cache, q, fresh, ind, seq, kwargs) of one beam call: each group's
    length and start repeated over its bw rows, a table whose rows change
    from position to position."""
    B = groups * bw
    if cache_dtype == torch.int8:
        cache = torch.randint(-127, 128, (L, B, 2, H, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        fresh = tuple(torch.randint(-127, 128, (B, H, D, 1), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
        kw = dict(kv_quant_orig_scale=torch.tensor(1 / 40.0, device=dev))
    else:
        cache = torch.randn(L, B, 2, H, D, S, generator=g,
                            device=dev).bfloat16()
        fresh = tuple(torch.randn(B, H, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        kw = {}
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    ind = torch.randint(0, bw, (groups, bw, S), generator=g, device=dev,
                        dtype=torch.int32)
    seq = torch.tensor(seqs, device=dev).repeat_interleave(bw)
    if starts is not None:
        kw["start_index"] = torch.tensor(starts, device=dev) \
            .repeat_interleave(bw)
    return cache, q, fresh, ind, seq, kw


def _beam_check(cache_dtype, cache, q, fresh, ind, seq, kw, what, D):
    """The beam entry's context, held against the fp32 plain version (1e-2)
    and the bf16 one (2e-2); returned."""
    out = da.fused_decode_attention(cache, 0, q, seq, D ** -0.5,
                                    fresh_kv=fresh, beam_indirection=ind,
                                    **kw)
    f32 = (lambda t: t) if cache_dtype == torch.int8 else (
        lambda t: t.float())
    ref = da.plain_beam_decode_attention(
        f32(cache), 0, q.float(), seq, D ** -0.5,
        fresh_kv=tuple(f32(t) for t in fresh), beam_indirection=ind, **kw)
    ref16 = da.plain_beam_decode_attention(
        cache, 0, q, seq, D ** -0.5, fresh_kv=fresh, beam_indirection=ind,
        **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()), what
    assert _rel(out, ref) < 1e-2, what
    assert _rel(out, ref16) < 2e-2, what
    return out


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("bw", [1, 3, 5, 8, 9, 16, 17, 24])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_beam_kernel_lengths_and_starts(dev, cache_dtype, bw, groups):
    """The beam entry over its plan's slices and rounds (S 448: 2 slices of
    224; S 1500: 6 of 252, walked in rounds): lengths 1, 44, 224, 225, 448
    and 449 (the whole cache), a start inside a slice, a start that masks a
    whole slice, and the rounding pin's 1501 at S 1500; the second group's
    length and start differ.  Beam widths past 8 take the warps' second
    pass over the query beams (and under 2 row splits, rows of 5 and 4 at
    9), 16 a full tile, 17 and 24 two tiles of query beams.  Against the
    fp32 plain version (1e-2) and the bf16 one (2e-2)."""
    g = torch.Generator(device=dev).manual_seed(40 + 3 * bw + groups)
    H, D = 4, 64
    cases = [(448, n, None) for n in (1, 44, 224, 225, 448, 449)]
    cases += [(448, 300, 9), (448, 448, 230), (1500, 1501, None),
              (1500, 1400, 260)]
    for S, n, st in cases:
        seqs = [n, max(1, n - 7)][:groups]
        starts = None if st is None else [st, max(0, st - 5)][:groups]
        cache, q, fresh, ind, seq, kw = _beam_case(
            g, dev, cache_dtype, 1, groups, bw, H, D, S, seqs, starts)
        _beam_check(cache_dtype, cache, q, fresh, ind, seq, kw,
                    f"S {S}, seq {seqs}, start {starts}", D)


@pytest.mark.parametrize("seq", [2049, 2068, 2087])
def test_beam_kernel_at_the_gen_beam_shape(dev, seq):
    """The beam entry as ``chip_smoke.py``'s gen_beam path calls it
    (GPT-350M: 16 heads of 64, bf16, beam 4, a cache of 2088 columns whose
    prompt starts at 136): the first, middle and last step of a 40-token
    call.  Against the fp32 plain version (1e-2) and the bf16 one
    (2e-2)."""
    g = torch.Generator(device=dev).manual_seed(seq)
    cache, q, fresh, ind, seq_t, kw = _beam_case(
        g, dev, torch.bfloat16, 1, 1, 4, 16, 64, 2088, [seq], [136])
    before = da.launches["beam_decode_attention"]
    _beam_check(torch.bfloat16, cache, q, fresh, ind, seq_t, kw,
                f"seq {seq}", 64)
    assert da.launches["beam_decode_attention"] == before + 1


def _tiny_decoder(device, seed=0):
    """A bf16 decoder of 2 layers of width 128 (4 heads of 32, equal
    heads, vocab 97) from one numpy state (N(0, 0.3), LayerNorm weights
    1 + N(0, 0.02)), on ``device``."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig, DecoderLMHead)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    config = DecoderConfig(vocab_size=97, hidden_size=128, num_layers=2,
                           num_heads=4, max_position_embeddings=64,
                           dtype="bfloat16")
    with torch.device("meta"):
        shapes = DecoderLMHead(config).state_dict()
    rs = np.random.RandomState(seed)
    state = {}
    for key, t in shapes.items():
        shape = tuple(t.shape)
        if key.startswith("blocks.0."):
            key, shape = "blocks." + key[len("blocks.0."):], (2,) + shape
        elif key.startswith("blocks."):
            continue
        x = rs.randn(*shape).astype(np.float32)
        state[key] = 1 + 0.02 * x if key.endswith("norm.weight") or \
            key == "ln_f.weight" else 0.3 * x
    return from_jax_state(state, config, device=device)


@pytest.mark.parametrize("mode", ["beam", "gather", "sampled"])
def test_session_on_the_card_matches_the_cpu(dev, mode):
    """A tiny bf16 session on the card and the same session on the CPU
    (the card's launches through the beam entry, or kernel 1 for the
    beams of gather mode, ``use_cache_indirection=False``, and for the
    sampled rows): three ragged prompts, 6 new tokens, beam 3 with a
    repetition penalty, or sampled rows (temperature, top-k, top-p, both
    penalties, min-length, a bad and a stop word) with the same Gumbel
    noise handed to both.  The tokens and lengths equal, the cum
    log-probs within 2e-2 (bf16 logits on two devices)."""
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig)
    from eddie_wang_hackathon2023_tpu_torch.runtime.sampling import \
        gumbel_noise
    if mode != "sampled":
        sc = SamplingConfig(end_id=-1, pad_id=0, num_beams=3,
                            length_penalty=0.6, repetition_penalty=1.2)
    else:
        sc = SamplingConfig(end_id=5, pad_id=0, temperature=[0.0, 0.8, 1.0],
                            top_k=[1, 8, 0], top_p=[0.0, 0.9, 0.95],
                            repetition_penalty=1.2, presence_penalty=0.3,
                            min_length=2, bad_words_list=[[7], [3, 4]],
                            stop_words_list=[[11, 12]])
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 97, (3, 5)).astype(np.int32)
    lens = np.asarray([5, 2, 4], np.int32)
    mc = ModelConfig(vocab_size=97, num_layers=2, num_heads=4,
                     hidden_size=128, max_seq_len=64)
    g = torch.Generator().manual_seed(9)
    noise = [gumbel_noise((3, 97), g) for _ in range(6)]
    outs = []
    for device in (dev, torch.device("cpu")):
        sess = GenerationSession(mc, _tiny_decoder(device), sc,
                                 use_cache_indirection=mode != "gather")
        draws = iter(noise)
        sess._gumbel = lambda shape, device=device: next(draws).to(device)
        da.reset_launches()
        outs.append(sess.decode(ids, lens, max_new_tokens=6, seed=2))
        if device.type == "cuda":
            key = ("beam_decode_attention" if mode == "beam"
                   else "decode_attention_bf16")
            assert sess.decode_steps > 0
            assert da.launches[key] == 2 * sess.decode_steps
    (ct, cl, cc), (pt, pl, pc) = outs
    np.testing.assert_array_equal(ct, pt)
    np.testing.assert_array_equal(cl, pl)
    np.testing.assert_allclose(cc, pc, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bw", [12, 16, 24, 33])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_beam_kernel_wide_beams_at_head_dim_128(dev, cache_dtype, bw):
    """Head dim 128 at S 1500 (6 slices, no room to split the rows over
    blocks): in bf16 past 12 beams a block's source rows are staged in two
    rounds, each walked twice; 33 beams are three tiles of query beams.
    Lengths 44, 1400 from start 260, and 1501, against the plain
    versions."""
    g = torch.Generator(device=dev).manual_seed(60 + bw)
    H, D, S = 2, 128, 1500
    plan = da.beam_plan(S, bw, D, cache_dtype.itemsize)
    if cache_dtype == torch.bfloat16 and bw > 12:
        assert plan["rows"] < -(-bw // plan["rs"])
    for n, st in ((44, None), (1400, 260), (1501, None)):
        cache, q, fresh, ind, seq, kw = _beam_case(
            g, dev, cache_dtype, 1, 1, bw, H, D, S, [n],
            None if st is None else [st])
        _beam_check(cache_dtype, cache, q, fresh, ind, seq, kw,
                    f"seq {n}, start {st}", D)


@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_beam_kernel_takes_a_cache_on_any_element(dev, cache_dtype, offset):
    """A contiguous cache view that starts 1 element (a copy an element) or
    4 elements (4 columns a copy) past an aligned start: the context equals
    the aligned cache's bit for bit (the same values staged), and the
    plain versions."""
    g = torch.Generator(device=dev).manual_seed(70 + offset)
    bw, H, D, S = 5, 4, 64, 448
    for n, st in ((44, None), (448, 230)):
        cache, q, fresh, ind, seq, kw = _beam_case(
            g, dev, cache_dtype, 1, 2, bw, H, D, S, [n, n - 7],
            None if st is None else [st, st - 5])
        buf = torch.empty(cache.numel() + 16, dtype=cache_dtype, device=dev)
        moved = buf[offset:offset + cache.numel()].view(cache.shape)
        moved.copy_(cache)
        assert moved.data_ptr() % 16 and moved.is_contiguous()
        want = _beam_check(cache_dtype, cache, q, fresh, ind, seq, kw,
                           f"aligned, seq {n}", D)
        out = _beam_check(cache_dtype, moved, q, fresh, ind, seq, kw,
                          f"offset {offset}, seq {n}", D)
        assert torch.equal(out, want)


def test_beam_kernel_refuses_a_plan_it_does_not_take(dev):
    """The C entry takes only plans whose slices cover S (the last one not
    empty) in rounds of a multiple of 16 columns up to 256, counted right,
    with 1 to bw row splits, at most 8 blocks a cluster, and 1 to
    ceil(bw / rs) rows staged a round."""
    g = torch.Generator(device=dev).manual_seed(47)
    bw, H, D, S = 5, 2, 64, 448
    cache, q, fresh, ind, seq, _ = _beam_case(
        g, dev, torch.bfloat16, 1, 1, bw, H, D, S, [44], None)
    ind = ind.contiguous()
    ctx = torch.empty(bw, H * D, dtype=torch.bfloat16, device=dev)
    lib = _build.load("decode_attention")
    stream = torch.cuda.current_stream().cuda_stream
    plan = da.beam_plan(S, bw, D, 2)

    def call(splits, width, cols, rounds, rs, rows):
        return lib.beam_decode_attention(
            q.data_ptr(), cache.data_ptr(), 0, 0, bw, H, D, S, splits, width,
            cols, rounds, rs, rows, seq.data_ptr(), None, None, D ** -0.5,
            fresh[0].data_ptr(), fresh[1].data_ptr(), ind.data_ptr(), bw,
            ctx.data_ptr(), stream)
    assert plan == dict(splits=2, width=224, cols=224, rounds=1, rs=2,
                        rows=3)
    assert call(*plan.values()) == 0
    assert call(2, 224, 144, 2, 1, 5) == 0       # other plans it takes
    assert call(2, 224, 224, 1, 2, 1) == 0
    for bad in ((2, 220, 224, 1, 4, 2), (3, 224, 224, 1, 2, 3),
                (2, 224, 136, 2, 4, 2), (2, 224, 144, 1, 4, 2),
                (9, 56, 16, 4, 1, 5), (2, 222, 224, 1, 4, 2),
                (2, 224, 272, 1, 4, 2), (2, 224, 224, 1, 6, 1),
                (2, 224, 224, 1, 5, 1), (2, 224, 224, 1, 0, 1),
                (2, 224, 224, 1, 2, 0), (2, 224, 224, 1, 2, 4)):
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()


def test_flash_kernel_matches_plain_strided(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, L, D, valid = 2, 3, 200, 64, 150
    qkv = torch.randn(B, L, 3, H, D, generator=g, device=dev).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = fa.launches["flash_attention"]
    out = fa.flash_mha(q, k, v, scale=0.125, kv_valid_len=valid)
    assert fa.launches["flash_attention"] == before + 1
    ref = fa.plain_flash_mha(q.float(), k.float(), v.float(), scale=0.125,
                             kv_valid_len=valid)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2


def test_flash_kernel_f32_entry(dev):
    """fp32 q/k/v (the SmoothQuant encoder's): within 1e-4 of the largest
    output of the fp32 plain version, where a bf16 kernel sits near 1e-3."""
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, L, D, valid = 1, 3, 300, 64, 250
    qkv = torch.randn(B, L, 3, H, D, generator=g, device=dev) * 2
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = fa.launches["flash_attention_f32"]
    out = fa.flash_mha(q, k, v, scale=0.125, kv_valid_len=valid)
    assert fa.launches["flash_attention_f32"] == before + 1
    assert out.dtype == torch.float32
    ref = fa.plain_flash_mha(q, k, v, scale=0.125, kv_valid_len=valid)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-4


@pytest.mark.parametrize("lq,lk,valid,layout,scale", [
    (1536, 1536, 127, "fused", 0.125),
    (1536, 1536, 128, "fused", 0.125),
    (1536, 1536, 129, "fused", 0.125),
    (1536, 1536, 1500, "fused", 0.125),
    (200, 1536, 1500, "fused", 0.125),
    (200, 200, 129, "contiguous", 0.125),
    (1536, 1536, 1500, "contiguous", -0.125),
])
def test_flash_kernel_hopper_entry_edges(dev, lq, lk, valid, layout, scale):
    """The bf16 non-causal entry (wgmma, TMA) at the edges of its 64-key
    tiles and 128-row blocks, on strided views of a fused QKV buffer (the
    encoder's) and on contiguous tensors, a negative scale included: within
    1e-2 of the fp32 plain version and 2e-2 of the bf16 one."""
    g = torch.Generator(device=dev).manual_seed(lq + valid)
    H = 20
    if layout == "fused":
        q, k, v = _qkv(g, dev, 1, H, lq, lk, 64, torch.bfloat16)
    else:
        q, k, v = (torch.randn(1, H, n, 64, generator=g,
                               device=dev).bfloat16() for n in (lq, lk, lk))
    before = fa.launches["flash_attention"]
    out = fa.flash_mha(q, k, v, scale=scale, kv_valid_len=valid)
    assert fa.launches["flash_attention"] == before + 1
    ref = fa.plain_flash_mha(q.float(), k.float(), v.float(), scale=scale,
                             kv_valid_len=valid)
    ref16 = fa.plain_flash_mha(q, k, v, scale=scale, kv_valid_len=valid)
    torch.cuda.synchronize()
    assert out.shape == (1, H, lq, 64)
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


def test_flash_hopper_config_reports_the_built_kernel(dev):
    """The bf16 entry's reported design: whole 64-row warpgroups a block, a
    ring of at least two stages, and at least one block of the compiled
    kernel on an SM; a call at the reported rows + 1 still launches once."""
    cfg = fa.hopper_config()
    assert cfg["rows"] % 64 == 0 and cfg["rows"] >= 64
    assert cfg["stages"] >= 2 and cfg["blocks_per_sm"] >= 1
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = _qkv(g, dev, 1, 2, cfg["rows"] + 1, 256, 64, torch.bfloat16)
    before = fa.launches["flash_attention"]
    out = fa.flash_mha(q, k, v, scale=0.125, kv_valid_len=200)
    assert fa.launches["flash_attention"] == before + 1
    ref = fa.plain_flash_mha(q.float(), k.float(), v.float(), scale=0.125,
                             kv_valid_len=200)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2


def _random_blobs(dev, n_layer, d, seed):
    """Megakernel blobs from a seeded random int8 block state, scaled so
    that every GEMV output is of order one."""
    rs = np.random.RandomState(seed)
    L, ffn, heads = n_layer, 4 * d, d // 64

    def q8(*shape):
        return rs.randint(-127, 128, shape).astype(np.int8)

    def sc(n, k):
        return (rs.uniform(0.5, 1.5, (L, n)) / (73 * k ** 0.5)).astype(
            np.float32)

    def nrm(*shape, std=0.1, mean=0.0):
        return (rs.randn(*shape) * std + mean).astype(np.float32)

    st = {"attn.qkv.qweight": q8(L, d, 3 * d),
          "attn.qkv.per_channel_scale": sc(3 * d, d),
          "attn.qkv.bias": nrm(L, 3, heads, 64)}
    for name, k, n in (("attn.dense", d, d), ("cross_attn.q_linear", d, d),
                       ("cross_attn.dense", d, d), ("mlp1", d, ffn),
                       ("mlp2", ffn, d)):
        st[name + ".qweight"] = q8(L, k, n)
        st[name + ".per_channel_scale"] = sc(n, k)
        st[name + ".bias"] = nrm(L, n)
    for name in ("attn_ln", "cross_attn_ln", "mlp_ln"):
        st[name + ".weight"] = nrm(L, d, mean=1.0)
        st[name + ".bias"] = nrm(L, d)
    return mk.megakernel_tiles(mk.pack_decoder_blobs(
        st, n_layer=L, hidden=d, n_head=heads, head_dim=64, ffn=ffn,
        device=dev))


@pytest.mark.parametrize("n_layer,tol,cross_dtype",
                         [(1, 1e-2, torch.int8), (3, 3e-2, torch.int8),
                          (1, 1e-2, torch.bfloat16)])
def test_megakernel_matches_plain(dev, n_layer, tol, cross_dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    d, S, Sc, seq = 256, 448, 1500, 300
    H = d // 64
    blobs = _random_blobs(dev, n_layer, d, seed=n_layer)
    x = torch.randn(1, d, generator=g, device=dev).bfloat16()
    cache = torch.randn(n_layer, 1, 2, H, 64, S, generator=g,
                        device=dev).bfloat16()
    if cross_dtype == torch.int8:
        cross = torch.randint(-127, 128, (n_layer, 1, 2, H, 64, Sc),
                              generator=g, device=dev, dtype=torch.int8)
        cscale = torch.full((n_layer,), 1 / 40.0, device=dev)
    else:
        cross = torch.randn(n_layer, 1, 2, H, 64, Sc, generator=g,
                            device=dev).bfloat16()
        cscale = None
    seq_t = torch.tensor([seq], dtype=torch.int32, device=dev)
    before = mk.launches["decoder_megakernel"]
    hid, fresh = mk.fused_decoder_stack(x, blobs, cache, seq_t, 0.125,
                                        cross_cache=cross,
                                        cross_scale=cscale)
    assert mk.launches["decoder_megakernel"] == before + 1
    hid_p, fresh_p = mk.plain_fused_decoder_stack(
        x, blobs, cache, seq_t.cpu(), 0.125, cross, cscale)
    torch.cuda.synchronize()
    assert hid.shape == hid_p.shape == (1, d)
    assert bool(torch.isfinite(hid).all())
    assert _rel(hid, hid_p) < tol
    assert _rel(fresh, fresh_p) < tol


_MK_BLOBS = {}


def _mk_case(dev, n_layer, cross_dtype, seed):
    """Blobs at width 384 (6 heads) for n_layer layers, kept between the
    cases, and a seeded input row, self cache of 448 and cross cache of
    1500 (int8 with per-layer scales, or bf16)."""
    if n_layer not in _MK_BLOBS:
        _MK_BLOBS[n_layer] = _random_blobs(dev, n_layer, 384, seed=n_layer)
    blobs = _MK_BLOBS[n_layer]
    g = torch.Generator(device=dev).manual_seed(seed)
    d, S, Sc = 384, 448, 1500
    H = d // 64
    x = torch.randn(1, d, generator=g, device=dev).bfloat16()
    cache = torch.randn(n_layer, 1, 2, H, 64, S, generator=g,
                        device=dev).bfloat16()
    if cross_dtype == torch.int8:
        cross = torch.randint(-127, 128, (n_layer, 1, 2, H, 64, Sc),
                              generator=g, device=dev, dtype=torch.int8)
        cscale = torch.full((n_layer,), 1 / 40.0, device=dev)
    else:
        cross = torch.randn(n_layer, 1, 2, H, 64, Sc, generator=g,
                            device=dev).bfloat16()
        cscale = None
    return blobs, x, cache, cross, cscale


@pytest.mark.parametrize("seq", [1, 44, 256, 257, 448])
@pytest.mark.parametrize("cross_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n_layer,tol", [(1, 1e-2), (32, 5e-2)])
def test_megakernel_depths_and_lengths(dev, n_layer, tol, cross_dtype, seq):
    """1 and 32 layers, int8 and bf16 cross caches, the self cache empty
    (seq 1), at the main path's 44, at one and two past a 256-column
    attention slice and full (448): the kernel against the plain version
    within 1e-2 (1 layer) and 5e-2 (32 layers) of the largest output."""
    blobs, x, cache, cross, cscale = _mk_case(dev, n_layer, cross_dtype,
                                              seed=seq)
    seq_t = torch.tensor([seq], dtype=torch.int32, device=dev)
    hid, fresh = mk.fused_decoder_stack(x, blobs, cache, seq_t, 0.125,
                                        cross_cache=cross,
                                        cross_scale=cscale)
    hid_p, fresh_p = mk.plain_fused_decoder_stack(
        x, blobs, cache, seq_t.cpu(), 0.125, cross, cscale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(hid).all()) and bool(
        torch.isfinite(fresh).all())
    assert _rel(hid, hid_p) < tol
    assert _rel(fresh, fresh_p) < tol


def test_megakernel_hundred_launches_in_a_row(dev):
    """100 launches queued on one stream without a host wait, each with
    its own barrier counter: every result equals the first bit for bit
    (the kernel's sums have a fixed order, so a barrier that let a block
    run ahead would show), and the first matches the plain version."""
    blobs, x, cache, cross, cscale = _mk_case(dev, 4, torch.int8, seed=7)
    seq_t = torch.tensor([44], dtype=torch.int32, device=dev)
    outs = [mk.fused_decoder_stack(x, blobs, cache, seq_t, 0.125,
                                   cross_cache=cross, cross_scale=cscale)
            for _ in range(100)]
    hid_p, _ = mk.plain_fused_decoder_stack(
        x, blobs, cache, seq_t.cpu(), 0.125, cross, cscale)
    torch.cuda.synchronize()
    for i, (hid, fresh) in enumerate(outs):
        assert torch.equal(hid, outs[0][0]), i
        assert torch.equal(fresh, outs[0][1]), i
    assert _rel(outs[0][0], hid_p) < 3e-2


def _kv8_case(dev, n_layer, seed):
    """The megakernel's int8 self mode: _mk_case's blobs with per-layer
    self-KV steps (their fresh K/V reach about 4: steps 4 / 127), the
    self cache the bf16 case's values quantised at those steps, as a kv8
    cache of the same K/V holds them."""
    blobs, x, cache, cross, cscale = _mk_case(dev, n_layer, torch.int8,
                                              seed)
    step = torch.full((n_layer,), 4 / 127, device=dev)
    self8 = torch.clamp(torch.round(cache.float() * (127 / 4)), -128,
                        127).to(torch.int8)
    return (blobs._replace(kv_oq=1 / step, kv_qo=step), x, self8, cross,
            cscale)


@pytest.mark.parametrize("seq", [1, 44, 448])
@pytest.mark.parametrize("n_layer,tol", [(1, 1e-2), (2, 2e-2), (32, 5e-2)])
def test_megakernel_int8_self_matches_plain(dev, n_layer, tol, seq):
    """The int8 self cache (kv8) at 1, 2 and 32 layers, empty (seq 1), at
    the main path's 44 and full (448): the hidden state held as the bf16
    mode's (1e-2, 2e-2, 5e-2 of the largest output).  The fresh K/V are
    int8: on one layer equal to the plain version's (the same bf16 values,
    quantised alike); after it, a layer's input differs from the plain
    version's by the roundings above, so a value whose pre-rounding lies
    near a half step may land one step apart: on 2 layers at most one step
    on under 5% of the values, on 32 the dequantised values within the
    bf16 mode's 5e-2."""
    blobs, x, self8, cross, cscale = _kv8_case(dev, n_layer, seed=seq)
    seq_t = torch.tensor([seq], dtype=torch.int32, device=dev)
    before = mk.launches["decoder_megakernel"]
    hid, fresh = mk.fused_decoder_stack(x, blobs, self8, seq_t, 0.125,
                                        cross_cache=cross,
                                        cross_scale=cscale)
    assert mk.launches["decoder_megakernel"] == before + 1
    hid_p, fresh_p = mk.plain_fused_decoder_stack(
        x, blobs, self8, seq_t.cpu(), 0.125, cross, cscale)
    torch.cuda.synchronize()
    assert fresh.dtype == fresh_p.dtype == torch.int8
    assert bool(torch.isfinite(hid).all())
    assert _rel(hid, hid_p) < tol
    diff = (fresh.int() - fresh_p.int()).abs()
    if n_layer == 1:
        assert torch.equal(fresh, fresh_p)
    elif n_layer == 2:
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) < 0.05
    else:
        assert _rel(fresh, fresh_p) < tol
    assert int(fresh.abs().max()) > 64          # the steps' range is used


def test_megakernel_int8_self_two_calls_bit_equal(dev):
    """Two calls of the int8 self mode on the same inputs give the same
    bits, hidden state and fresh K/V."""
    blobs, x, self8, cross, cscale = _kv8_case(dev, 32, seed=5)
    seq_t = torch.tensor([44], dtype=torch.int32, device=dev)
    a = mk.fused_decoder_stack(x, blobs, self8, seq_t, 0.125,
                               cross_cache=cross, cross_scale=cscale)
    b = mk.fused_decoder_stack(x, blobs, self8, seq_t, 0.125,
                               cross_cache=cross, cross_scale=cscale)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_megakernel_int8_self_refuses_what_it_does_not_take(dev):
    """An int8 self cache of S not a multiple of 4 (the kernel reads 4
    columns a word), and an fp8 one, raise before a launch."""
    blobs, x, self8, cross, cscale = _kv8_case(dev, 1, seed=2)
    seq_t = torch.tensor([44], dtype=torch.int32, device=dev)
    before = mk.launches["decoder_megakernel"]
    with pytest.raises(ValueError):
        mk.fused_decoder_stack(x, blobs, self8[..., :446].contiguous(),
                               seq_t, 0.125, cross_cache=cross,
                               cross_scale=cscale)
    with pytest.raises(NotImplementedError):
        mk.fused_decoder_stack(x, blobs, self8.to(torch.float8_e4m3fn),
                               seq_t, 0.125, cross_cache=cross,
                               cross_scale=cscale)
    assert mk.launches["decoder_megakernel"] == before


def test_megakernel_refuses_blobs_without_tiles(dev):
    """Blobs without the card's tiles, or with tiles of another plan, raise
    before a launch."""
    blobs, x, cache, cross, cscale = _mk_case(dev, 1, torch.int8, seed=1)
    seq_t = torch.tensor([44], dtype=torch.int32, device=dev)
    before = mk.launches["decoder_megakernel"]
    for bad in (blobs._replace(tiles=None),
                mk.megakernel_tiles(blobs, sms=100)):
        with pytest.raises(ValueError):
            mk.fused_decoder_stack(x, bad, cache, seq_t, 0.125,
                                   cross_cache=cross, cross_scale=cscale)
    assert mk.launches["decoder_megakernel"] == before


# the megakernel's decoder-only modes: (head dim, gated, parallel, norm,
# activation, rotary dim and GPT-NeoX style or None)
DEC_MODES = {
    "llama": (128, True, False, "rmsnorm", "silu", (128, True)),
    "gptj": (128, False, True, "layernorm", "gelu", (32, False)),
    "neox_d64": (64, False, True, "layernorm", "gelu", (16, True)),
    "gpt2_d64": (64, False, False, "layernorm", "gelu", None),
    "opt": (128, False, False, "layernorm", "relu", None),
}


# the grouped (MQA/GQA) mode: SantaCoder's block and a GQA LLaMA's, heads
# of 128
GROUPED_MODES = {
    "santa": (128, False, False, "layernorm", "gelu", None),
    "gqa_llama": (128, True, False, "rmsnorm", "silu", (128, True)),
}


def _dec_blobs(dev, mode, n_layer, d, weight, seed, kv_step=None,
               kv_heads=None):
    """Megakernel blobs of a decoder-only mode from a seeded random block
    state (ffn 688, padded to 768), int8 weight-only or bf16 panels, scaled
    so that every GEMV output is of order one; with ``kv_step`` the int8
    self cache's per-layer step; with ``kv_heads`` the grouped mode's
    separate-KV layout."""
    head_dim, gated, parallel, norm, _, _ = {**DEC_MODES,
                                             **GROUPED_MODES}[mode]
    rs = np.random.RandomState(seed)
    L, ffn, heads = n_layer, 688, d // head_dim

    def nrm(*shape, std=0.1, mean=0.0):
        return (rs.randn(*shape) * std + mean).astype(np.float32)

    def lin(name, k, n, shape=None):
        if weight == "int8":
            st[name + ".qweight"] = rs.randint(-127, 128, (L, k, n)).astype(
                np.int8)
            st[name + ".per_channel_scale"] = (
                rs.uniform(0.5, 1.5, (L, n)) / (73 * k ** 0.5)).astype(
                    np.float32)
        else:
            st[name + ".weight"] = torch.from_numpy(nrm(
                *(shape or (L, n, k)), std=k ** -0.5)).bfloat16()

    st = {}
    if kv_heads:
        dkv = kv_heads * head_dim
        lin("attention.qkv", d, d + 2 * dkv, (L, heads, head_dim, d))
        if weight != "int8":
            st["attention.qkv.kv_weight"] = torch.from_numpy(nrm(
                L, 2, kv_heads, head_dim, d, std=d ** -0.5)).bfloat16()
        st["attention.qkv.bias"] = nrm(L, heads, head_dim)
        st["attention.qkv.kv_bias"] = nrm(L, 2, kv_heads, head_dim)
    else:
        lin("attention.qkv", d, 3 * d, (L, 3, heads, head_dim, d))
        st["attention.qkv.bias"] = nrm(L, 3, heads, head_dim)
    lin("attention.dense", d, d)
    names = ["mlp.fc"] + (["mlp.gate"] if gated else [])
    for name in names:
        lin(name, d, ffn)
        st[name + ".bias"] = nrm(L, ffn)
    lin("mlp.proj", ffn, d)
    st["mlp.proj.bias"] = nrm(L, d)
    lns = ("input_layernorm",) if parallel else ("input_layernorm",
                                                 "post_layernorm")
    for name in lns:
        st[name + ".weight"] = nrm(L, d, mean=1.0)
        if norm == "layernorm":
            st[name + ".bias"] = nrm(L, d)
    if kv_step is not None:
        st["attention.kv_orig_quant_scale"] = np.full((L, 1), 1 / kv_step,
                                                      np.float32)
        st["attention.kv_quant_orig_scale"] = np.full((L, 1), kv_step,
                                                      np.float32)
    keys = dict(mk.DECODER_KEYS, ln=lns)
    return mk.megakernel_tiles(mk.pack_decoder_blobs(
        st, n_layer=L, hidden=d, n_head=heads, head_dim=head_dim, ffn=ffn,
        with_cross=False, gated=gated, keys=keys, device=dev,
        n_kv_head=kv_heads))


def _dec_run(dev, mode, blobs, n_layer, d, self_dtype, seq, start, seed,
             S=448, kv_heads=None):
    """The kernel and its plain version on one seeded step over a self
    cache of S columns (of ``kv_heads`` heads in the grouped mode): (hid,
    fresh, plain hid, plain fresh)."""
    head_dim, gated, parallel, norm, act, rot = {**DEC_MODES,
                                                 **GROUPED_MODES}[mode]
    g = torch.Generator(device=dev).manual_seed(seed)
    H = kv_heads or d // head_dim
    x = torch.randn(1, d, generator=g, device=dev).bfloat16()
    if self_dtype == torch.int8:
        cache = torch.randint(-127, 128, (n_layer, 1, 2, H, head_dim, S),
                              generator=g, device=dev, dtype=torch.int8)
    else:
        cache = torch.randn(n_layer, 1, 2, H, head_dim, S, generator=g,
                            device=dev).bfloat16()
    seq_t = torch.tensor([seq], dtype=torch.int32, device=dev)
    start_t = torch.tensor([start], dtype=torch.int32, device=dev)
    rope = None if rot is None else mk.Rotary(seq - 1, rot[0], 10000.0,
                                              rot[1])
    kw = dict(start_index=start_t, head_dim=head_dim, act=act, norm=norm,
              parallel=parallel, rope=rope)
    before = mk.launches["decoder_megakernel"]
    hid, fresh = mk.fused_decoder_stack(x, blobs, cache, seq_t,
                                        head_dim ** -0.5, gated=gated, **kw)
    assert mk.launches["decoder_megakernel"] == before + 1
    hid_p, fresh_p = mk.plain_fused_decoder_stack(
        x, blobs, cache, seq_t.cpu(), head_dim ** -0.5, **kw)
    torch.cuda.synchronize()
    return hid, fresh, hid_p, fresh_p


@pytest.mark.parametrize("seq,start", [(1, 0), (70, 4), (300, 4),
                                       (448, 200)])
@pytest.mark.parametrize("weight", ["int8", "bf16"])
@pytest.mark.parametrize("mode", sorted(DEC_MODES))
def test_decoder_only_megakernel_matches_plain(dev, mode, weight, seq,
                                               start):
    """Each decoder-only mode (RMSNorm, SiLU, the gated MLP, RoPE NeoX and
    GPT-J, full and partial, the parallel residual, ReLU, heads of 64 and
    128), int8 and bf16 panels, 2 layers of width 256, a bf16 self cache of
    448 at the cache's edges (empty, two slices, full), keys below the
    start masked: within 3e-2 of the plain version on two layers (bf16
    residual roundings compound) and 1e-2 on the first layer alone."""
    blobs = _dec_blobs(dev, mode, 2, 256, weight, seed=len(mode))
    assert blobs.tiles.dtype == (torch.int8 if weight == "int8"
                                 else torch.bfloat16)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, blobs, 2, 256,
                                          torch.bfloat16, seq, start,
                                          seed=seq)
    assert bool(torch.isfinite(hid).all()) and bool(
        torch.isfinite(fresh).all())
    assert _rel(hid, hid_p) < 3e-2
    assert _rel(fresh, fresh_p) < 3e-2
    one = mk.blob_layers(blobs, 0, 1)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, one, 1, 256,
                                          torch.bfloat16, seq, start,
                                          seed=seq)
    assert _rel(hid, hid_p) < 1e-2
    assert _rel(fresh, fresh_p) < 1e-2


@pytest.mark.parametrize("weight", ["int8", "bf16"])
@pytest.mark.parametrize("mode", ["llama", "gptj"])
def test_decoder_only_megakernel_int8_self(dev, mode, weight):
    """An int8 self cache (kv8) under the decoder-only modes: the rotated
    fresh K quantised in the kernel; on one layer the int8 fresh K/V
    within one step of the plain version's (RoPE's cosf against torch's),
    the hidden state within 1e-2; two calls bit-equal."""
    blobs = _dec_blobs(dev, mode, 1, 256, weight, seed=3, kv_step=0.02)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, blobs, 1, 256,
                                          torch.int8, 70, 4, seed=5)
    assert fresh.dtype == torch.int8
    diff = (fresh.int() - fresh_p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.95
    assert _rel(hid, hid_p) < 1e-2
    again = _dec_run(dev, mode, blobs, 1, 256, torch.int8, 70, 4, seed=5)
    assert torch.equal(again[0], hid) and torch.equal(again[1], fresh)


@pytest.mark.parametrize("S,seq,start", [(2088, 2081, 136),
                                         (9000, 8900, 0),
                                         (20000, 19990, 9)])
@pytest.mark.parametrize("mode,weight", [("llama", "bf16"),
                                         ("gptj", "int8")])
def test_decoder_only_megakernel_long_caches(dev, mode, weight, S, seq,
                                             start):
    """Self caches past 8 slices of 256, whose 8th and later slices the
    head's finish folds into one (``fold_slices``): 9 (a 1912-token
    prompt's bucket of 2048 plus new tokens), 35 and 79 (a lane of the
    fold's max takes three): one layer within 1e-2 of the plain version,
    two within 3e-2."""
    blobs = _dec_blobs(dev, mode, 2, 256, weight, seed=7)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, blobs, 2, 256,
                                          torch.bfloat16, seq, start,
                                          seed=1, S=S)
    assert bool(torch.isfinite(hid).all())
    assert _rel(hid, hid_p) < 3e-2 and _rel(fresh, fresh_p) < 3e-2
    one = mk.blob_layers(blobs, 0, 1)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, one, 1, 256,
                                          torch.bfloat16, seq, start,
                                          seed=1, S=S)
    assert _rel(hid, hid_p) < 1e-2 and _rel(fresh, fresh_p) < 1e-2


@pytest.mark.parametrize("seq,start", [(70, 4), (300, 4)])
@pytest.mark.parametrize("weight", ["int8", "bf16"])
@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("mode", sorted(GROUPED_MODES))
def test_grouped_megakernel_matches_plain(dev, mode, hkv, weight, seq,
                                          start):
    """The grouped (MQA/GQA) mode: 4 query heads of 128 over 1 or 2 KV
    heads, d 512, SantaCoder's block (LayerNorm, GELU, biases) and a GQA
    LLaMA's (RMSNorm, the gated SiLU MLP, RoPE), int8 and bf16 panels,
    one or two attention slices: the fresh K/V [L, 2, Hkv, D], within 3e-2
    of the plain version on two layers and 1e-2 on one."""
    blobs = _dec_blobs(dev, mode, 2, 512, weight, seed=hkv, kv_heads=hkv)
    assert blobs.kvblob.shape == (2, 512, 2 * hkv * 128)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, blobs, 2, 512,
                                          torch.bfloat16, seq, start,
                                          seed=seq, kv_heads=hkv)
    assert fresh.shape == (2, 2, hkv, 128)
    assert bool(torch.isfinite(hid).all())
    assert _rel(hid, hid_p) < 3e-2 and _rel(fresh, fresh_p) < 3e-2
    one = mk.blob_layers(blobs, 0, 1)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, mode, one, 1, 512,
                                          torch.bfloat16, seq, start,
                                          seed=seq, kv_heads=hkv)
    assert _rel(hid, hid_p) < 1e-2 and _rel(fresh, fresh_p) < 1e-2


@pytest.mark.parametrize("hkv", [1, 2])
def test_grouped_megakernel_int8_self(dev, hkv):
    """The grouped mode over an int8 self cache: on one layer the int8
    fresh K/V within one step of the plain version's, the hidden state
    within 1e-2."""
    blobs = _dec_blobs(dev, "gqa_llama", 1, 512, "int8", seed=4,
                       kv_step=0.02, kv_heads=hkv)
    hid, fresh, hid_p, fresh_p = _dec_run(dev, "gqa_llama", blobs, 1, 512,
                                          torch.int8, 70, 4, seed=6,
                                          kv_heads=hkv)
    assert fresh.dtype == torch.int8 and fresh.shape == (1, 2, hkv, 128)
    diff = (fresh.int() - fresh_p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.95
    assert _rel(hid, hid_p) < 1e-2


def test_decoder_only_megakernel_at_llama_1b_width(dev):
    """Two layers at LLaMA-1B's widths (d 2048, 16 heads of 128, ffn 5504
    padded to 6144, gated, RMSNorm, SiLU, RoPE), bf16 panels: the plan's
    pieces stream through the ring (a bf16 item is 192 KB); within 3e-2 of
    the plain version."""
    from eddie_wang_hackathon2023_tpu_torch.ops.decoder_layer import Rotary
    g = torch.Generator(device=dev).manual_seed(1)
    L, d, ffn, H, D, S = 2, 2048, 5504, 16, 128, 84
    st = {"attention.qkv.weight": (torch.randn(
        L, 3, H, D, d, generator=g, device=dev) * d ** -0.5).bfloat16()}
    for name, k, n in (("attention.dense", d, d), ("mlp.fc", d, ffn),
                       ("mlp.gate", d, ffn), ("mlp.proj", ffn, d)):
        st[name + ".weight"] = (torch.randn(L, n, k, generator=g, device=dev)
                                * k ** -0.5).bfloat16()
    for name in ("input_layernorm", "post_layernorm"):
        st[name + ".weight"] = 1 + 0.1 * torch.randn(L, d, generator=g,
                                                     device=dev)
    blobs = mk.megakernel_tiles(mk.pack_decoder_blobs(
        st, n_layer=L, hidden=d, n_head=H, head_dim=D, ffn=ffn,
        with_cross=False, gated=True, device=dev))
    x = torch.randn(1, d, generator=g, device=dev).bfloat16()
    cache = torch.randn(L, 1, 2, H, D, S, generator=g, device=dev).bfloat16()
    seq = torch.tensor([70], dtype=torch.int32, device=dev)
    start = torch.tensor([4], dtype=torch.int32, device=dev)
    kw = dict(start_index=start, head_dim=D, act="silu", norm="rmsnorm",
              rope=Rotary(69, D, 10000.0, True))
    hid, fresh = mk.fused_decoder_stack(x, blobs, cache, seq, D ** -0.5,
                                        gated=True, **kw)
    hid_p, fresh_p = mk.plain_fused_decoder_stack(x, blobs, cache,
                                                  seq.cpu(), D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert _rel(hid, hid_p) < 3e-2 and _rel(fresh, fresh_p) < 3e-2


def _tiny_llama(device, seed=0):
    """A bf16 LLaMA of 2 layers of width 256 (2 heads of 128, ffn 688,
    vocab 97) from one numpy state (N(0, 0.05), norm weights 1 +
    N(0, 0.02)), on ``device``."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig, DecoderLMHead)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    config = DecoderConfig(vocab_size=97, hidden_size=256, num_layers=2,
                           num_heads=2, ffn_hidden_size=688,
                           max_position_embeddings=64, dtype="bfloat16",
                           position_embedding="rope", norm="rmsnorm",
                           norm_eps=1e-6, hidden_act="silu", gated_mlp=True,
                           attn_bias=False, mlp_bias=False,
                           tie_word_embeddings=False)
    with torch.device("meta"):
        shapes = DecoderLMHead(config).state_dict()
    rs = np.random.RandomState(seed)
    state = {}
    for key, t in shapes.items():
        shape = tuple(t.shape)
        if key.startswith("blocks.0."):
            key, shape = "blocks." + key[len("blocks.0."):], (2,) + shape
        elif key.startswith("blocks."):
            continue
        x = rs.randn(*shape).astype(np.float32)
        state[key] = 1 + 0.02 * x if key.endswith("norm.weight") or \
            key == "ln_f.weight" else 0.05 * x
    return from_jax_state(state, config, device=device)


def test_llama_session_through_the_megakernel(dev):
    """A tiny bf16 LLaMA at batch 1 (a 5-token prompt bucketed to 8: start
    3), 10 new tokens: one launch a decode step; the session's tokens
    replayed teacher-forced through the layer-by-layer step give logits
    within 5e-2 of the megakernel's; the first token (the prefill's) equal
    to the layer-by-layer session's."""
    _session_against_layer(dev, np.asarray([[5, 9, 2, 14, 7]], np.int32))


def test_llama_session_with_a_long_prompt(dev):
    """The same with a 1912-token prompt (bucket 2048, start 136): the
    cache of 2060 columns takes 9 attention slices in the kernel; the
    blobs hold the tiles alone (the panels a meta tensor)."""
    rs = np.random.RandomState(4)
    model = _session_against_layer(
        dev, rs.randint(0, 97, (1, 1912)).astype(np.int32))
    assert model.megakernel_blobs().wblob.device.type == "meta"


def _session_against_layer(dev, ids):
    """The tiny LLaMA's batch-1 session on ``ids`` through the megakernel
    against the same session layer by layer (10 new tokens); returns the
    model."""
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig)
    model = _tiny_llama(dev)
    assert model.megakernel_eligible()
    mc = ModelConfig(vocab_size=97, num_layers=2, num_heads=2,
                     hidden_size=256, max_seq_len=4096)
    n = ids.shape[1]
    lens = np.asarray([n], np.int32)
    calls = []
    hook = model.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((args, dict(kwargs))),
        with_kwargs=True)
    sess = GenerationSession(mc, model, SamplingConfig(end_id=-1, pad_id=0))
    try:
        mk.reset_launches()
        tk, _, _ = sess.decode(ids, lens, max_new_tokens=10)
    finally:
        hook.remove()
    assert mk.launches["decoder_megakernel"] == sess.decode_steps == 9
    tl, _, _ = GenerationSession(mc, model, SamplingConfig(
        end_id=-1, pad_id=0), decode_megakernel=False).decode(
            ids, lens, max_new_tokens=10)
    assert tk[0, 0, n] == tl[0, 0, n]
    s_cache = calls[0][0][1].shape[-1]
    with torch.inference_mode():
        for use_mk in (True, False):
            cache = model.new_kv_cache(1, s_cache)
            out = []
            for (tok, _, widx, seq), kw in calls:
                if not use_mk:
                    kw = {k: v for k, v in kw.items()
                          if k != "megakernel_blobs"}
                lg, cache = model(tok, cache, widx, seq, **kw)
                out.append(lg[:, -1])
            if use_mk:
                mk_logits = torch.stack(out)
            else:
                layer_logits = torch.stack(out)
    assert _rel(mk_logits, layer_logits) < 5e-2
    return model


def test_decode_kernel_at_head_dim_128(dev):
    """Kernel 1 at LLaMA-1B's batch-8 shape: 16 heads of 128, a bf16 cache
    of 84 columns, sequences 61-80 from starts 0-4, the fresh K/V: against
    the plain version in fp32 (1e-2) and in bf16 (2e-2)."""
    g = torch.Generator(device=dev).manual_seed(2)
    L, B, H, D, S = 2, 8, 16, 128, 84
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    cache = torch.randn(L, B, 2, H, D, S, generator=g, device=dev).bfloat16()
    fresh = tuple(torch.randn(B, H, D, 1, generator=g,
                              device=dev).bfloat16() for _ in range(2))
    seq = torch.arange(61, 61 + 20, 20 // B, device=dev)[:B].int()
    start = torch.arange(B, device=dev).int() % 5
    before = da.launches["decode_attention_bf16"]
    out = da.fused_decode_attention(cache, 1, q, seq, D ** -0.5,
                                    fresh_kv=fresh, start_index=start)
    assert da.launches["decode_attention_bf16"] == before + 1
    ref = da.plain_decode_attention(cache.float(), 1, q.float(), seq,
                                    D ** -0.5, fresh_kv=tuple(
                                        t.float() for t in fresh),
                                    start_index=start)
    ref16 = da.plain_decode_attention(cache, 1, q, seq, D ** -0.5,
                                      fresh_kv=fresh, start_index=start)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2 and _rel(out, ref16) < 2e-2


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.randn(1, 2, 128, 64, device=dev).bfloat16()
    with pytest.raises(ValueError):    # k and v of one shape
        fa.flash_mha(q, q, q[:, :, :64], causal=True)
    with pytest.raises(TypeError):     # one dtype for q, k and v
        fa.flash_mha(q.float(), q, q)
    blobs = _random_blobs(dev, 1, 128, seed=0)
    x = torch.zeros(2, 128, device=dev).bfloat16()
    cache = torch.zeros(1, 2, 2, 2, 64, 16, device=dev).bfloat16()
    with pytest.raises(NotImplementedError):       # batch 2
        mk.fused_decoder_stack(x, blobs, cache, torch.tensor([3], device=dev),
                               0.125, cross_cache=cache)
    with pytest.raises(TypeError):                 # fp32 activations
        mk.fused_decoder_stack(x[:1].float(), blobs, cache[:, :1],
                               torch.tensor([3], device=dev), 0.125,
                               cross_cache=cache[:, :1])
    cache = torch.zeros(1, 2, 2, 2, 64, 8, device=dev).bfloat16()
    with pytest.raises(NotImplementedError):
        da.fused_decode_attention(cache, 0, q[:1, :, :1], 4, 0.125)
    with pytest.raises(TypeError):      # lengths are a [B] device tensor
        da.fused_decode_attention(cache[:, :1], 0, q[:1, :, :1], 4, 0.125)


# columns of each block's slice of the grouped kernel at S = 2063
# (``csrc/gqa_decode_attention.cu``: a cluster of gqa_splits(2063) = 8
# blocks, slices of ceil(2063 / 8) rounded up to 16)
_GQA_CHUNK = da.gqa_slice_width(2063, da.gqa_splits(2063))


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_gqa_kernel_matches_plain(dev, cache_dtype, hkv):
    """16 query heads over 1, 2 or 4 KV heads, S = 2063 (not a multiple of
    4), per-row lengths at the slice edges (nothing cached, one slice and
    one column, two slices and one column, all of S) and starts (one of
    them a whole slice, which is skipped)."""
    g = torch.Generator(device=dev).manual_seed(5 + hkv)
    L, B, H, D, S = 2, 4, 16, 64, 2063
    ch = _GQA_CHUNK
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    if cache_dtype == torch.int8:
        cache = torch.randint(-127, 128, (L, B, 2, hkv, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        fresh = tuple(torch.randint(-127, 128, (B, hkv, D, 1), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
        ks = torch.tensor(1 / 40.0, device=dev)
    else:
        cache = torch.randn(L, B, 2, hkv, D, S, generator=g,
                            device=dev).bfloat16()
        fresh = tuple(torch.randn(B, hkv, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        ks = None
    seq = torch.tensor([1, ch + 2, min(2 * ch + 2, S), S], dtype=torch.int32,
                       device=dev)
    start = torch.tensor([0, 3, min(ch, S - 40), 5], dtype=torch.int32,
                         device=dev)
    kw = dict(kv_quant_orig_scale=ks, start_index=start)
    before = da.launches["gqa_decode_attention"]
    out = da.fused_decode_attention(cache, 1, q, seq, 0.125, fresh_kv=fresh,
                                    **kw)
    assert da.launches["gqa_decode_attention"] == before + 1
    f32 = (lambda t: t) if cache_dtype == torch.int8 else (lambda t: t.float())
    ref = da.plain_gqa_decode_attention(f32(cache), 1, q.float(), seq, 0.125,
                                        fresh_kv=tuple(map(f32, fresh)), **kw)
    ref16 = da.plain_gqa_decode_attention(cache, 1, q, seq, 0.125,
                                          fresh_kv=fresh, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (B, H, 1, D)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_gqa_kernel_rounds_p_before_pv(dev, cache_dtype):
    """As for kernel 1: 16 query heads over one KV head, one cached key
    scores s0 above the other 1498 and the fresh one, whose probability
    exp(-s0) = 0.25088 sits 0.45 of a bf16 step above 0.25, and every value
    column is the same.  The context is then c (1 + 1498 bf16(p) + p) /
    (1 + 1499 p) = 0.9965 c with P rounded before P·V (the fresh column is
    added in fp32), and c without; the bf16 output must be the first."""
    H, D, S = 16, 64, 1500
    p_other = 128.45 * 2.0 ** -9
    scale = -float(np.log(p_other))
    cache = torch.zeros(1, 1, 2, 1, D, S, device=dev, dtype=cache_dtype)
    cache[0, 0, 0, 0, 0, 0] = 1
    c = (torch.arange(D, device=dev) % 7 + 1).to(cache_dtype)
    cache[0, 0, 1, 0] = c[:, None]
    fresh = (torch.zeros(1, 1, D, 1, device=dev, dtype=cache_dtype),
             c.reshape(1, 1, D, 1).clone())
    q = torch.zeros(1, H, 1, D, device=dev, dtype=torch.bfloat16)
    q[..., 0] = 1
    kw = (dict(kv_quant_orig_scale=torch.tensor(1.0, device=dev))
          if cache_dtype == torch.int8 else {})
    seq = torch.tensor([S], dtype=torch.int32, device=dev)
    out = da.fused_decode_attention(cache, 0, q, seq, scale, fresh_kv=fresh,
                                    **kw)[:, :, 0]
    rep = cache.repeat_interleave(H, dim=3)     # the heads, repeated
    ref16, ref32 = (_chunked_ctx(
        rep, 0, q, S - 1, scale, 1.0, r, chunk=_GQA_CHUNK,
        fresh=tuple(t[..., 0].repeat_interleave(H, dim=1) for t in fresh)
    ).to(torch.bfloat16) for r in (True, False))
    torch.cuda.synchronize()
    assert torch.equal(out, ref16)
    assert bool((out != ref32).all())


@pytest.mark.parametrize("S", [83, 84, 448, 1500, 2048, 2063])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("rep", [1, 4, 16, 32])
@pytest.mark.parametrize("cache_dtype", [torch.int8, torch.bfloat16])
def test_gqa_kernel_layouts(dev, cache_dtype, rep, D, S):
    """The grouped kernel on the tensor cores over its layouts: rep below,
    at and above the mma's 16 rows, head dims that are (64, 128) and are
    not (80) a multiple of the padded 32, S in one round (83, 84) and
    split over a cluster, by 4-column copies (448, 1500, 2048: S % 4 == 0)
    or by element copies (2063); rows with nothing cached (seq 1), a start
    that skips a whole slice, all of S, and a start (3) and a last cached
    column (W + 28) inside a 4-column group, whose other columns the
    kernel zeroes.  Gates as above."""
    g = torch.Generator(device=dev).manual_seed(rep * 1000 + D + S)
    B, hkv = 4, 2
    W = da.gqa_slice_width(S, da.gqa_splits(S))
    if cache_dtype == torch.int8:
        cache = torch.randint(-127, 128, (1, B, 2, hkv, D, S), generator=g,
                              device=dev, dtype=torch.int8)
        fresh = tuple(torch.randint(-127, 128, (B, hkv, D, 1), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
        ks = torch.tensor(1 / 40.0, device=dev)
    else:
        cache = torch.randn(1, B, 2, hkv, D, S, generator=g,
                            device=dev).bfloat16()
        fresh = tuple(torch.randn(B, hkv, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        ks = None
    q = torch.randn(B, hkv * rep, 1, D, generator=g, device=dev).bfloat16()
    seq = torch.tensor([1, S, S, min(S, W + 30)], dtype=torch.int32,
                       device=dev)
    start = torch.tensor([0, 0, min(W, S - 10), 3], dtype=torch.int32,
                         device=dev)
    kw = dict(kv_quant_orig_scale=ks, start_index=start)
    before = da.launches["gqa_decode_attention"]
    if rep == 1:
        # q has the cache's heads: the dispatch takes kernel 1, so the
        # grouped kernel's C entry is called as the wrapper calls it
        out = torch.empty(B, hkv * D, dtype=torch.bfloat16, device=dev)
        _build.check(_build.load("gqa_decode_attention").gqa_decode_attention(
            q.data_ptr(), cache.data_ptr(), int(cache_dtype == torch.int8),
            0, B, hkv, 1, D, S, da.gqa_splits(S), W, seq.data_ptr(),
            start.data_ptr(), None if ks is None else ks.data_ptr(),
            D ** -0.5, fresh[0].data_ptr(), fresh[1].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "gqa_decode_attention")
        out = out.view(B, hkv, 1, D)
    else:
        out = da.fused_decode_attention(cache, 0, q, seq, D ** -0.5,
                                        fresh_kv=fresh, **kw)
        assert da.launches["gqa_decode_attention"] == before + 1
    f32 = (lambda t: t) if cache_dtype == torch.int8 else (lambda t: t.float())
    ref = da.plain_gqa_decode_attention(f32(cache), 0, q.float(), seq,
                                        D ** -0.5,
                                        fresh_kv=tuple(map(f32, fresh)), **kw)
    ref16 = da.plain_gqa_decode_attention(cache, 0, q, seq, D ** -0.5,
                                          fresh_kv=fresh, **kw)
    torch.cuda.synchronize()
    assert out.shape == (B, hkv * rep, 1, D)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


def test_gqa_kernel_int8_at_the_decoder_path_shape(dev):
    """The decoder path under woq8 + an int8 KV cache: batch 8, one KV head
    under 16 query heads of 128, S 84 at sequence 70, start 4, the cache the
    bf16 values quantised at a per-tensor step, the fresh column int8:
    kernel 1's gates against the plain version."""
    g = torch.Generator(device=dev).manual_seed(84)
    B, hkv, rep, D, S = 8, 1, 16, 128, 84
    step = 4 / 127
    cache = torch.clamp(torch.round(torch.randn(
        24, B, 2, hkv, D, S, generator=g, device=dev) / step), -128,
        127).to(torch.int8)
    fresh = tuple(torch.clamp(torch.round(torch.randn(
        B, hkv, D, 1, generator=g, device=dev) / step), -128, 127)
        .to(torch.int8) for _ in range(2))
    q = torch.randn(B, hkv * rep, 1, D, generator=g, device=dev).bfloat16()
    seq = torch.full((B,), 70, dtype=torch.int32, device=dev)
    kw = dict(kv_quant_orig_scale=torch.tensor([step], device=dev),
              start_index=torch.full((B,), 4, dtype=torch.int32,
                                     device=dev), fresh_kv=fresh)
    before = da.launches["gqa_decode_attention"]
    out = da.fused_decode_attention(cache, 23, q, seq, D ** -0.5, **kw)
    assert da.launches["gqa_decode_attention"] == before + 1
    ref = da.plain_gqa_decode_attention(cache, 23, q.float(), seq,
                                        D ** -0.5, **kw)
    ref16 = da.plain_gqa_decode_attention(cache, 23, q, seq, D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 1e-2
    assert _rel(out, ref16) < 2e-2


def test_gqa_kernel_refuses_a_slice_width_it_does_not_take(dev):
    """The slice width is the wrapper's; the C entry refuses one that is
    not a multiple of 16 or whose slices do not cover S, before any
    launch."""
    B, D, S = 1, 64, 448
    cache = torch.zeros(1, B, 2, 1, D, S, device=dev).bfloat16()
    q = torch.zeros(B, 16, 1, D, device=dev).bfloat16()
    seq = torch.full((B,), S, dtype=torch.int32, device=dev)
    out = torch.empty(B, 16 * D, dtype=torch.bfloat16, device=dev)
    fn = _build.load("gqa_decode_attention").gqa_decode_attention
    splits = da.gqa_splits(S)
    for W in (da.gqa_slice_width(S, splits) - 16, 120, 0):
        assert fn(q.data_ptr(), cache.data_ptr(), 0, 0, B, 1, 16, D, S,
                  splits, W, seq.data_ptr(), None, None, 0.125, None, None,
                  out.data_ptr(), torch.cuda.current_stream().cuda_stream) \
            != 0


def test_gqa_kernel_ignores_non_finite_masked_columns(dev):
    """Columns below the start and past the valid length hold NaN and inf:
    P*V multiplies them by p = 0 on the tensor cores, so the kernel zeroes
    them in shared memory first; the output equals the one over a cache
    whose masked columns are finite."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, D, S = 2, 16, 128, 84
    cache = torch.randn(1, B, 2, 1, D, S, generator=g, device=dev).bfloat16()
    fresh = tuple(torch.randn(B, 1, D, 1, generator=g, device=dev).bfloat16()
                  for _ in range(2))
    q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
    seq = torch.tensor([70, 33], dtype=torch.int32, device=dev)
    start = torch.tensor([4, 5], dtype=torch.int32, device=dev)
    clean = da.fused_decode_attention(cache, 0, q, seq, D ** -0.5,
                                      fresh_kv=fresh, start_index=start)
    dirty = cache.clone()
    dirty[:, 0, :, :, :, :4] = float("nan")
    dirty[:, 0, :, :, :, 69:] = float("inf")
    dirty[:, 1, :, :, :, :5] = float("-inf")
    dirty[:, 1, :, :, :, 32:] = float("nan")
    out = da.fused_decode_attention(dirty, 0, q, seq, D ** -0.5,
                                    fresh_kv=fresh, start_index=start)
    torch.cuda.synchronize()
    assert torch.equal(out, clean)


def test_gqa_kernel_refuses_what_it_does_not_take(dev):
    """fp8 caches and the K-step tail raise instead of falling back; the
    grouped mode needs the fresh K/V and takes no out-projection, as the
    JAX dispatch asserts."""
    q = torch.zeros(2, 4, 1, 64, device=dev).bfloat16()
    cache = torch.zeros(1, 2, 2, 1, 64, 16, device=dev).bfloat16()
    fresh = (torch.zeros(2, 1, 64, 1, device=dev).bfloat16(),) * 2
    seq = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        da.fused_decode_attention(cache.to(torch.float8_e4m3fn), 0, q, seq,
                                  0.125, fresh_kv=tuple(
                                      t.to(torch.float8_e4m3fn)
                                      for t in fresh))
    with pytest.raises(NotImplementedError):
        da.fused_decode_attention(cache, 0, q, seq, 0.125, fresh_kv=fresh,
                                  tail_kv=(cache, 0))
    with pytest.raises(ValueError):
        da.fused_decode_attention(cache, 0, q, seq, 0.125)
    w = torch.zeros(256, 256, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):
        da.fused_decode_attention(cache, 0, q, seq, 0.125, fresh_kv=fresh,
                                  proj=(w, torch.ones(256, device=dev), None))


# -- the paged decode kernel ---------------------------------------------------

def _paged_inputs(g, dev, hkv, rep, D, T, seq, pool_dtype, L=2, N=64):
    """(pool, q, table, seq, kwargs): a stacked pool [L, N, 2, hkv, T, D]
    whose rows own permuted draws of its blocks (non-monotonic), -1 past
    each row's length (all -1 for a row of length 0).  No table names the
    last block, the sink of the pool writes (``new_block_pool``)."""
    shape = (L, N, 2, hkv, T, D)
    if pool_dtype == torch.int8:
        pool = torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
        kw = dict(kv_quant_orig_scale=torch.tensor(1 / 40.0, device=dev))
    else:
        pool = torch.randn(shape, generator=g, device=dev).bfloat16()
        kw = {}
    mb = max(-(-n // T) for n in seq)
    perm = torch.randperm(N - 1, generator=g, device=dev).tolist()
    table = torch.full((len(seq), mb), -1, dtype=torch.int32)
    for i, n in enumerate(seq):
        need = -(-n // T)
        table[i, :need] = torch.tensor(perm[:need])
        perm = perm[need:]
    q = torch.randn(len(seq), hkv * rep, 1, D, generator=g,
                    device=dev).bfloat16()
    return (pool, q, table.to(dev),
            torch.tensor(seq, dtype=torch.int32, device=dev), kw)


@pytest.mark.parametrize("shape", ["serve", "mqa", "gqa"])
@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.bfloat16])
def test_paged_kernel_matches_plain(dev, pool_dtype, shape):
    """Serve shapes (16 KV heads of 64, T 32), MQA (one KV head under 16
    query heads of 128, T 32) and GQA (4 KV heads x 4, T 16); lengths 0,
    1, T-1, T, T+1, 2T+5 and a full table of 9 blocks (two chunks of the
    kernel at T 32).  The live rows are within the gates of the other
    kernels; the row of length 0 is zeros."""
    hkv, rep, D, T = {"serve": (16, 1, 64, 32), "mqa": (1, 16, 128, 32),
                      "gqa": (4, 4, 64, 16)}[shape]
    g = torch.Generator(device=dev).manual_seed(11)
    seq = [0, 1, T - 1, T, T + 1, 2 * T + 5, 9 * T]
    pool, q, table, seq_t, kw = _paged_inputs(g, dev, hkv, rep, D, T, seq,
                                              pool_dtype)
    before = da.launches["paged_decode_attention"]
    out = da.fused_paged_decode_attention(pool, 1, q, table, seq_t, 0.125,
                                          **kw)
    assert da.launches["paged_decode_attention"] == before + 1
    f32 = (lambda t: t) if pool_dtype == torch.int8 else (lambda t: t.float())
    ref = da.plain_paged_decode_attention(f32(pool), 1, q.float(), table,
                                          seq_t, 0.125, **kw)
    ref16 = da.plain_paged_decode_attention(pool, 1, q, table, seq_t, 0.125,
                                            **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert bool((out[0] == 0).all())
    assert _rel(out[1:], ref[1:]) < 1e-2
    assert _rel(out[1:], ref16[1:]) < 2e-2


@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 16])
@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.bfloat16])
def test_paged_kernel_layouts(dev, pool_dtype, rep, D, T):
    """Query heads a KV head 1, 4 and 16, head dims 64 and 128, blocks of 16
    and 32 tokens, and table widths 1 to 8 (a cluster from 5 blocks of 32
    on), each with rows of length 0, 1, T - 1, T and the two longest the
    table holds: against the fp32 plain version (1e-2) and the bf16 one
    (2e-2); the row of length 0 is zeros."""
    g = torch.Generator(device=dev).manual_seed(20 + rep + D + T)
    hkv = {1: 4, 4: 2, 16: 1}[rep]
    for mb in range(1, 9):
        seq = [0, 1, T - 1, T, max(1, mb * T - 3), mb * T]
        pool, q, table, seq_t, kw = _paged_inputs(g, dev, hkv, rep, D, T,
                                                  seq, pool_dtype, L=1)
        assert table.shape[1] == mb
        out = da.fused_paged_decode_attention(pool, 0, q, table, seq_t,
                                              D ** -0.5, **kw)
        f32 = (lambda t: t) if pool_dtype == torch.int8 else (
            lambda t: t.float())
        ref = da.plain_paged_decode_attention(f32(pool), 0, q.float(), table,
                                              seq_t, D ** -0.5, **kw)
        ref16 = da.plain_paged_decode_attention(pool, 0, q, table, seq_t,
                                                D ** -0.5, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), mb
        assert bool((out[0] == 0).all()), mb
        assert _rel(out[1:], ref[1:]) < 1e-2, mb
        assert _rel(out[1:], ref16[1:]) < 2e-2, mb


@pytest.mark.parametrize("shape", ["serve", "mqa"])
def test_paged_kernel_every_length(dev, shape):
    """Every length from 0 to the full table (4 blocks of 32) in one call,
    a row each, at the serve shape (bf16, 16 KV heads of 64) and the MQA
    shape (int8, one KV head under 16 query heads of 128)."""
    g = torch.Generator(device=dev).manual_seed(30)
    hkv, rep, D, dtype = {"serve": (16, 1, 64, torch.bfloat16),
                          "mqa": (1, 16, 128, torch.int8)}[shape]
    seq = list(range(0, 4 * 32 + 1))
    pool, q, table, seq_t, kw = _paged_inputs(g, dev, hkv, rep, D, 32, seq,
                                              dtype, L=1, N=340)
    out = da.fused_paged_decode_attention(pool, 0, q, table, seq_t, 0.125,
                                          **kw)
    f32 = (lambda t: t) if dtype == torch.int8 else (lambda t: t.float())
    ref = da.plain_paged_decode_attention(f32(pool), 0, q.float(), table,
                                          seq_t, 0.125, **kw)
    torch.cuda.synchronize()
    assert bool((out[0] == 0).all())
    for n in seq[1:]:
        assert _rel(out[n], ref[n]) < 1e-2, n


def _paged_entry(dev, pool, q, table, seq, out, plan, scale=0.125, ks=None):
    """The paged kernel's C entry with an explicit plan; its return code."""
    L, N, _, hkv, T, D = pool.shape
    B, H = q.shape[0], q.shape[1]
    return _build.load("paged_decode_attention").paged_decode_attention(
        q.data_ptr(), pool.data_ptr(), int(pool.dtype == torch.int8), 0, N,
        hkv, H // hkv, T, D, B, table.shape[1], table.data_ptr(),
        seq.data_ptr(), None if ks is None else ks.data_ptr(), scale,
        plan["splits"], plan["width"], plan["warps"], plan["rounds"],
        plan["heads"], out.data_ptr(), torch.cuda.current_stream().cuda_stream)


@pytest.mark.parametrize("splits,warps,heads", [
    (1, 4, 1), (1, 2, 1), (1, 1, 1), (2, 2, 1), (2, 1, 2), (4, 1, 1),
    (4, 2, 2), (1, 4, 2)])
def test_paged_kernel_takes_other_plans(dev, splits, warps, heads):
    """At the serve path's table (4 blocks of 32), plans other than the
    wrapper's (a cluster of 1, 2 or 4 slices, 1 to 4 warps, 1 or 2 query
    heads a block) give the same context within fp32 summation order."""
    g = torch.Generator(device=dev).manual_seed(31)
    seq = [0, 1, 31, 32, 33, 61, 80, 128]
    pool, q, table, seq_t, _ = _paged_inputs(g, dev, 2, 4, 64, 32, seq,
                                             torch.bfloat16, L=1)
    table = torch.nn.functional.pad(table, (0, 4 - table.shape[1]),
                                    value=-1).contiguous()
    width = 128 // splits
    plan = dict(splits=splits, width=width, warps=warps,
                rounds=-(-width // (32 * warps)), heads=heads)
    out = torch.empty_like(q)
    assert _paged_entry(dev, pool, q, table, seq_t, out, plan) == 0
    ref = da.plain_paged_decode_attention(pool.float(), 0, q.float(), table,
                                          seq_t, 0.125)
    torch.cuda.synchronize()
    assert bool((out[0] == 0).all())
    assert _rel(out[1:], ref[1:]) < 1e-2


def test_paged_kernel_refuses_a_plan_it_does_not_take(dev):
    """Slices that miss a token or leave the last one empty, widths that
    are not a multiple of 32, more than 8 blocks a cluster, warps other
    than 1, 2 or 4, heads other than 1 or 2 and a miscounted number of
    rounds."""
    g = torch.Generator(device=dev).manual_seed(32)
    pool, q, table, seq_t, _ = _paged_inputs(g, dev, 2, 1, 64, 32, [80, 128],
                                             torch.bfloat16, L=1)
    out = torch.empty_like(q)
    good = da.paged_plan(4, 32, 1)
    assert _paged_entry(dev, pool, q, table, seq_t, out, good) == 0
    for bad in (dict(good, width=96), dict(good, splits=2, width=128),
                dict(good, width=100), dict(good, splits=9, width=32),
                dict(good, warps=3), dict(good, heads=3),
                dict(good, warps=8, rounds=1), dict(good, heads=4),
                dict(good, rounds=2)):
        assert _paged_entry(dev, pool, q, table, seq_t, out, bad) != 0, bad
    torch.cuda.synchronize()


def test_paged_kernel_offsets_past_2_31(dev):
    """An int8 pool of 2 layers x 262160 blocks of [2, 1, 32, 128] (4.3 GB):
    every block of layer 1 lies past element 2^31, and the rows read blocks
    at the end of the pool (32-bit offsets would wrap)."""
    g = torch.Generator(device=dev).manual_seed(12)
    per_block = 2 * 1 * 32 * 128
    N = 2 ** 31 // per_block + 16
    pool = torch.empty((2, N, 2, 1, 32, 128), dtype=torch.int8, device=dev)
    table = torch.tensor([[N - 1, N - 7, N - 3], [N - 2, N - 16, -1]],
                         dtype=torch.int32, device=dev)
    used = table[table >= 0].long()
    pool[1, used] = torch.randint(-127, 128, (len(used), 2, 1, 32, 128),
                                  generator=g, device=dev, dtype=torch.int8)
    q = torch.randn(2, 16, 1, 128, generator=g, device=dev).bfloat16()
    seq = torch.tensor([90, 40], dtype=torch.int32, device=dev)
    ks = torch.tensor(1 / 40.0, device=dev)
    out = da.fused_paged_decode_attention(pool, 1, q, table, seq, 0.1,
                                          kv_quant_orig_scale=ks)
    ref = da.plain_paged_decode_attention(pool, 1, q.float(), table, seq,
                                          0.1, kv_quant_orig_scale=ks)
    torch.cuda.synchronize()
    assert (1 * N + int(used.min())) * per_block > 2 ** 31
    assert _rel(out, ref) < 1e-2


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.bfloat16])
def test_paged_kernel_rounds_p_before_pv(dev, pool_dtype):
    """As for kernel 1, through a permuted table: 16 query heads over one
    KV head, 8 blocks of 32 (256 tokens, one chunk of the kernel); the first
    token scores s0 above the other 255, whose probability exp(-s0) =
    0.25088 sits 0.45 of a bf16 step above 0.25, and every value column is
    the same.  The context is then c (1 + 255 bf16(p)) / (1 + 255 p) =
    0.9966 c with P rounded before P·V, and c without; the bf16 output must
    be the first."""
    H, D, T, NB = 16, 64, 32, 8
    p_other = 128.45 * 2.0 ** -9
    scale = -float(np.log(p_other))
    table = torch.tensor([[5, 2, 7, 0, 3, 6, 1, 4]], dtype=torch.int32,
                         device=dev)
    pool = torch.zeros(1, NB, 2, 1, T, D, device=dev, dtype=pool_dtype)
    pool[0, 5, 0, 0, 0, 0] = 1                 # position 0 is block 5, row 0
    c = (torch.arange(D, device=dev) % 7 + 1).to(pool_dtype)
    pool[0, :, 1, 0] = c
    q = torch.zeros(1, H, 1, D, device=dev, dtype=torch.bfloat16)
    q[..., 0] = 1
    kw = (dict(kv_quant_orig_scale=torch.tensor(1.0, device=dev))
          if pool_dtype == torch.int8 else {})
    seq = torch.tensor([NB * T], dtype=torch.int32, device=dev)
    out = da.fused_paged_decode_attention(pool, 0, q, table, seq, scale,
                                          **kw)[:, :, 0]
    # the same cache, dense and seq-minor [1, 1, 2, H, D, S], heads repeated
    blocks = pool[0][table[0].long()]               # [NB, 2, 1, T, D]
    dense = blocks.permute(1, 2, 4, 0, 3).reshape(2, 1, D, NB * T)
    dense = dense.repeat_interleave(H, dim=1)[None, None]
    ref16, ref32 = (_chunked_ctx(dense, 0, q, NB * T, scale, 1.0, r,
                                 chunk=NB * T).to(torch.bfloat16)
                    for r in (True, False))
    torch.cuda.synchronize()
    assert torch.equal(out, ref16)
    assert bool((out != ref32).all())


def test_paged_step_does_not_wait_for_the_device(dev):
    """The pool writes (rows through -1 slots among them, and a call where
    no row is valid), the kernel's wrapper and a whole one-token model step
    over the pool run without a host synchronisation: a serving tick makes
    all its calls on the host before it fetches its tokens."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig, DecoderLMHead)
    from eddie_wang_hackathon2023_tpu_torch.ops.paged_attention import \
        PagedCacheState
    g = torch.Generator(device=dev).manual_seed(13)
    pool, q, table, seq, _ = _paged_inputs(g, dev, 4, 2, 64, 16,
                                           [0, 5, 40], torch.bfloat16)
    k = torch.randn(3, 4, 6, 64, generator=g, device=dev).bfloat16()
    with torch.device(dev):
        model = DecoderLMHead(DecoderConfig(
            vocab_size=97, hidden_size=256, num_layers=2, num_heads=4,
            num_kv_heads=4, max_position_embeddings=64)).eval()
    tok = torch.zeros((3, 1), dtype=torch.long, device=dev)
    step = dict(tokens=tok, write_index=seq - 1, sequence_length=seq)
    with torch.inference_mode():
        model(kv_cache=PagedCacheState(pool, table), **step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        paged_prefill(pool, k, k, table, layer_idx=1)
        paged_append_kv(pool, k[:, :, :1], k[:, :, :1], table, seq - 1,
                        layer_idx=1)
        paged_append_kv(pool, k[:1, :, :1], k[:1, :, :1], table[:1], seq[:1],
                        layer_idx=0)
        out = da.fused_paged_decode_attention(pool, 1, q, table, seq, 0.125)
        with torch.inference_mode():
            model(kv_cache=PagedCacheState(pool, table), **step)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def test_paged_kernel_refuses_what_it_does_not_take(dev):
    """fp8 pools, non-bf16 q, float32 pools, head dims that are not a
    multiple of 16, a table on another device, an int8 pool without its
    scale and several query tokens raise instead of falling back."""
    pool = torch.zeros(1, 4, 2, 1, 8, 64, device=dev).bfloat16()
    q = torch.zeros(2, 4, 1, 64, device=dev).bfloat16()
    table = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32, device=dev)
    seq = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    fpd = da.fused_paged_decode_attention
    with pytest.raises(NotImplementedError):
        fpd(pool.to(torch.float8_e4m3fn), 0, q, table, seq, 0.125)
    with pytest.raises(TypeError):
        fpd(pool, 0, q.float(), table, seq, 0.125)
    with pytest.raises(TypeError):
        fpd(pool.float(), 0, q, table, seq, 0.125)
    with pytest.raises(ValueError):
        fpd(pool[..., :24].contiguous(), 0, q[..., :24].contiguous(), table,
            seq, 0.125)
    with pytest.raises(TypeError):
        fpd(pool, 0, q, table.cpu(), seq, 0.125)
    with pytest.raises(ValueError):
        fpd(pool.to(torch.int8), 0, q, table, seq, 0.125)
    with pytest.raises(NotImplementedError):
        fpd(pool, 0, torch.zeros(2, 4, 2, 64, device=dev).bfloat16(), table,
            seq, 0.125)


def _int4_operands(dev, g, k, n, groups):
    """Packed weights [K/2, N] (every byte value) and scales: [N] for
    groups 0 (per channel), else [groups, N], sized for outputs of order
    one."""
    qw = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                       dtype=torch.int8)
    shape = (n,) if groups == 0 else (groups, n)
    sc = (torch.rand(shape, generator=g, device=dev) + 0.5) / (4.6 * k ** 0.5)
    return qw, sc


@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("k,n,groups", [
    (2048, 2304, 16), (2048, 2048, 16), (2048, 8192, 16), (8192, 2048, 64),
    (2048, 2048, 0), (128, 256, 1), (1280, 1280, 0), (2048, 1040, 16),
    (256, 1000, 2), (384, 256, 3)], ids=[
    "qkv", "dense", "fc", "proj", "per_channel", "one_group", "n1280",
    "n1040", "n1000", "k384"])
def test_int4_kernel_matches_plain(dev, m, k, n, groups):
    """The SantaCoder-1B linears in groups of 128, per channel, one group
    ([1, N]), N at the edges of the 128-column tiles and of the 16-byte
    loads, K 384 in groups of 128 (a byte's nibbles in different groups);
    M 1, 8 (the decode entry, K split over a cluster) and 512 (the
    prefill entry)."""
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    qw, sc = _int4_operands(dev, g, k, n, groups)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    before = iq.launches["int4_quant_matmul"]
    out = iq.quant_matmul_int4(x, qw, sc)
    assert iq.launches["int4_quant_matmul"] == before + 1
    ref = iq.plain_quant_matmul_int4(x, qw, sc)
    ref32 = iq.plain_quant_matmul_int4(x.float(), qw, sc)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 2e-2 and _rel(out, ref32) < 1e-2
    # both entries sum in a fixed order: a second call is bit-equal, and the
    # [..., K] leading dims pass through
    again = iq.quant_matmul_int4(x.reshape(1, m, k), qw, sc)
    assert torch.equal(again[0], out)


@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("scales", ["per_channel", "one_group", "groups128"])
@pytest.mark.parametrize("k,n", [(2048, 2304), (2048, 2048), (2048, 8192),
                                 (8192, 2048)],
                         ids=["qkv", "dense", "fc", "proj"])
def test_int4_decode_entry_matches_plain(dev, m, scales, k, n):
    """The decode entry (M <= 32) at the SantaCoder-1B linears, per channel
    ([N] scales), one group ([1, N]: the scale on the accumulator) and
    groups of 128, with the wrapper's plan: held to the int4 gates (2e-2
    of the bf16 plain version, 1e-2 of the fp32 one), one launch, and a
    second call bit-equal (its sum order is fixed)."""
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    groups = {"per_channel": 0, "one_group": 1, "groups128": k // 128}[scales]
    qw, sc = _int4_operands(dev, g, k, n, groups)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    before = iq.launches["int4_quant_matmul"]
    out = iq.quant_matmul_int4(x, qw, sc)
    assert iq.launches["int4_quant_matmul"] == before + 1
    ref = iq.plain_quant_matmul_int4(x, qw, sc)
    ref32 = iq.plain_quant_matmul_int4(x.float(), qw, sc)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 2e-2 and _rel(out, ref32) < 1e-2
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc), out)


def test_int4_decode_entry_refuses_other_plans(dev):
    """The decode entry's C function refuses a plan that does not cover
    K/2 exactly, a cluster past 8, warps other than 4 or 8, M past 32, and
    launches nothing; the wrapper's plan launches."""
    g = torch.Generator(device=dev).manual_seed(5)
    qw, sc = _int4_operands(dev, g, 2048, 2048, 16)
    x = torch.randn(8, 2048, generator=g, device=dev).bfloat16()
    out = torch.empty(8, 2048, dtype=torch.bfloat16, device=dev)
    lib = _build.load("int4_quant_matmul")
    stream = torch.cuda.current_stream().cuda_stream

    def call(m, cluster, warps, steps):
        return lib.int4_quant_matmul_decode(
            x.data_ptr(), qw.data_ptr(), sc.data_ptr(), m, 2048, 2048, 16,
            cluster, warps, steps, out.data_ptr(), stream)

    plan = iq.decode_plan(8, 2048, 2048, 132)
    assert call(8, plan["cluster"], plan["warps"], plan["steps"]) == 0
    for bad in [(8, 8, 8, 1), (8, 16, 8, 1), (8, 4, 2, 16), (8, 8, 6, 3),
                (33, 8, 8, 2), (8, 8, 8, 0)]:
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("k,n,rows", [
    (384, 256, [0, 150, 191, 192, 342, 383, 64, 300]),
    (8192, 2048, [0, 4095, 4096, 8191, 1000, 5000, 2047, 6143])])
def test_int4_kernel_rounding_rules_one_hot(dev, k, n, rows):
    """Row m of x is e_{k_m}: output row m is row k_m of the dequantised
    weight, with no sum involved.  Grouped: bf16(q * bf16(scale)) bit for
    bit (a scale not rounded first gives other values); per channel:
    bf16(q * scale) with the fp32 scale, bit for bit.  Rows in both halves
    of K; 8 rows take the decode entry, which at K 8192 splits K over a
    cluster."""
    g = torch.Generator(device=dev).manual_seed(k)
    groups = k // 128
    qw, sc = _int4_operands(dev, g, k, n, groups)
    idx = torch.tensor(rows, device=dev)
    x = torch.zeros(len(rows), k, device=dev, dtype=torch.bfloat16)
    x[torch.arange(len(rows), device=dev), idx] = 1
    q = unpack_int4(qw)[idx].float()
    s_g = sc[idx // 128]
    grouped = (q * s_g.bfloat16().float()).bfloat16()
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc), grouped)
    assert not torch.equal(grouped, (q * s_g).bfloat16())
    channel = (q * sc[0]).bfloat16()
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc[0]), channel)
    assert not torch.equal(channel, (q * sc[0].bfloat16().float()).bfloat16())


@pytest.mark.parametrize("k,n,rows", [
    (384, 256, [0, 150, 191, 192, 342, 383, 64, 300]),
    (8192, 2048, [0, 4095, 4096, 8191, 1000, 5000, 2047, 6143])])
def test_int4_prefill_entry_rounding_rules_one_hot(dev, k, n, rows):
    """The same pins through the prefill entry (M 40 > 32: the one-hot
    rows after 32 zero rows), which keeps its own dequantisation."""
    g = torch.Generator(device=dev).manual_seed(k + 1)
    groups = k // 128
    qw, sc = _int4_operands(dev, g, k, n, groups)
    idx = torch.tensor(rows, device=dev)
    x = torch.zeros(32 + len(rows), k, device=dev, dtype=torch.bfloat16)
    x[32 + torch.arange(len(rows), device=dev), idx] = 1
    q = unpack_int4(qw)[idx].float()
    grouped = (q * sc[idx // 128].bfloat16().float()).bfloat16()
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc)[32:], grouped)
    channel = (q * sc[0]).bfloat16()
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc[0])[32:], channel)


_INT4_SHAPES = [(2048, 2304, 16), (2048, 2048, 16), (2048, 8192, 16),
                (8192, 2048, 64), (2048, 2048, 0), (128, 256, 1),
                (1280, 1280, 0), (2048, 1040, 16), (256, 1000, 2),
                (384, 256, 3)]
_INT4_IDS = ["qkv", "dense", "fc", "proj", "per_channel", "one_group",
             "n1280", "n1040", "n1000", "k384"]


@pytest.mark.parametrize("m", [33, 64, 100, 512, 1000])
@pytest.mark.parametrize("k,n,groups", _INT4_SHAPES, ids=_INT4_IDS)
def test_int4_prefill_entry_matches_plain(dev, m, k, n, groups):
    """The prefill entry (M > 32, `wgmma` with the wrapper's
    ``prefill_plan``: 32 to 256 rows of x a block, the last block's rows
    cut by M) at every shape of ``test_int4_kernel_matches_plain``: held
    to the int4 gates (2e-2 of the bf16 plain version, 1e-2 of the fp32
    one), one launch, and a second call bit-equal (one block a tile, a
    fixed sum order)."""
    g = torch.Generator(device=dev).manual_seed(k + n + m + 1)
    qw, sc = _int4_operands(dev, g, k, n, groups)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    before = iq.launches["int4_quant_matmul"]
    out = iq.quant_matmul_int4(x, qw, sc)
    assert iq.launches["int4_quant_matmul"] == before + 1
    ref = iq.plain_quant_matmul_int4(x, qw, sc)
    ref32 = iq.plain_quant_matmul_int4(x.float(), qw, sc)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) < 2e-2 and _rel(out, ref32) < 1e-2
    assert torch.equal(iq.quant_matmul_int4(x, qw, sc), out)


def test_int4_prefill_entry_refuses_other_plans(dev):
    """The prefill entry's C function refuses rows of x it has no
    instantiation for, a ring of fewer than 2 or more than 8 stages or one
    that does not fit 227 KB, K not a multiple of 64, and launches
    nothing; the wrapper's plan, and the other rows it takes, launch and
    agree."""
    g = torch.Generator(device=dev).manual_seed(6)
    qw, sc = _int4_operands(dev, g, 2048, 2048, 16)
    x = torch.randn(100, 2048, generator=g, device=dev).bfloat16()
    out = torch.empty(100, 2048, dtype=torch.bfloat16, device=dev)
    lib = _build.load("int4_quant_matmul")
    stream = torch.cuda.current_stream().cuda_stream

    def call(rows, stages, k=2048):
        return lib.int4_quant_matmul(
            x.data_ptr(), qw.data_ptr(), sc.data_ptr(), 100, 2048, k, 16,
            rows, stages, out.data_ptr(), stream)

    plan = iq.prefill_plan(100, 2048, 2048, 132)
    assert call(plan["rows"], plan["stages"]) == 0
    want = iq.plain_quant_matmul_int4(x, qw, sc)
    torch.cuda.synchronize()
    assert _rel(out, want) < 2e-2
    for rows in iq.PREFILL_ROWS:
        assert call(rows, 2) == 0
        torch.cuda.synchronize()
        assert _rel(out, want) < 2e-2, rows
    for bad in [(48, 2), (16, 4), (512, 2), (64, 1), (64, 9), (256, 4),
                (64, 4, 2016)]:
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("B", [1, 2, 5, 8])
@pytest.mark.parametrize("K", [64, 1280, 4096])
@pytest.mark.parametrize("N", [4, 96, 1000, 1280])
def test_gemv_matches_plain(dev, N, K, B, bias):
    """The out-projection GEMV (a cluster along K by the wrapper's
    ``gemv_plan``) through a 3-D weight's layer index, with and without a
    bias, against ``weight_only_quant_matmul`` + bias: 1e-2 of the fp32
    plain version, 2e-2 of the bf16 one; one launch; a second call
    bit-equal (the ranks' sums meet in a fixed order)."""
    g = torch.Generator(device=dev).manual_seed(N + K + B)
    w = torch.randint(-127, 128, (3, K, N), generator=g, device=dev,
                      dtype=torch.int8)
    scale = (torch.rand(N, generator=g, device=dev) + 0.5) / (64 * K ** 0.5)
    b = (torch.randn(N, generator=g, device=dev) * 0.1).bfloat16() \
        if bias else None
    x = torch.randn(B, K, generator=g, device=dev).bfloat16()
    before = da.launches["out_proj_gemv"]
    out = da.out_proj_gemv(x, 1, w, scale, b)
    assert da.launches["out_proj_gemv"] == before + 1
    ref32 = weight_only_quant_matmul(x.float(), w[1], scale)
    ref = weight_only_quant_matmul(x, w[1], scale)
    if bias:
        ref32 = ref32 + b.float()
        ref = ref + b
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (B, N)
    assert _rel(out, ref32) < 1e-2 and _rel(out, ref) < 2e-2
    assert torch.equal(da.out_proj_gemv(x, 1, w, scale, b), out)


def test_gemv_refuses_other_plans(dev):
    """The GEMV's C function refuses a cluster past 8, ranks that do not
    cover K or leave one empty, a batch tile other than 1, 2, 4 or 8, and
    launches nothing; the wrapper's plan and other covering plans
    launch and agree."""
    g = torch.Generator(device=dev).manual_seed(7)
    K = N = 1280
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=dev) / 1000
    x = torch.randn(2, K, generator=g, device=dev).bfloat16()
    out = torch.empty(2, N, dtype=torch.bfloat16, device=dev)
    lib = _build.load("decode_attention")
    stream = torch.cuda.current_stream().cuda_stream

    def call(cluster, rows, batch):
        return lib.out_proj_gemv(x.data_ptr(), w.data_ptr(), 0,
                                 scale.data_ptr(), None, out.data_ptr(), 2,
                                 K, N, cluster, rows, batch, stream)

    want = weight_only_quant_matmul(x.float(), w, scale)
    for plan in [da.gemv_plan(2, K, N, 132), dict(cluster=1, rows=K,
                                                  batch=1),
                 dict(cluster=8, rows=160, batch=4)]:
        assert call(plan["cluster"], plan["rows"], plan["batch"]) == 0
        torch.cuda.synchronize()
        assert _rel(out, want) < 1e-2, plan
    for bad in [(16, 80, 2), (6, 200, 2), (8, 214, 2), (6, 214, 3),
                (0, K, 1)]:
        assert call(*bad) != 0, bad
    torch.cuda.synchronize()


def test_int4_kernel_takes_unaligned_views(dev):
    """x, weight and scales that start 2, 1 and 4 bytes past a 16-byte
    boundary (the kernel copies 16-byte vectors): the wrapper copies them,
    and the result equals the aligned call's."""
    g = torch.Generator(device=dev).manual_seed(3)
    qw, sc = _int4_operands(dev, g, 256, 256, 2)
    x = torch.randn(8, 256, generator=g, device=dev).bfloat16()
    want = iq.quant_matmul_int4(x, qw, sc)
    xb = torch.empty(8 * 256 + 1, device=dev, dtype=torch.bfloat16)
    xb[1:] = x.reshape(-1)
    qb = torch.empty(128 * 256 + 1, device=dev, dtype=torch.int8)
    qb[1:] = qw.reshape(-1)
    sb = torch.empty(2 * 256 + 1, device=dev)
    sb[1:] = sc.reshape(-1)
    got = iq.quant_matmul_int4(xb[1:].view(8, 256), qb[1:].view(128, 256),
                               sb[1:].view(2, 256))
    assert torch.equal(got, want)


def test_int4_kernel_refuses_what_it_does_not_take(dev):
    """fp32 and fp16 activations, K not a multiple of 64, groups of fewer
    than 32 rows, fp64 scales and weights on the CPU raise instead of
    falling back; nothing is launched."""
    g = torch.Generator(device=dev).manual_seed(0)
    qw, sc = _int4_operands(dev, g, 256, 128, 2)
    x = torch.randn(4, 256, generator=g, device=dev)
    before = iq.launches["int4_quant_matmul"]
    with pytest.raises(TypeError):
        iq.quant_matmul_int4(x, qw, sc)
    with pytest.raises(TypeError):
        iq.quant_matmul_int4(x.half(), qw, sc)
    xb = x.bfloat16()
    with pytest.raises(ValueError):                # K 96
        iq.quant_matmul_int4(xb[:, :96], qw[:48], sc[0])
    with pytest.raises(ValueError):                # 16 groups of 16 rows
        iq.quant_matmul_int4(xb, qw, sc[:1].repeat(16, 1))
    with pytest.raises(ValueError):
        iq.quant_matmul_int4(xb, qw, sc.double())
    with pytest.raises(ValueError):
        iq.quant_matmul_int4(xb, qw.cpu(), sc)
    assert iq.launches["int4_quant_matmul"] == before


def test_int4_decode_launch_count(dev):
    """``GenerationSession.decode`` on a tiny woq4 model (2 layers of width
    256, one KV head of 128, groups of 128, bf16): the int4 kernel runs four
    times a layer for every model call (the prefill and each step), the
    grouped kernel once a layer for every step."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig, DecoderLMHead)
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state, quantize_state)
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig)
    config = DecoderConfig(vocab_size=97, hidden_size=256, num_layers=2,
                           num_heads=2, num_kv_heads=1,
                           max_position_embeddings=64, dtype="bfloat16",
                           quant_mode=QuantMode.use_weight_only(True))
    with torch.device("meta"):
        shapes = DecoderLMHead(dataclasses.replace(
            config, quant_mode=QuantMode(0))).state_dict()
    rs = np.random.RandomState(0)
    state = {}
    for key, t in shapes.items():
        shape = tuple(t.shape)
        if key.startswith("blocks.0."):
            key, shape = "blocks." + key[len("blocks.0."):], (2,) + shape
        elif key.startswith("blocks."):
            continue
        x = rs.randn(*shape).astype(np.float32) * 0.02
        state[key] = x + 1.0 if key.endswith("norm.weight") or \
            key == "ln_f.weight" else x
    model = from_jax_state(quantize_state(state, config), config)
    sess = GenerationSession(
        ModelConfig(vocab_size=97, num_layers=2, num_heads=2,
                    hidden_size=256, max_seq_len=64, num_kv_heads=1), model,
        SamplingConfig(end_id=-1, pad_id=0))
    iq.reset_launches()
    da.reset_launches()
    new = 5
    tokens, _, _ = sess.decode(rs.randint(0, 97, (3, 6)).astype(np.int32),
                               np.asarray([6, 4, 6], np.int32),
                               max_new_tokens=new)
    assert iq.launches["int4_quant_matmul"] == 4 * 2 * new
    assert da.launches["gqa_decode_attention"] == 2 * (new - 1)
    assert da.launches["out_proj_gemv"] == 0
    assert bool(((tokens >= 0) & (tokens < 97)).all())


def _qkv(g, dev, b, h, lq, lk, d, dtype):
    """q [b,h,lq,d], k, v [b,h,lk,d]: strided views of one fused buffer,
    as the attention layer hands them over."""
    qkv = torch.randn(b, max(lq, lk), 3, h, d, generator=g,
                      device=dev).to(dtype)
    return tuple(qkv[:, :n, i].transpose(1, 2)
                 for i, n in enumerate((lq, lk, lk)))


@pytest.mark.parametrize("b,h,lq,lk,valid,dtype", [
    (1, 3, 256, 256, None, torch.bfloat16),
    (1, 3, 256, 256, None, torch.float32),
    (2, 4, 200, 200, 150, torch.bfloat16),
    (1, 2, 130, 200, None, torch.bfloat16),      # bottom-right, Lq < Lk
    (8, 16, 128, 128, None, torch.bfloat16),
    # the bf16 entry's plans: Lq at the 64-row blocks' and 64-key tiles'
    # edges and the custom path's 227 (keys over 2-4 warps)
    (1, 20, 128, 128, None, torch.bfloat16),
    (1, 20, 129, 129, None, torch.bfloat16),
    (1, 20, 255, 255, None, torch.bfloat16),
    (1, 20, 256, 256, None, torch.bfloat16),
    (1, 20, 227, 227, None, torch.bfloat16),
    (1, 20, 200, 256, None, torch.bfloat16),     # Lq < Lk, split keys
    (1, 20, 256, 256, 200, torch.bfloat16),      # valid < Lk, split keys
    (8, 20, 256, 256, None, torch.bfloat16),     # B * H past the SMs
    (1, 2, 600, 700, 650, torch.bfloat16),       # tiles in rounds
    (1, 2, 1024, 1024, None, torch.bfloat16),
    (1, 20, 227, 227, None, torch.float32),
    (1, 20, 200, 256, 230, torch.float32),
])
def test_flash_kernel_causal_matches_plain(dev, b, h, lq, lk, valid, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = _qkv(g, dev, b, h, lq, lk, 64, dtype)
    entry = "flash_attention_causal" + (
        "_f32" if dtype == torch.float32 else "")
    before = dict(fa.launches)
    out = fa.flash_mha(q, k, v, causal=True, scale=0.125, kv_valid_len=valid)
    assert fa.launches[entry] == before[entry] + 1
    assert sum(fa.launches.values()) == sum(before.values()) + 1
    ref = fa.plain_flash_mha(q.float(), k.float(), v.float(), causal=True,
                             scale=0.125, kv_valid_len=valid)
    torch.cuda.synchronize()
    assert _rel(out, ref) < (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_flash_kernel_causal_plans(dev, splits):
    """Every plan the causal entry takes gives the same function: the keys
    of [1,20,227,64] over 1-4 warps (one round, or rounds of fewer
    tiles), within 1e-2 of the fp32 plain version."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = _qkv(g, dev, 1, 20, 227, 227, 64, torch.bfloat16)
    out = torch.full((1, 20, 227, 64), float("nan"), device=dev,
                     dtype=torch.bfloat16)
    assert _flash_call(q, k, v, out, 227, 1, 64, splits) == 0
    ref = fa.plain_flash_mha(q.float(), k.float(), v.float(), causal=True,
                             scale=0.125)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2


def test_flash_kernel_refuses_a_plan_it_does_not_take(dev):
    """The causal plan is the wrapper's: the bf16 entry refuses rows other
    than 64, splits outside 1-4, and any plan for a call that is not
    causal, before any launch."""
    q, k, v = (torch.zeros(1, 2, 128, 64, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    out = torch.zeros_like(q)
    for causal, rows, splits in ((1, 32, 2), (1, 128, 2), (1, 64, 0),
                                 (1, 64, 5), (0, 64, 2), (1, 0, 0)):
        assert _flash_call(q, k, v, out, 128, causal, rows, splits) != 0
    good = fa.causal_plan(128, 128, 128, 2)
    assert _flash_call(q, k, v, out, 128, 1, good["rows"],
                       good["splits"]) == 0
    assert _flash_call(q, k, v, out, 128, 0, 0, 0) == 0


def _flash_call(q, k, v, out, valid, causal, rows, splits):
    """kernel 2's bf16 C entry with the given plan; its return code"""
    B, H, Lq, D = q.shape
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    return _build.load("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Lq,
        k.shape[2], D, valid, causal, rows, splits,
        ctypes.cast(strides, ctypes.c_void_p), 0.125,
        torch.cuda.current_stream().cuda_stream)


def test_flash_dispatch_keeps_the_plain_version(dev):
    """Below MIN_FLASH_LEN query rows, at head dims other than 64 and for
    causal calls with more rows than keys the built-in dispatch takes the
    plain version, by its static shape test."""
    g = torch.Generator(device=dev).manual_seed(4)
    for lq, lk, d in ((100, 100, 64), (256, 256, 128), (256, 200, 64)):
        q, k, v = _qkv(g, dev, 1, 2, lq, lk, d, torch.bfloat16)
        before = dict(fa.launches)
        out = fa.flash_mha(q, k, v, causal=True)
        assert fa.launches == before
        # rows with no key (Lq > Lk, causal_bias's mask) are NaN in both
        torch.testing.assert_close(
            out, fa.plain_flash_mha(q, k, v, causal=True), rtol=0, atol=0,
            equal_nan=True)


@pytest.mark.parametrize("valid", [None, 200], ids=["one_shot", "pad_once"])
def test_flash_refuses_other_head_dims_when_not_causal(dev, valid):
    """A non-causal call of 128 rows or more at head dim 128 takes the JAX
    package's TPU kernel; the port lacks that mode, so the dispatch raises
    rather than hide it behind the plain version."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = _qkv(g, dev, 1, 2, 256, 256, 128, torch.bfloat16)
    before = dict(fa.launches)
    with pytest.raises(NotImplementedError):
        fa.flash_mha(q, k, v, kv_valid_len=valid)
    assert fa.launches == before


@pytest.mark.parametrize("case", [
    "full_f32", "causal_f32", "valid_bf16", "prefill_lq3_bf16",
    "top_left_f32", "no_live_key_f32", "valid_past_lk_bf16", "encoder_f32"])
def test_custom_fmha_matches_plain(dev, case):
    b, h, lq, lk, causal, valid, dtype = {
        "full_f32": (2, 4, 256, 256, False, None, torch.float32),
        "causal_f32": (2, 4, 256, 256, True, None, torch.float32),
        "valid_bf16": (1, 3, 256, 256, False, 200, torch.bfloat16),
        "prefill_lq3_bf16": (1, 20, 3, 3, True, None, torch.bfloat16),
        "top_left_f32": (1, 2, 128, 256, True, None, torch.float32),
        "no_live_key_f32": (1, 2, 128, 128, False, 0, torch.float32),
        "valid_past_lk_bf16": (1, 2, 128, 128, True, 300, torch.bfloat16),
        "encoder_f32": (1, 20, 1536, 1536, False, 1500, torch.float32),
    }[case]
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _qkv(g, dev, b, h, lq, lk, 64, dtype)
    entry = "custom_fmha_f32" if dtype == torch.float32 else "custom_fmha"
    before = dict(ck.launches)
    out = ck.custom_flash_mha(q, k, v, causal=causal, scale=0.125,
                              kv_valid_len=valid)
    assert ck.launches[entry] == before[entry] + 1 and out.dtype == dtype
    ref = ck.plain_custom_flash_mha(q.float(), k.float(), v.float(),
                                    causal=causal, scale=0.125,
                                    kv_valid_len=valid)
    torch.cuda.synchronize()
    if valid == 0:
        assert not out.any()
    else:
        assert _rel(out, ref) < (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq", [1, 2, 3, 15, 16, 17, 33, 64, 65, 256])
def test_custom_fmha_bf16_variants(dev, lq, causal):
    """The bf16 entry's short (Lq <= 64: one block of ceil(Lq / 16) warps)
    and tiled (64 rows a block) variants at their edges, Lq == Lk, against
    the fp32 plain version (1e-2); the variant is the planner's."""
    g = torch.Generator(device=dev).manual_seed(lq)
    q, k, v = _qkv(g, dev, 1, 3, lq, lq, 64, torch.bfloat16)
    before = dict(ck.launches)
    out = ck.custom_flash_mha(q, k, v, causal=causal, scale=0.125)
    assert ck.launches["custom_fmha"] == before["custom_fmha"] + 1
    ref = ck.plain_custom_flash_mha(q.float(), k.float(), v.float(),
                                    causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert _rel(out, ref) < 1e-2
    assert ck.fmha_plan(lq, torch.bfloat16)["variant"] == (
        "short" if lq <= 64 else "tiled")


@pytest.mark.parametrize("b,h,lq,lk,causal,valid", [
    (1, 3, 17, 64, False, 40),          # valid keys inside the keys
    (1, 3, 33, 100, True, 70),          # top-left, Lq < Lk, short
    (2, 2, 16, 256, False, None),       # short over four key tiles
    (1, 2, 65, 256, True, None),        # top-left, Lq < Lk, tiled
    (1, 20, 1536, 1536, False, 1500),   # the encoder's shape, tiled
    (1, 2, 3, 3, False, 0),             # no live key: zeros
    (1, 2, 65, 65, False, 0),
])
def test_custom_fmha_bf16_masks(dev, b, h, lq, lk, causal, valid):
    """The bf16 entry's masks in both variants: ``kv_valid_len`` inside the
    keys, the top-left causal mask at Lq != Lk (it differs from the
    bottom-right one there), and rows with no live key, which are 0."""
    g = torch.Generator(device=dev).manual_seed(lq + lk)
    q, k, v = _qkv(g, dev, b, h, lq, lk, 64, torch.bfloat16)
    out = ck.custom_flash_mha(q, k, v, causal=causal, scale=0.125,
                              kv_valid_len=valid)
    ref = ck.plain_custom_flash_mha(q.float(), k.float(), v.float(),
                                    causal=causal, scale=0.125,
                                    kv_valid_len=valid)
    torch.cuda.synchronize()
    if valid == 0:
        assert not out.any()
        return
    assert _rel(out, ref) < 1e-2
    if causal and lq != lk:
        br = fa.plain_flash_mha(q.float(), k.float(), v.float(),
                                causal=True, scale=0.125)
        assert _rel(out, br) > 1e-1


def test_custom_fmha_unaligned_views_raise(dev):
    """The bf16 kernel copies rows 16 bytes at a time: a view whose pointer
    or row stride is not a multiple of 16 bytes raises ValueError before
    any launch; the fp32 entry, on the CUDA cores, still takes it."""
    x = torch.randn(1, 2, 16, 72, device=dev)
    before = dict(ck.launches)
    off = x.bfloat16()[..., 1:65]                  # pointer off by 2 bytes
    with pytest.raises(ValueError):
        ck.custom_flash_mha(off, off, off)
    rows = torch.randn(1, 2, 16, 68, device=dev).bfloat16()[..., :64]
    with pytest.raises(ValueError):                # row stride 136 bytes
        ck.custom_flash_mha(rows, rows, rows)
    assert ck.launches == before
    f = x[..., 1:65]
    ck.custom_flash_mha(f, f, f)
    assert ck.launches["custom_fmha_f32"] == before["custom_fmha_f32"] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_custom_fmha_refuses_a_plan_it_does_not_take(dev, dtype):
    """The plan is the wrapper's; each entry refuses warps it has no kernel
    for and row blocks that miss a row or hold none, before any launch."""
    lq, h = 100, 2
    t = [torch.zeros(1, h, lq, 64, device=dev, dtype=dtype)
         for _ in range(4)]
    strides = (ctypes.c_longlong * 12)(*[s for x in t for s in x.stride()[:3]])
    lib = _build.load("custom_fmha")
    entry = lib.custom_fmha_f32 if dtype == torch.float32 else lib.custom_fmha
    good = ck.fmha_plan(lq, dtype)
    bad = [(5, 1), (good["warps"], good["row_blocks"] - 1),
           (good["warps"], good["row_blocks"] + 1),
           (good["warps"] - 1, good["row_blocks"])]
    for warps, blocks in bad + [(good["warps"], good["row_blocks"])]:
        rc = entry(*[x.data_ptr() for x in t], 1, h, lq, lq, 64, lq, 0,
                   warps, blocks, ctypes.cast(strides, ctypes.c_void_p),
                   0.125, torch.cuda.current_stream().cuda_stream)
        assert (rc == 0) == ((warps, blocks) == (good["warps"],
                                                 good["row_blocks"]))


@pytest.mark.parametrize("b,h,lq,lk,causal,valid,offset", [
    (1, 20, 256, 256, False, 200, 0),   # valid cuts a 64-key tile
    (1, 20, 256, 256, True, None, 0),
    (1, 20, 1, 1, False, None, 0),
    (1, 20, 17, 17, True, None, 0),
    (1, 3, 17, 100, True, 70, 0),       # top-left, Lq < Lk, short plan
    (1, 20, 1536, 1536, False, 1500, 1),   # rows on 4 bytes, not 16
    (2, 3, 256, 256, True, 180, 1),
])
def test_custom_fmha_f32_edges(dev, b, h, lq, lk, causal, valid, offset):
    """The fp32 entry (3xTF32) at its edges, on views of a fused buffer,
    ``offset`` floats into each row (offset 1: every row starts on 4 bytes
    but not on 16, and the kernel copies 4 bytes at a time): one launch,
    within 1e-5 of the largest output of the fp32 plain version."""
    g = torch.Generator(device=dev).manual_seed(lq + lk + offset)
    x = torch.randn(b, max(lq, lk), 3, h, 64 + offset, generator=g,
                    device=dev)[..., offset:]
    q, k, v = (x[:, :n, i].transpose(1, 2)
               for i, n in enumerate((lq, lk, lk)))
    assert offset == 0 or q.data_ptr() % 16
    before = ck.launches["custom_fmha_f32"]
    out = ck.custom_flash_mha(q, k, v, causal=causal, scale=0.125,
                              kv_valid_len=valid)
    assert ck.launches["custom_fmha_f32"] == before + 1
    ref = ck.plain_custom_flash_mha(q, k, v, causal=causal, scale=0.125,
                                    kv_valid_len=valid)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-5


def test_custom_fmha_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 2, 128, 64, device=dev)
    with pytest.raises(NotImplementedError):      # head dim 64 only
        ck.custom_flash_mha(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(TypeError):                # one dtype for q, k, v
        ck.custom_flash_mha(q, q.bfloat16(), q)
    with pytest.raises(ValueError):               # blocks divide the lengths
        ck.custom_flash_mha(q, q, q, block_n=96)


def test_hook_takes_every_call_on_the_card(dev):
    """With the user kernel installed, flash_mha launches it (and copies its
    result into ``out``), never the built-in kernel; removed, the built-in
    kernel launches again."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = _qkv(g, dev, 1, 4, 256, 256, 64, torch.bfloat16)
    buf = torch.empty(1, 256, 4, 64, dtype=torch.bfloat16, device=dev)
    fa.reset_launches()
    ck.reset_launches()
    fa.set_custom_mha(ck.custom_flash_mha)
    try:
        fa.flash_mha(q, k, v, kv_valid_len=200, out=buf.transpose(1, 2))
        fa.flash_mha(q, k, v, causal=True)
    finally:
        fa.set_custom_mha(None)
    assert ck.launches["custom_fmha"] == 2
    assert fa.launches["custom_mha"] == 2
    assert fa.launches["flash_attention"] == 0
    assert fa.launches["flash_attention_causal"] == 0
    ref = ck.custom_flash_mha(q, k, v, kv_valid_len=200)
    assert torch.equal(buf.transpose(1, 2), ref)
    fa.flash_mha(q, k, v, kv_valid_len=200)
    assert fa.launches["flash_attention"] == 1


# -- the megakernel probes (tools/megakernel_probes.cu) ---------------------

def _probe_data(dev, p, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    blob = torch.randint(-127, 128, (p, mp.K, mp.N), generator=g, device=dev,
                         dtype=torch.int8)
    x = (torch.randn((1, mp.K), generator=g, device=dev) * 0.1).bfloat16()
    scales = torch.rand((p, 1, mp.N), generator=g, device=dev) * 0.01
    return g, blob, x, scales


# (cols, ksplit, blocks): the default plan, the megakernel's first GEMV
# item, on a block per item and on a grid of 132 blocks, and a split wide
# item
PROBE_ITEMS = {"plan": (None, None, 0), "megakernel": (32, 4, 0),
               "megakernel_grid": (32, 4, 132), "wide_split": (256, 2, 0)}


@pytest.mark.parametrize("item", sorted(PROBE_ITEMS))
@pytest.mark.parametrize("p", [1, 128])
def test_probe_flat_matches_plain(dev, p, item):
    _, blob, x, scales = _probe_data(dev, p, 20)
    cols, ksplit, blocks = PROBE_ITEMS[item]
    before = mp.launches["probe_flat_gemv"]
    out = mp.probe_flat(blob, x, scales, cols=cols, ksplit=ksplit,
                        blocks=blocks)
    assert mp.launches["probe_flat_gemv"] == before + 1
    ref = mp.plain_probe_flat(blob, x, scales)
    assert out.shape == (p, 1, mp.N) and out.dtype == torch.bfloat16
    assert mp.within(out, ref)
    assert mp.within(out, mp.torch_baseline_flat(blob, x, scales))


@pytest.mark.parametrize("rows,np_", [(60, 42), (20, 128), (20, 1)])
def test_probe_hm_matches_plain(dev, rows, np_):
    g = torch.Generator(device=dev).manual_seed(21)
    blob = torch.randint(-127, 128, (np_, rows, mp.K, mp.D), generator=g,
                         device=dev, dtype=torch.int8)
    xb = (torch.randn((rows, 1, mp.K), generator=g, device=dev) * 0.1
          ).bfloat16()
    s = torch.rand((np_, rows, mp.D), generator=g, device=dev)
    out = mp.probe_hm(blob, xb, s)
    assert out.shape == (np_, rows, mp.D)
    assert mp.within(out, mp.plain_probe_hm(blob, xb, s))


@pytest.mark.parametrize("mode", ["none", "reshape"])
@pytest.mark.parametrize("p", [1, 128])
def test_probe_relayout_matches_plain(dev, p, mode):
    g, blob, x, _ = _probe_data(dev, p, 22)
    kv = (torch.randn((1, mp.H, mp.D, mp.KV_COLS), generator=g, device=dev)
          * 0.1).bfloat16()
    # one panel splits K (item_plan), 128 panels take the whole of K
    out = mp.probe_relayout(blob, x, kv, mode)
    ref = mp.plain_probe_relayout(blob, x, kv, mode)
    assert mp.within(out, ref, 1e-2 if mode == "reshape" else 2 ** -7)
    if mode == "reshape":       # one total a panel, in every column
        assert bool((out == out[:, :, :1]).all())


@pytest.mark.parametrize("mode", ["pair_loop", "flat_f32", "flat_bf16",
                                  "gemv"])
@pytest.mark.parametrize("p", [1, 128])
def test_probe_pair_proj_matches_plain(dev, p, mode):
    g, blob, _, _ = _probe_data(dev, p, 23)
    ctx = torch.randn((mp.HP, mp.DL), generator=g, device=dev) * 0.1
    out = mp.probe_pair_proj(blob, ctx, mode)
    assert out.shape == (p, 1, mp.N)
    assert mp.within(out, mp.plain_probe_pair_proj(blob, ctx, mode))


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    _, blob, x, scales = _probe_data(dev, 2, 24)
    before = dict(mp.launches)
    with pytest.raises(ValueError):                 # K not a multiple of 16
        mp.probe_flat(blob[:, :1272], x[:, :1272], scales)
    with pytest.raises(ValueError):                 # rows x 64 off the panel
        mp.probe_hm(blob.reshape(2, 20, 1280, 64), x[None].expand(
            60, 1, 1280), torch.rand(2, 20, 64, device=dev))
    with pytest.raises(ValueError):                 # ctx off the panel
        mp.probe_pair_proj(blob, torch.randn(10, 64, device=dev),
                           "pair_loop")
    assert mp.launches == before


def test_probe_launch_failure_raises(dev, monkeypatch):
    """A refused launch raises and is not answered by the plain version."""
    _, blob, x, scales = _probe_data(dev, 2, 25)
    lib = mp._build.load("megakernel_probes")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((2, 1, mp.N), dtype=torch.bfloat16, device=dev)
    # the C entry refuses items of 48 columns itself
    assert lib.probe_flat(x.data_ptr(), blob.data_ptr(), scales.data_ptr(),
                          out.data_ptr(), 2, mp.K, mp.N, 48, 1, 0, None,
                          None, stream) != 0

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1              # cudaErrorInvalidValue

    monkeypatch.setattr(mp._build, "load", lambda name: Refusing())
    before = mp.launches["probe_flat_gemv"]
    with pytest.raises(RuntimeError):
        mp.probe_flat(blob, x, scales)
    assert mp.launches["probe_flat_gemv"] == before


@pytest.fixture(scope="module")
def whisper_2_layers():
    """large-v2's widths cut to 2+2 layers, the bench recipe, seeded random
    weights (``chip_smoke.build_whisper``); None without a card."""
    if not torch.cuda.is_available():
        return None, None
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        BENCH_RECIPE, whisper_config)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(whisper_config("large-v2", dtype="bfloat16"),
                              n_audio_layer=2, n_text_layer=2)
    return smoke, smoke.build_whisper(torch, np, cfg, torch.device("cuda"),
                                      BENCH_RECIPE, "card")


@pytest.mark.parametrize("best_of", [None, 3])
def test_whisper_sampling_repeats_with_a_seed(dev, whisper_2_layers,
                                              best_of):
    """Sampling draws its noise from a generator on the card seeded by
    ``seed``: the same seed samples the same tokens (at batch 1 through
    the megakernel, with best_of layer by layer), another seed others."""
    smoke, built = whisper_2_layers
    pipe = smoke.whisper_pipeline(built, None, sample_len=12,
                                  temperature=1.0, best_of=best_of)
    assert (pipe._megakernel_blobs(pipe.n_group) is None) == bool(best_of)
    runs = [pipe.transcribe(built["mel"], seed=s)[0].tokens
            for s in (7, 7, 8)]
    assert len(runs[0]) == 12
    assert runs[0] == runs[1] and runs[0] != runs[2]


# -- the paged kernel's window entry and the dense serving tick --------------

@pytest.mark.parametrize("shape", ["serve", "mqa", "gqa"])
@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.bfloat16])
def test_paged_window_kernel_matches_plain(dev, pool_dtype, shape):
    """The window entry (mixed admission) at the serve shape (16 KV heads
    of 64, T 32), MQA (one KV head under 16 query heads of 128: 16 tiles
    of query rows) and GQA (4 KV heads x 4, T 16), windows of 16 over a
    table of 9 blocks: prompt chunks at offsets 0, 16, 37 and 45, decode
    windows (one real token at seq - 1), a chunk at 270 (keys in rounds
    over every warp) and a row of seq 0.  Live rows within the gates of
    the other kernels; the dead row is zeros; one launch a call."""
    hkv, rep, D, T = {"serve": (16, 1, 64, 32), "mqa": (1, 16, 128, 32),
                      "gqa": (4, 4, 64, 16)}[shape]
    g = torch.Generator(device=dev).manual_seed(21)
    off = [0, 16, 37, 45, 60, 79, 0, 270]
    seq = [16, 32, 53, 60, 61, 80, 0, 286]
    W, MB = 16, -(-max(seq) // T)
    pool, _, table, seq_t, kw = _paged_inputs(g, dev, hkv, rep, D, T,
                                              [MB * T] * len(seq),
                                              pool_dtype, N=160)
    table[seq.index(0)] = -1
    q = torch.randn(len(seq), hkv * rep, W, D, generator=g,
                    device=dev).bfloat16()
    seq_t = torch.tensor(seq, dtype=torch.int32, device=dev)
    off_t = torch.tensor(off, dtype=torch.int32, device=dev)
    before = da.launches["paged_window_attention"]
    out = da.fused_paged_window_attention(pool, 1, q, table, seq_t, off_t,
                                          0.125, **kw)
    assert da.launches["paged_window_attention"] == before + 1
    f32 = (lambda t: t) if pool_dtype == torch.int8 else (lambda t: t.float())
    ref = da.plain_paged_window_attention(f32(pool), 1, q.float(), table,
                                          seq_t, off_t, 0.125, **kw)
    ref16 = da.plain_paged_window_attention(pool, 1, q, table, seq_t, off_t,
                                            0.125, **kw)
    torch.cuda.synchronize()
    live = seq_t > 0
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert bool((out[~live] == 0).all())
    assert _rel(out[live], ref[live]) < 1e-2
    assert _rel(out[live], ref16[live]) < 2e-2


def test_dense_serving_tick_on_the_card(dev):
    """The dense slot cache on the card: 6 requests of 20 prompt tokens
    (bucket 32) through 4 slots of a 2-layer bf16 model with heads of 64,
    6 new tokens each.  Every admission's prefill takes kernel 2's causal
    mode once a layer, every decode step kernel 1 once a layer, no other
    attention kernel; the recorded calls replayed on a fresh cache give
    the plain versions' logits (rel 5e-2, as chip_smoke's serve paths)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
        DecoderConfig, DecoderLMHead)
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        ContinuousBatchingManager, InferenceRequest, SamplingConfig)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.manual_seed(3)
    with torch.device(dev):
        model = DecoderLMHead(DecoderConfig(
            vocab_size=97, hidden_size=256, num_layers=2, num_heads=4,
            max_position_embeddings=64))
        for p in model.parameters():
            p.normal_(0, 0.05)
    rs = np.random.RandomState(0)
    queue = [InferenceRequest(i, rs.randint(0, 97, 20).astype(np.int32),
                              max_new_tokens=6, end_id=-1) for i in range(6)]
    done, calls = {}, []
    mgr = ContinuousBatchingManager(
        model, SamplingConfig(end_id=-1, pad_id=0), max_batch_size=4,
        max_seq_len=64,
        get_inference_requests=lambda n: [queue.pop(0) for _ in range(
            min(n, len(queue)))],
        send_response=lambda r: done.__setitem__(r.request_id, r.output_ids)
        if r.finished else None)

    def record(mod, args):
        cache = args[1]
        slot = None if cache.shape == mgr.cache.shape else (
            cache.data_ptr() - mgr.cache.data_ptr()) // (
            cache.stride(1) * cache.element_size())
        calls.append((args[0].clone(), slot, args[2] if isinstance(
            args[2], int) else args[2].clone(), args[3].clone()))
    hook = model.register_forward_pre_hook(record)
    for m in (da, fa):
        m.reset_launches()
    try:
        mgr.run()
    finally:
        hook.remove()
    torch.cuda.synchronize()
    assert sorted(done) == list(range(6))
    assert all(len(t) == 6 and all(0 <= x < 97 for x in t)
               for t in done.values())
    n = {k: v for m in (da, fa) for k, v in m.launches.items() if v}
    assert n == {"decode_attention_bf16": 2 * mgr.decode_steps,
                 "flash_attention_causal": 2 * mgr.prefills}
    assert mgr.prefills == 6

    def replay(plain):
        fresh = torch.zeros_like(mgr.cache)
        ctx = smoke.plain_kernels() if plain else contextlib.nullcontext()
        out = []
        with ctx, torch.inference_mode():
            for tok, slot, widx, seq in calls[:10]:
                cache = fresh if slot is None else fresh[:, slot:slot + 1]
                lg, _ = model(tok, cache, widx, seq)
                out.append(smoke.live_logits(torch, lg, widx, seq))
        return torch.cat(out)
    lk, lp = replay(False), replay(True)
    assert _rel(lk, lp) < 5e-2
