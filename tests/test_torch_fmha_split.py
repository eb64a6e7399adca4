"""The arithmetic of the user FMHA's fp32 entry (``examples/custom_kernel_torch/
fmha.cu``, 3xTF32 on ``mma.sync.m16n8k8``), emulated on the CPU at a small
shape and held against fp64 (a few seconds).

* The kernel's tf32 rounding, ``(bits + 0x1000) & 0xffffe000``, is
  ``cvt.rna.tf32.f32`` for finite values: to nearest, ties away from zero,
  10 mantissa bits (checked against a definition by ``frexp``, at ties,
  just off them and where the rounding carries into the exponent).
* Each fp32 operand is split into two tf32 terms, hi = rna(x) and
  lo = rna(x - hi), which carry about 22 bits; the two bf16 terms of the
  split-bf16 route (kernel 2's fp32 entry) carry about 16.
* The flash algorithm as the kernel runs it: S = Q K^T and P V as the three
  products lo.hi + hi.lo + hi.hi of each mma k-step (8 for tf32, 16 for
  bf16), each mma's sum rounded once to fp32; the online softmax in fp32
  over tiles of 64 keys; each tile's P V summed in fresh accumulators and
  added to O.  3xTF32 holds the fp32 entry's gate, 1e-5 of the largest
  output, over these shapes; on peaked scores the split-bf16 route does
  not (its own gate is 1e-4).
"""
import numpy as np
import pytest
import torch

GATE = 1e-5


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """The kernel's ``rna_tf32``: fp32 -> tf32, to nearest, ties away."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def rna_by_definition(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, to nearest, ties away from zero."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def split(x: np.ndarray, kind: str):
    """The two terms of each operand: tf32 (the kernel's) or bf16."""
    if kind == "tf32":
        hi = rna_tf32(x)
        return hi, rna_tf32(x - hi)
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    hi = t.bfloat16().float()
    return hi.numpy(), (t - hi).bfloat16().float().numpy()


def mma_products(a: np.ndarray, b: np.ndarray, kind: str) -> np.ndarray:
    """a [M, K] @ b [N, K]^T as the kernel sums it: per k-step, one mma of
    each term, lo.hi, hi.lo, hi.hi in that order, each adding its exact
    products to the fp32 accumulator with one rounding."""
    step = 8 if kind == "tf32" else 16
    (ah, al), (bh, bl) = split(a, kind), split(b, kind)
    c = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], step):
        ks = slice(k0, k0 + step)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            c = (c.astype(np.float64)
                 + x[:, ks].astype(np.float64) @ y[:, ks].astype(np.float64).T
                 ).astype(np.float32)
    return c


def emulated_fmha(q, k, v, scale, kind, tile=64):
    """One head, q [Lq, D], k, v [Lk, D] fp32, no mask: the kernel's tiles,
    online softmax in fp32 in the log2 domain, P V of each tile in fresh
    accumulators."""
    lq = q.shape[0]
    m = np.full((lq, 1), -1e30, np.float32)
    l = np.zeros((lq, 1), np.float32)
    acc = np.zeros((lq, v.shape[1]), np.float32)
    scale_log2 = np.float32(scale * 1.4426950408889634)
    for n0 in range(0, k.shape[0], tile):
        s = mma_products(q, k[n0:n0 + tile], kind) * scale_log2
        mx = np.maximum(m, s.max(1, keepdims=True))
        alpha, p = np.exp2(m - mx), np.exp2(s - mx)
        l = l * alpha + p.sum(1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + mma_products(
            p, np.ascontiguousarray(v[n0:n0 + tile].T), kind)
        m = mx
    return acc / l


def reference(q, k, v, scale):
    s = q.astype(np.float64) @ k.astype(np.float64).T * scale
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def operands(lq, lk, std, seed):
    rs = np.random.RandomState(seed)
    return tuple((rs.randn(n, 64) * std).astype(np.float32)
                 for n in (lq, lk, lk))


# -- the rounding -------------------------------------------------------------

def test_rna_tf32_is_round_to_nearest_ties_away():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(20000), rs.randn(2000) * 1e30,
                        rs.randn(2000) * 1e-30]).astype(np.float32)
    np.testing.assert_array_equal(rna_tf32(x), rna_by_definition(x))
    # ties (low 13 bits exactly half) go away from zero, either sign; one
    # below goes down; a carry past the mantissa moves the exponent
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3FFFF000,
                     0x3FFFEFFF], np.uint32)
    got = rna_tf32(bits.view(np.float32)).view(np.uint32)
    np.testing.assert_array_equal(
        got, np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x40000000,
                       0x3FFFE000], np.uint32))
    np.testing.assert_array_equal(got.view(np.float32),
                                  rna_by_definition(bits.view(np.float32)))


@pytest.mark.parametrize("kind,bits", [("tf32", 22), ("bf16", 16)])
def test_split_terms_carry_their_bits(kind, bits):
    """hi + lo recovers x to about 2^-bits of it: 22 bits for the tf32
    terms, 16 for the bf16 ones (and no better)."""
    x = np.random.RandomState(1).randn(50000).astype(np.float32)
    hi, lo = split(x, kind)
    err = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    assert err.max() <= 2.0 ** -bits
    assert err.max() > 2.0 ** -(bits + 3)


# -- the emulated kernel against fp64 -----------------------------------------

@pytest.mark.parametrize("lq,lk,std,seed", [
    (64, 256, 1.0, 0), (64, 256, 3.0, 1), (48, 512, 2.0, 2),
    (16, 128, 3.0, 3)])
def test_3xtf32_holds_the_fp32_gate(lq, lk, std, seed):
    q, k, v = operands(lq, lk, std, seed)
    ref = reference(q, k, v, 0.125)
    assert rel(emulated_fmha(q, k, v, 0.125, "tf32"), ref) < GATE


def test_split_bf16_misses_the_fp32_gate():
    """On peaked scores (inputs of std 3, so scores of std 9) the same
    algorithm on two bf16 terms is past 1e-5 while 3xTF32 stays ten times
    inside it: why the fp32 entry takes tf32 terms."""
    q, k, v = operands(64, 256, 3.0, 1)
    ref = reference(q, k, v, 0.125)
    assert rel(emulated_fmha(q, k, v, 0.125, "bf16"), ref) > GATE
    assert rel(emulated_fmha(q, k, v, 0.125, "tf32"), ref) < GATE / 5
