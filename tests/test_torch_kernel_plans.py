"""The host-side plans of two hand-written kernels of the port, and their
plain versions against the JAX package at the shapes those plans cover, on
the CPU (a few seconds).

* ``fmha_plan`` (``examples/custom_kernel_torch/fmha_cuda.py``: the warps
  and row blocks that the wrapper passes to ``fmha.cu``'s entries, which
  refuse any other): the bf16 entry's short variant (one block of
  ceil(Lq / 16) warps, Lq <= 64) and tiled variant (row blocks of 64), the
  fp32 entry's blocks of the same rows, at the custom path's shapes and
  the variants' edges;
* ``causal_plan`` (``ops/flash_attention.py``: the rows and key splits
  that the wrapper passes to kernel 2's causal entry, which refuses any
  other): 64 rows a block, the keys over up to 4 warps while the grid has
  fewer blocks than SMs;
* ``gqa_splits`` and ``gqa_slice_width`` (``ops/decode_attention.py``): the
  grouped kernel's cluster over S, one block up to 128 columns, at most 8,
  and the slice width, both passed to the kernel;
* ``gemv_plan`` (``ops/decode_attention.py``: the out-projection GEMV's
  cluster along K, rows a block and batch tile, which the C entry checks):
  every (K row, column) loaded by one thread, at B 1, 2, 5 and 8, K 64,
  1280 and 12288, N 4, 96, 1000 and 1280; 120 blocks at the path's call;
* ``plain_custom_flash_mha`` against the Pallas FMHA in interpret mode at
  the short variant's edges, Lq 1, 16 and 17, causal and not, fp32, 1e-5
  (``tests/test_torch_custom_kernel.py`` covers 3, 4, 128 and 256);
* ``plain_gqa_decode_attention`` against the JAX ``fused_decode_attention``
  (its ``_gqa_kernel`` in interpret mode, one chunk) at the decoder path's
  head layout: bf16, one KV head under 16 query heads of 128, S 84, start 4,
  sequence 70, L 1, B 2.  The two round P to bf16 at different points (the
  plain version after normalising, the kernel before), so they are held
  within one bf16 step at the largest output's magnitude
  (``tests/test_torch_decoder.py`` covers rep 4, D 16 in fp32)."""
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa

jax.config.update("jax_default_device", jax.devices("cpu")[0])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ck = _module("fmha_cuda", "examples", "custom_kernel_torch", "fmha_cuda.py")


# -- the plans -------------------------------------------------------------

@pytest.mark.parametrize("lq,variant,rows,warps,blocks", [
    (1, "short", 16, 1, 1),
    (3, "short", 16, 1, 1),            # the custom path's prompt prefill
    (16, "short", 16, 1, 1),
    (17, "short", 32, 2, 1),
    (33, "short", 48, 3, 1),
    (64, "short", 64, 4, 1),
    (65, "tiled", 64, 4, 2),
    (227, "tiled", 64, 4, 4),
    (1536, "tiled", 64, 4, 24),        # the encoder's shape
])
def test_fmha_plan_bf16(lq, variant, rows, warps, blocks):
    assert ck.fmha_plan(lq, torch.bfloat16) == dict(
        variant=variant, rows=rows, warps=warps, row_blocks=blocks)


@pytest.mark.parametrize("lq,rows,warps,blocks", [
    (1, 16, 1, 1), (3, 16, 1, 1), (17, 32, 2, 1), (64, 64, 4, 1),
    (128, 64, 4, 2), (129, 64, 4, 3),
    (1536, 64, 4, 24),                 # the encoder's shape
])
def test_fmha_plan_fp32(lq, rows, warps, blocks):
    """The fp32 entry (3xTF32) takes the bf16 entry's rows: ceil(Lq / 16)
    warps of 16 rows a block, at most 4."""
    assert ck.fmha_plan(lq, torch.float32) == dict(
        variant="fp32", rows=rows, warps=warps, row_blocks=blocks)


@pytest.mark.parametrize("lq,lk,valid,heads,splits,blocks", [
    (227, 227, 227, 20, 4, 4),         # the custom path's prompted prefill
    (128, 128, 128, 20, 2, 2),
    (129, 129, 129, 20, 3, 3),
    (256, 256, 200, 20, 4, 4),         # valid < Lk
    (200, 256, 256, 20, 4, 4),         # Lq < Lk
    (128, 128, 50, 1, 1, 2),           # every key in one tile
    (600, 700, 650, 2, 4, 10),         # tiles past 4 come in rounds
    (1024, 1024, 1024, 20, 1, 16),     # the grid fills the card
    (227, 227, 227, 100, 1, 4),        # beam 5
    (256, 256, 256, 160, 1, 4),        # B * H past the SMs
])
def test_causal_plan(lq, lk, valid, heads, splits, blocks):
    """Kernel 2's causal plan (``ops/flash_attention.causal_plan``): 64
    rows a block; the keys of a 16-row group over ceil(keys / 64) warps, at
    most 4, while the grid has fewer blocks than the 132 SMs, else one."""
    assert fa.causal_plan(lq, lk, valid, heads) == dict(
        rows=64, splits=splits, row_blocks=blocks)
    assert fa.causal_plan(lq, lk, valid, heads, sms=10 ** 6)["splits"] == \
        min(4, -(-min(valid, lk) // 64))


@pytest.mark.parametrize("S,splits,width", [
    (1, 1, 16), (83, 1, 96), (84, 1, 96),      # the decoder path: S 84
    (128, 1, 128), (129, 2, 80), (448, 4, 112),
    (1024, 8, 128), (1025, 8, 144), (1500, 8, 192), (2063, 8, 272),
    (40000, 8, 5008),
])
def test_gqa_splits(S, splits, width):
    """One block up to GQA_COLS columns, then a cluster of ceil(S / 128)
    blocks up to 8; slices of ceil(S / splits) rounded up to 16 cover S."""
    assert pdec.gqa_splits(S) == splits
    w = pdec.gqa_slice_width(S, splits)
    assert w == width and w % 16 == 0
    assert (splits - 1) * w < S <= splits * w


# -- the plain versions against the JAX package ------------------------------

def _gemv_cover(plan, B, K, N):
    """What the GEMV kernel does with ``plan``: the (K row, column) pairs
    that each block's threads load (rank r of the cluster rows [r * rows,
    min(K, (r + 1) * rows)); thread (warp, lane) the 16 columns 16 (lane %
    4) of its column block, rows warp * 8 + lane // 4 + 32 i of the rank's),
    counted over the column blocks, and the batch rows each batch tile
    takes."""
    cover = np.zeros((K, N), dtype=np.int32)
    lanes = np.array([w * 8 + q for w in range(4) for q in range(8)])
    for r in range(plan["cluster"]):
        lo, hi = r * plan["rows"], min(K, (r + 1) * plan["rows"])
        ks = (lo + lanes[:, None] + pdec.GEMV_ROW_LANES
              * np.arange(-(-plan["rows"] // pdec.GEMV_ROW_LANES))[None, :])
        ks = ks[ks < hi]
        for nb in range(-(-N // pdec.GEMV_COLS)):
            for c16 in range(pdec.GEMV_COLS // 16):
                cols = nb * pdec.GEMV_COLS + 16 * c16 + np.arange(16)
                cols = cols[cols < N]
                np.add.at(cover, (ks[:, None], cols[None, :]), 1)
    rows_b = [z * plan["batch"] + b for z in range(-(-B // plan["batch"]))
              for b in range(plan["batch"]) if z * plan["batch"] + b < B]
    return cover, rows_b


@pytest.mark.parametrize("B", [1, 2, 5, 8])
@pytest.mark.parametrize("K", [64, 1280, 12288])
@pytest.mark.parametrize("N", [4, 96, 1000, 1280])
def test_gemv_plan_covers_k_and_n_once(B, K, N):
    """The out-projection GEMV's plan (``ops/decode_attention.gemv_plan``):
    every (K row, column) loaded by exactly one thread of one block, every
    batch row in one batch tile, the cluster at most 8 with every rank
    given rows (cluster * rows >= K > (cluster - 1) * rows), a batch tile
    the C entry takes, and the blocks within one wave of 132 SMs."""
    plan = pdec.gemv_plan(B, K, N, 132)
    c, rows, batch = plan["cluster"], plan["rows"], plan["batch"]
    assert 1 <= c <= pdec.GEMV_MAX_CLUSTER and c * rows >= K > (c - 1) * rows
    assert batch in pdec.GEMV_BATCH and batch >= min(B, 8)
    blocks = c * -(-N // pdec.GEMV_COLS) * -(-B // batch)
    assert blocks <= 132 or c == 1
    cover, rows_b = _gemv_cover(plan, B, K, N)
    assert (cover == 1).all()
    assert rows_b == list(range(B))


def test_gemv_plan_at_the_path_shape():
    """The scanned path's call, [1,1280] x [1280,1280] on 132 SMs: 20
    column blocks x a cluster of 6 = 120 blocks (more than 100 SMs), 214
    rows of K a block (13.7 KB), so each thread's 7 rows are one round of
    16-byte loads; at batch 5 (the beam path) one tile of 8 rows."""
    assert pdec.gemv_plan(1, 1280, 1280, 132) == dict(cluster=6, rows=214,
                                                      batch=1)
    assert pdec.gemv_plan(5, 1280, 1280, 132) == dict(cluster=6, rows=214,
                                                      batch=8)
    assert -(-214 // pdec.GEMV_ROW_LANES) <= 8


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq", [1, 16, 17])
def test_plain_custom_fmha_at_the_short_edges(lq, causal):
    pallas_fmha = _module("pallas_fmha", "examples", "custom_kernel",
                          "pallas_fmha.py")
    rs = np.random.RandomState(lq + 100 * causal)
    q, k, v = (rs.randn(2, 3, lq, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(pallas_fmha.custom_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    out = ck.plain_custom_flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_gqa_decode_at_the_path_layout():
    from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import \
        fused_decode_attention as j_fused
    rs = np.random.RandomState(84)
    L, B, hkv, rep, D, S = 1, 2, 1, 16, 128, 84
    q = rs.randn(B, hkv * rep, 1, D).astype(np.float32)
    kv = rs.randn(L, B, 2, hkv, D, S).astype(np.float32)
    fresh = [rs.randn(B, hkv, D, 1).astype(np.float32) for _ in range(2)]
    seq = np.full((B,), 70, np.int32)
    start = np.full((B,), 4, np.int32)
    ref = j_fused(jnp.asarray(kv, jnp.bfloat16), 0,
                  jnp.asarray(q, jnp.bfloat16), jnp.asarray(seq), D ** -0.5,
                  fresh_kv=tuple(jnp.asarray(f, jnp.bfloat16) for f in fresh),
                  start_index=jnp.asarray(start), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))

    def bf16(x):
        return torch.from_numpy(x).bfloat16()

    out = pdec.fused_decode_attention(
        bf16(kv), 0, bf16(q), torch.from_numpy(seq), D ** -0.5,
        fresh_kv=tuple(map(bf16, fresh)), start_index=torch.from_numpy(start))
    assert out.dtype == torch.bfloat16 and out.shape == (B, rep, 1, D)
    top = float(np.abs(ref).max())
    step = 2.0 ** (math.floor(math.log2(top)) - 7)   # a bf16 step at |max|
    assert float(np.abs(out.float().numpy() - ref).max()) <= step


# -- tools/kernel_ab.py reads each checkout's plans from its files ----------

def test_kernel_ab_reads_this_checkouts_plans():
    """``defs_of`` takes the int4 plans and the megakernel's argument
    structure and plan from this checkout's files alone: they agree with
    the modules' own."""
    import ctypes
    import sys
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import kernel_ab
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    d = kernel_ab.defs_of(REPO, os.path.join(kernel_ab.OPS,
                                             "int4_quant_matmul.py"),
                          kernel_ab.INT4_PLANS)
    for m, k, n in [(8, 2048, 2304), (8, 8192, 2048), (32, 2048, 8192)]:
        assert d["decode_plan"](m, n, k, 132) == iq.decode_plan(m, n, k, 132)
    for m, k, n in [(512, 2048, 2304), (512, 2048, 8192), (40, 384, 256)]:
        assert d["prefill_plan"](m, n, k, 132) == iq.prefill_plan(
            m, n, k, 132)
    d = kernel_ab.defs_of(REPO, os.path.join(kernel_ab.OPS,
                                             "decode_attention.py"),
                          kernel_ab.DECODE_PLANS)
    for b, k, n in [(1, 1280, 1280), (5, 1280, 1280), (8, 12288, 96)]:
        assert d["gemv_plan"](b, k, n, 132) == pdec.gemv_plan(b, k, n, 132)
    d = kernel_ab.defs_of(REPO, os.path.join(kernel_ab.OPS,
                                             "decoder_layer.py"),
                          ("_MegaArgs", "megakernel_plan", "_panels",
                           "_flat_slots"))
    assert d["megakernel_plan"](1280, 4, 132) == mk.megakernel_plan(
        1280, 4, 132)
    assert [f for f, _ in d["_MegaArgs"]._fields_] == [
        f for f, _ in mk._MegaArgs._fields_]
    assert ctypes.sizeof(d["_MegaArgs"]) == ctypes.sizeof(mk._MegaArgs)
