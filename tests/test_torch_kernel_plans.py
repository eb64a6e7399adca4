"""The host-side plans of two hand-written kernels of the port, and their
plain versions against the JAX package at the shapes those plans cover, on
the CPU (a few seconds).

* ``fmha_plan`` (``examples/custom_kernel_torch/fmha_cuda.py``: the warps
  and row blocks that the wrapper passes to ``fmha.cu``'s entries, which
  refuse any other): the bf16 entry's short variant (one block of
  ceil(Lq / 16) warps, Lq <= 64) and tiled variant (row blocks of 64), the
  fp32 entry's 128-row blocks, at the custom path's shapes and the
  variants' edges;
* ``gqa_splits`` and ``gqa_slice_width`` (``ops/decode_attention.py``): the
  grouped kernel's cluster over S, one block up to 128 columns, at most 8,
  and the slice width, both passed to the kernel;
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


@pytest.mark.parametrize("lq,blocks", [(1, 1), (3, 1), (128, 1), (129, 2),
                                       (1536, 12)])
def test_fmha_plan_fp32(lq, blocks):
    """The fp32 entry keeps the first design: 128 rows a block."""
    assert ck.fmha_plan(lq, torch.float32) == dict(
        variant="fp32", rows=128, warps=4, row_blocks=blocks)


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
