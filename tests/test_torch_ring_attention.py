"""The port's ring attention (``ops/ring_attention.py``: the sequence split
over 4 spawned gloo ranks, the K/V shards sent round the ring) against the
JAX package's ``ring_attention`` on a 4-device mesh and against full
attention on one device, causal and not, within 2e-5 (the JAX test's
tolerance), with the JAX test's shapes and seeds.  Each rank holds S/4
rows of q, of the output and of the K/V shard it started with."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as R
from eddie_wang_hackathon2023_tpu.functional import causal_bias
from eddie_wang_hackathon2023_tpu.ops.attention import multihead_attention
from eddie_wang_hackathon2023_tpu.ops.ring_attention import \
    ring_attention as j_ring_attention
from eddie_wang_hackathon2023_tpu_torch.ops.ring_attention import \
    ring_attention
from eddie_wang_hackathon2023_tpu_torch.parallel import Group, spawn_ranks

WORLD = 4


def _qkv(seed, shape, scale):
    rs = np.random.RandomState(seed)
    return tuple((rs.randn(*shape) * scale).astype(np.float32)
                 for _ in range(3))


MATCH = _qkv(0, (2, 4, 64, 16), 0.3)          # s = 16 rows a rank
MEMORY = np.random.RandomState(1).randn(1, 2, 32, 8).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of the three runs, one spawn of WORLD ranks."""
    q, k, v = MATCH
    jobs = [("ring", dict(q=q, k=k, v=v, causal=False)),
            ("ring", dict(q=q, k=k, v=v, causal=True)),
            ("ring", dict(q=MEMORY, k=MEMORY, v=MEMORY, causal=False))]
    return spawn_ranks(R.bundle, WORLD, jobs, backend="gloo", device="cpu")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_and_full(ranks, cpu_devices, causal):
    q, k, v = MATCH
    s = q.shape[2]
    got = np.concatenate([r[int(causal)]["out"] for r in ranks], axis=2)
    mesh = Mesh(np.asarray(cpu_devices[:WORLD]), ("sp",))
    jax_ring = np.asarray(j_ring_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), mesh,
                                           causal=causal))
    full = np.asarray(multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=causal_bias(s, s) if causal else None))
    np.testing.assert_allclose(got, jax_ring, atol=2e-5)
    np.testing.assert_allclose(got, full, atol=2e-5)


def test_ring_memory_is_sharded(ranks):
    """Each rank's output and its K/V shard hold S/4 rows."""
    s = MEMORY.shape[2]
    outs = [r[2] for r in ranks]
    assert {o["out"].shape for o in outs} == {(1, 2, s // WORLD, 8)}
    assert {o["kv_rows"] for o in outs} == {s // WORLD}


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_is_full_attention(causal):
    """A group of one runs no collective: the whole sequence on one rank
    is plain attention (and the JAX ring's one-device mesh)."""
    q, k, v = MATCH
    s = q.shape[2]
    got = ring_attention(*(torch.from_numpy(t) for t in (q, k, v)), Group(),
                         causal=causal).numpy()
    full = np.asarray(multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=causal_bias(s, s) if causal else None))
    np.testing.assert_allclose(got, full, atol=2e-5)
