"""The port's serving modes against the JAX package on the CPU: the dense
slot cache, ``steps_per_tick``, mixed context+generation admission (dense
and paged), GLM's context lengths, the window writes and attention, and the
native runtime.  Inputs come from numpy seeds (and one seeded HF GPT-2) and
go to both sides; tokens are compared exactly.

* (a) ``ContinuousBatchingManager`` token-exact with the JAX manager: the
  dense slot cache (``tests/test_batch_manager.py``'s prompts), dense ==
  paged with a tight pool that cycles, ``steps_per_tick`` 1, 2 and 4 with
  slots that finish mid-tick, mixed admission at chunk 16 with a prompt of
  three chunks admitted mid-flight (dense and paged), GLM's
  ``context_lengths`` on the dense path;
* (b) the reference's dense mixed window clamped at the end of the cache:
  the JAX dense mixed manager differs from its plain manager there, the
  port's equals the plain one (paged: all three equal);
* (c) the writes: ``paged_append_window`` bit-equal to JAX's (pad lanes
  and dropped lanes), the stacked cache's per-row columns
  (``write_fresh_kv``, ``append_kv_stacked``) bit-equal to JAX's where
  JAX's window fits, and only the lanes inside the cache written where it
  does not;
* (d) the plain window attention (``paged_decode_attention`` with
  ``causal_offset``, the window entry's plain version) against JAX's, fp32,
  2e-5;
* (e) the port's native scheduler and KV manager against the JAX
  package's native library and the Python ones on random traces;
* (f) a CPU rehearsal of ``chip_smoke.py``'s serve_modes path."""
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.ops import attention as pat
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops import paged_attention as ppa
from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, InferenceRequest, SamplingConfig)
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

END = 210               # the sharp model's end and pad id (never emitted)


@pytest.fixture(autouse=True)
def one_thread(one_cpu_thread):  # noqa: F811
    """Every test here runs tiny models: one torch thread a worker, so
    that the suite's parallel workers do not oversubscribe the cores."""
    yield


@pytest.fixture(scope="module")
def sharp():
    """(JAX model, port model) of ``tests/test_batch_manager.py``'s sharp
    GPT-2 (vocab 211, 3 layers of width 48, 4 heads, init 0.25), fp32."""
    import transformers as T

    from eddie_wang_hackathon2023_tpu.models.families import \
        build_from_hf as j_build
    from eddie_wang_hackathon2023_tpu_torch.models.families import \
        build_from_hf
    torch.manual_seed(7)
    cfg = T.GPT2Config(vocab_size=211, n_positions=128, n_embd=48, n_layer=3,
                       n_head=4, initializer_range=0.25)
    hf = T.GPT2LMHeadModel(cfg).eval()
    jm, _ = j_build("gpt2", hf, dtype="float32")
    pm, _ = build_from_hf("gpt2", hf, dtype="float32", device="cpu")
    return jm, pm


def serve(side, model, prompts, new=10, end_id=END, pad_id=END,
          extra=None, **kw):
    """{request id: output tokens} of one drain through the JAX manager
    (``side='jax'``) or the port's, the requests released one a poll.
    ``new``: the new tokens of every request, or one a request."""
    if side == "jax":
        from eddie_wang_hackathon2023_tpu.runtime.batch_manager import (
            ContinuousBatchingManager as Manager, InferenceRequest as Req)
        from eddie_wang_hackathon2023_tpu.runtime.sampling import \
            SamplingConfig as Sampling
    else:
        Manager, Req, Sampling = (ContinuousBatchingManager,
                                  InferenceRequest, SamplingConfig)
        kw["device"] = "cpu"
    news = new if isinstance(new, (list, tuple)) else [new] * len(prompts)
    queue = [Req(i, np.asarray(p, np.int32), max_new_tokens=n, end_id=end_id)
             for i, (p, n) in enumerate(zip(prompts, news))]
    results = {}

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]
    mgr = Manager(model, Sampling(end_id=end_id, pad_id=pad_id),
                  get_inference_requests=lambda n: [queue.pop(0)] if queue
                  else [], send_response=send, **kw)
    if extra:
        extra(mgr)
    mgr.run()
    return results


PROMPTS = [[5, 11, 17, 23, 31], [40, 2], [7, 8, 9, 10, 11, 12, 13], [3]]


# -- (a) the serving modes, token-exact ---------------------------------------

def test_dense_slot_cache_token_exact_with_jax(sharp):
    """``tests/test_batch_manager.py``'s four prompts through 2 slots of
    the dense slot cache, 10 new tokens: the port's tokens equal the JAX
    manager's, and the port's paged manager's."""
    jm, pm = sharp
    want = serve("jax", jm, PROMPTS, max_batch_size=2, max_seq_len=64)
    got = serve("port", pm, PROMPTS, max_batch_size=2, max_seq_len=64)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert serve("port", pm, PROMPTS, max_batch_size=2, max_seq_len=64,
                 paged=True, tokens_per_block=8) == want


def test_dense_equals_paged_and_a_tight_pool_cycles(sharp):
    """Six prompts through 3 slots, 12 new tokens: JAX dense == port dense
    == port paged == port paged over a pool of 24 blocks of 8 (freed blocks
    reused)."""
    jm, pm = sharp
    prompts = PROMPTS + [[9, 9, 9], [100, 101]]
    kw = dict(max_batch_size=3, max_seq_len=64, new=12)
    want = serve("jax", jm, prompts, **kw)
    assert serve("port", pm, prompts, **kw) == want
    assert serve("port", pm, prompts, paged=True, tokens_per_block=8,
                 **kw) == want
    assert serve("port", pm, prompts, paged=True, tokens_per_block=8,
                 num_blocks=3 * 8, **kw) == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_steps_per_tick_token_exact_with_jax(sharp, steps, paged):
    """Four prompts through 2 slots, 9 new tokens each (not a multiple of
    2 or 4: slots finish mid-tick and are admitted again while the tick's
    later tokens are discarded): the port equals the JAX manager at the
    same ``steps_per_tick``, and its own one-step ticks."""
    jm, pm = sharp
    kw = dict(max_batch_size=2, max_seq_len=64, new=9, steps_per_tick=steps)
    if paged:
        kw.update(paged=True, tokens_per_block=8)
    want = serve("jax", jm, PROMPTS, **kw)
    got = serve("port", pm, PROMPTS, **kw)
    assert got == want
    assert got == serve("port", pm, PROMPTS, **{**kw, "steps_per_tick": 1})


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_admission_token_exact_with_jax(sharp, paged):
    """``tests/test_batch_manager.py``'s mixed-admission prompts (one of
    37 tokens, three chunks at width 16, admitted while another slot
    decodes) through 2 slots: the port's mixed manager equals the JAX
    mixed manager and the port's plain one; blocks of 8 put the chunk
    edges on and off the block edges."""
    jm, pm = sharp
    prompts = [[5, 11, 17, 23, 31], list(range(3, 40)), [40, 2],
               [7, 8, 9, 10, 11, 12, 13]]
    kw = dict(max_batch_size=2, max_seq_len=64)
    if paged:
        kw.update(paged=True, tokens_per_block=8)
    mixed = dict(mixed_admission=True, chunk_width=16)
    ticks = []
    want = serve("jax", jm, prompts, **kw, **mixed)
    got = serve("port", pm, prompts, **kw, **mixed,
                extra=lambda m: ticks.append(m))
    assert got == want
    assert got == serve("port", pm, prompts, **kw)
    assert ticks[0].mixed_ticks >= 3 and ticks[0].prefills == 0


def test_glm_context_lengths_on_the_dense_cache():
    """ChatGLM-6B's positions need the true prompt lengths at every call:
    two prompts of 6 and 3 tokens (a tiny seeded THUDM-layout state, its
    bidirectional prompt) through 2 slots of the dense cache, 8 new tokens,
    token-exact with the JAX manager, which passes ``context_lengths`` the
    same way; mixed admission refuses the bidirectional prompt."""
    from test_torch_families_b import V, _glm
    _, jm, pm, _ = _glm()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V - 1, n).tolist() for n in (6, 3)]
    kw = dict(max_batch_size=2, max_seq_len=32, new=8, end_id=-1, pad_id=0)
    want = serve("jax", jm, prompts, **kw)
    assert serve("port", pm, prompts, **kw) == want
    with pytest.raises(ValueError, match="causal"):
        ContinuousBatchingManager(pm, SamplingConfig(), mixed_admission=True,
                                  device="cpu")


# -- (b) the reference fault: the dense mixed window at the cache's end -------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_window_at_the_end_of_the_cache(sharp, paged):
    """2 slots, max_seq_len 40, chunks of 16; prompts of 20, 3, 30 and 2
    tokens with 18, 2, 4 and 4 new ones.  Request 0's decode windows start
    within 16 columns of the end of the cache.  The JAX dense mixed manager
    writes them through a ``dynamic_update_slice`` that clamps the start,
    so its token and pad lanes land on earlier, real columns, and its
    tokens leave the plain manager's; the port writes only the lanes inside
    the cache and equals the JAX plain manager.  Over the pool the window's
    lanes go through the table and all three agree."""
    jm, pm = sharp
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, END, n).tolist() for n in (20, 3, 30, 2)]
    kw = dict(max_batch_size=2, max_seq_len=40, new=[18, 2, 4, 4])
    if paged:
        kw.update(paged=True, tokens_per_block=8)
    mixed = dict(mixed_admission=True, chunk_width=16)
    plain = serve("jax", jm, prompts, **kw)
    j_mixed = serve("jax", jm, prompts, **kw, **mixed)
    p_mixed = serve("port", pm, prompts, **kw, **mixed)
    assert p_mixed == plain
    assert len(plain[0]) == 18 and plain[0][:8] == j_mixed[0][:8]
    if paged:
        assert j_mixed == plain
    else:
        assert j_mixed[0] != plain[0]


# -- (c) the writes -----------------------------------------------------------

def _with_sink(pool, axis=0):
    shape = list(pool.shape)
    shape[axis] = 1
    return torch.cat([pool, torch.zeros(shape, dtype=pool.dtype)], axis)


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["pool", "stacked"])
def test_paged_append_window_bit_equal_to_jax(dtype, stacked):
    """Windows of 6 lanes at offsets that cross block edges (T 4): row 0
    inside its blocks, row 1's last lanes into a -1 table slot, row 2's
    past its table, row 3's from 0 (a prompt's first chunk): the pools are
    bit-equal to JAX's (the port's sink block aside), the dropped lanes
    written nowhere else."""
    from eddie_wang_hackathon2023_tpu.ops import paged_attention as jpa
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[dtype]
    rs = np.random.RandomState(11)
    L, N, H, T, D, B, W = 2, 12, 2, 4, 8, 4, 6
    init = rs.randn(*((L,) if stacked else ()), N, 2, H, T, D) * 3
    if dtype == "int8":
        init = np.clip(np.round(init * 5), -128, 127)
    jpool = jnp.asarray(init.astype(np.float32)).astype(jdt)
    axis = int(stacked)
    tpool = _with_sink(torch.from_numpy(init.astype(np.float32)).to(tdt),
                       axis)
    table = np.asarray([[3, 7, 1], [5, -1, -1], [0, 2, 4], [6, 8, -1]],
                       np.int32)
    pos = np.asarray([3, 2, 9, 0], np.int32)
    k, v = (rs.randn(B, H, W, D).astype(np.float32) * 2 for _ in range(2))
    kw = dict(kv_orig_quant_scale=20.0 if dtype == "int8" else None,
              layer_idx=1 if stacked else None)
    jpool = jpa.paged_append_window(jpool, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table), jnp.asarray(pos),
                                    **kw)
    out = ppa.paged_append_window(tpool, torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(table),
                                  torch.from_numpy(pos), **kw)
    assert out is tpool
    blocks = (slice(None),) * axis + (slice(N),)
    np.testing.assert_array_equal(_np32(tpool[blocks]), _np32(jpool))
    # the blocks no row names are untouched
    untouched = [b for b in range(N) if b not in table]
    np.testing.assert_array_equal(
        _np32(tpool[blocks])[(slice(None),) * axis + (untouched,)],
        _np32(torch.from_numpy(init.astype(np.float32)).to(tdt))[
            (slice(None),) * axis + (untouched,)])


def test_per_row_cache_columns_against_jax():
    """The stacked cache's per-row writes: single tokens at columns -1, 0,
    5 and S - 1 (a negative column counts from the end, as JAX's
    ``dynamic_update_slice`` takes it), windows inside the cache and a
    one-layer window append, bit-equal to JAX's; a window that runs past
    the end writes its lanes inside the cache only, where JAX's clamp
    shifts it back over earlier columns."""
    from eddie_wang_hackathon2023_tpu.ops import attention as jat
    rs = np.random.RandomState(2)
    L, B, H, D, S = 2, 4, 2, 3, 10
    cache = rs.randn(L, B, 2, H, D, S).astype(np.float32)

    def both(fn_j, fn_p, *args):
        j = np.asarray(fn_j(jnp.asarray(cache), *map(jnp.asarray, args)))
        t = torch.from_numpy(cache.copy())
        fn_p(t, *map(torch.from_numpy, args))
        return j, t.numpy()
    for n, wi in ((1, [-1, 0, 5, 9]), (3, [0, 2, 7, 5])):
        kv = rs.randn(L, B, 2, H, D, n).astype(np.float32)
        j, t = both(jat.write_fresh_kv, pat.write_fresh_kv, kv,
                    np.asarray(wi, np.int32))
        np.testing.assert_array_equal(t, j)
    k, v = (rs.randn(B, H, 4, D).astype(np.float32) for _ in range(2))
    w = np.asarray([0, 3, 6, 2], np.int32)
    j = np.asarray(jat.append_kv_stacked(jnp.asarray(cache), jnp.asarray(k),
                                         jnp.asarray(v), 1, jnp.asarray(w)))
    t = torch.from_numpy(cache.copy())
    pat.append_kv_stacked(t, torch.from_numpy(k), torch.from_numpy(v), 1,
                          torch.from_numpy(w))
    np.testing.assert_array_equal(t.numpy(), j)
    # windows of 4 from columns 8 and 9: lanes 8, 9 (and 9) inside only
    kv = rs.randn(L, B, 2, H, D, 4).astype(np.float32)
    wi = np.asarray([8, 9, 1, 0], np.int32)
    j, t = both(jat.write_fresh_kv, pat.write_fresh_kv, kv, wi)
    np.testing.assert_array_equal(t[:, 2:], j[:, 2:])
    np.testing.assert_array_equal(t[:, 0, ..., 8:], kv[:, 0, ..., :2])
    np.testing.assert_array_equal(t[:, 0, ..., :8], cache[:, 0, ..., :8])
    np.testing.assert_array_equal(t[:, 1, ..., 9:], kv[:, 1, ..., :1])
    np.testing.assert_array_equal(t[:, 1, ..., :9], cache[:, 1, ..., :9])
    assert not np.array_equal(j[:, 0, ..., :8], cache[:, 0, ..., :8])


# -- (d) the plain window attention -------------------------------------------

@pytest.mark.parametrize("pool_dtype", ["f32", "int8"])
@pytest.mark.parametrize("hkv,h", [(4, 4), (1, 4)], ids=["mha", "mqa"])
def test_plain_window_attention_matches_jax(pool_dtype, hkv, h):
    """Windows of 5 query tokens over permuted tables with -1 tails: rows
    at offsets 0 (a first chunk), 6 and 13 (chunks off the block edges of
    T 4), a decode window (one real token at seq - 1) and a row with
    seq 0; the plain window attention and the wrapper's CPU route against
    JAX's XLA formulation with ``causal_offset``, fp32 rtol/atol 2e-5 (the
    JAX XLA formulation broadcasts only one KV head, so GQA is left out)."""
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        paged_decode_attention as j_xla
    rs = np.random.RandomState(5 + hkv)
    L, T, D, NBLK, MB, W = 2, 4, 16, 24, 5, 5
    off = np.asarray([0, 6, 13, 11, 0], np.int32)
    seq = np.asarray([5, 11, 18, 12, 0], np.int32)
    B = len(seq)
    pool = rs.randn(L, NBLK, 2, hkv, T, D).astype(np.float32)
    if pool_dtype == "int8":
        pool = np.clip(np.round(pool * 20), -127, 127).astype(np.int8)
    q = rs.randn(B, h, W, D).astype(np.float32)
    perm = rs.permutation(NBLK)
    table = np.full((B, MB), -1, np.int32)
    at = 0
    for i in range(B):
        nb = -(-int(seq[i]) // T)
        table[i, :nb] = perm[at:at + nb]
        at += nb
    kscale = 0.05 if pool_dtype == "int8" else None
    scale = D ** -0.5
    for layer in range(L):
        want = j_xla(jnp.asarray(q), jnp.asarray(pool[layer]),
                     jnp.asarray(table), jnp.asarray(seq), scale=scale,
                     kv_quant_orig_scale=kscale,
                     causal_offset=jnp.asarray(off))
        args = (torch.from_numpy(pool), layer, torch.from_numpy(q),
                torch.from_numpy(table), torch.from_numpy(seq),
                torch.from_numpy(off), scale)
        got = pdec.plain_paged_window_attention(*args,
                                                kv_quant_orig_scale=kscale)
        assert got.shape == (B, h, W, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=f"layer {layer}")
        assert torch.equal(pdec.fused_paged_window_attention(
            *args, kv_quant_orig_scale=kscale), got)
    with pytest.raises(ValueError):        # a window needs its offsets
        ppa.paged_decode_attention(torch.from_numpy(q),
                                   torch.from_numpy(pool[0]),
                                   torch.from_numpy(table),
                                   torch.from_numpy(seq))


# -- (e) the native runtime ---------------------------------------------------

@pytest.mark.parametrize("beam", [1, 2])
def test_native_kv_manager_matches_jax_and_python(beam):
    """A seeded trace of add / step / stop in a pool of 256 blocks: the
    port's native KV manager, the JAX package's native one and the port's
    Python one give the same tables and free counts after every
    operation."""
    from eddie_wang_hackathon2023_tpu.native import batch_runtime as jbr
    from eddie_wang_hackathon2023_tpu_torch.native import batch_runtime as pbr
    from eddie_wang_hackathon2023_tpu_torch.runtime import kv_cache_manager
    assert pbr.available()
    rng = np.random.default_rng(beam)
    mgrs = [m.NativeKVCacheManager(2, 256, 8, 16, beam_width=beam)
            for m in (pbr, jbr)]
    py = kv_cache_manager.KVCacheManager(2, 256, 8, 16, beam)
    seqs, live, next_id = {}, [], 0
    for it in range(200):
        op = rng.random()
        if (op < 0.3 and len(live) < 6) or not live:
            clen = int(rng.integers(1, 40))
            for m in mgrs:
                m.add_sequence(next_id, clen)
            seqs[next_id] = kv_cache_manager.GenerationSequence(next_id,
                                                                next_id)
            py.add_sequence(seqs[next_id], clen)
            live.append(next_id)
            next_id += 1
        elif op < 0.45:
            sid = live.pop(int(rng.integers(len(live))))
            for m in mgrs:
                m.stop(sid)
            py.stop(seqs.pop(sid))
        else:
            fin = [bool(rng.random() < 0.15) for _ in live]
            for m in mgrs:
                m.step(fin)
            py.step(fin)
        want = py.get_block_index_arrays()
        for m in mgrs:
            np.testing.assert_array_equal(m.get_block_index_arrays(), want,
                                          err_msg=f"iter {it}")
            assert m.free_block_count == len(py.blocks_manager.free_blocks)


def test_native_scheduler_matches_jax_and_python():
    """A seeded trace of requests, admissions and tokens (end ids, budgets,
    the length limit, streaming): the port's native scheduler, the JAX
    package's native one and the port's Python one admit the same requests
    into the same slots and return the same flags and states."""
    from eddie_wang_hackathon2023_tpu.native import batch_runtime as jbr
    from eddie_wang_hackathon2023_tpu_torch.native import batch_runtime as pbr
    from eddie_wang_hackathon2023_tpu_torch.runtime.batch_manager import (
        _PyScheduler, make_scheduler)
    scheds = [pbr.NativeScheduler(4, 64, end_id=99),
              jbr.NativeScheduler(4, 64, end_id=99), _PyScheduler(4, 64, 99)]
    assert type(make_scheduler(4, 64, 99)) is pbr.NativeScheduler
    assert type(make_scheduler(4, 64, 99, native=False)) is _PyScheduler
    rng = np.random.default_rng(1)
    next_id = 0
    for it in range(300):
        if rng.random() < 0.2:
            mx = int(rng.integers(1, 10))
            eid = -1 if rng.random() < 0.5 else 99
            stream = bool(rng.random() < 0.3)
            for s in scheds:
                s.add_request(next_id, mx, eid, stream)
            next_id += 1
        while True:
            adm = {s.next_admission() for s in scheds}
            assert len(adm) == 1, it
            slot, _ = adm.pop()
            if slot < 0:
                break
            plen, tok = int(rng.integers(1, 20)), int(rng.integers(0, 101))
            for s in scheds:
                s.on_admitted(slot, plen)
            assert len({s.push_token(slot, tok) for s in scheds}) == 1
        states = [s.state() for s in scheds]
        active = states[0][0]
        for st in states[1:]:
            np.testing.assert_array_equal(st[0], active)
            for a, b in zip(st[1:], states[0][1:]):
                np.testing.assert_array_equal(a[active], b[active])
        assert len({(s.num_pending, s.num_active) for s in scheds}) == 1
        for slot in np.flatnonzero(active):
            tok = int(rng.integers(0, 101))
            assert len({s.push_token(int(slot), tok) for s in scheds}) == 1


def test_native_scheduler_is_asked_for_and_used(sharp):
    """``native_scheduler=True`` takes the native library (it builds
    here); the manager serves the same tokens with either scheduler."""
    from eddie_wang_hackathon2023_tpu_torch.native import batch_runtime
    _, pm = sharp
    mgrs = []
    a = serve("port", pm, PROMPTS, max_batch_size=2, max_seq_len=64,
              native_scheduler=True, extra=mgrs.append)
    b = serve("port", pm, PROMPTS, max_batch_size=2, max_seq_len=64,
              native_scheduler=False, extra=mgrs.append)
    assert a == b
    assert isinstance(mgrs[0].sched, batch_runtime.NativeScheduler)
    assert not isinstance(mgrs[1].sched, batch_runtime.NativeScheduler)


# -- (f) chip_smoke.py's serve_modes path, rehearsed --------------------------

def test_chip_smoke_serve_modes_path_on_cpu(one_cpu_thread):
    """The serve_modes path of ``chip_smoke.py`` at 2 layers of width 64
    (heads of 16, vocab 97): every cell serves the 64 requests with 20
    tokens, the teacher-forced replays are exact (on the CPU both sides
    are the plain versions), the sampled cells' two drains agree, no
    kernel is launched from CPU tensors, and a greedy cell's tokens are
    compared with the reference given."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = dataclasses.replace(smoke.gpt_350m_config(), vocab_size=97,
                                 hidden_size=64, num_layers=2, num_heads=4,
                                 num_kv_heads=4)
    reference = serve("port", _tiny_model(smoke, config),
                      smoke.serve_prompts(np, config), new=20, end_id=-1,
                      pad_id=0, max_batch_size=8, max_seq_len=128,
                      paged=True, tokens_per_block=32)
    e2e, counts = smoke.serve_modes_path(torch, np, config=config,
                                         device="cpu", reference=reference)
    assert set(e2e) == set(smoke.SERVE_MODES)
    assert set(counts) == {"serve_" + c for c in smoke.SERVE_MODES}
    assert all(not any(n.values()) for n in counts.values())
    for cell, e in e2e.items():
        assert e["requests"] == 64 and e["total_new_tokens"] == 64 * 20
        assert e["logits_rel_err"] == 0.0 and e["req_per_s"] > 0
    assert e2e["dense"]["tokens_equal_to_paged_greedy"] == 1.0
    assert e2e["paged_mixed"]["mixed_ticks"] == 8 * 4
    assert e2e["paged_spt4"]["decode_steps"] == 4 * e2e[
        "paged_spt4"]["decode_ticks"]
    assert e2e["dense"]["prefills"] == 64


def _tiny_model(smoke, config):
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    return from_jax_state(smoke.random_decoder_state(
        torch, np, config, np.random.default_rng(smoke.SEED)), config,
        device="cpu")
