"""The port's paged continuous-batching serving against the JAX package on
the CPU.  Inputs come from numpy seeds and go to both sides.

* (a) the KV block manager's tables bit-equal to the JAX manager's over a
  seeded trace of add/step/stop in a pool that cycles;
* (b) ``paged_append_kv`` and ``paged_prefill`` give pools bit-equal to
  JAX's (f32, bf16 and int8 pools, tables with -1 tails; the port's pool
  holds a sink block past JAX's N), and a write through a -1 slot leaves
  the pool's last block alone;
* (c) the plain paged decode (``plain_paged_decode_attention``, what the
  wrapper runs for CPU tensors) against the Pallas ``_paged_kernel`` in
  interpret mode and the JAX XLA formulation, rtol/atol 2e-5 as
  ``tests/test_paged_attention.py`` holds them;
* (d) ``DecoderLMHead`` logits and pools after a paged prefill and three
  ticks against the JAX model, fp32, 1e-4;
* (e) serving token-exact with the JAX ``ContinuousBatchingManager(paged=
  True)`` (its XLA path and its ``_paged_kernel`` in interpret mode),
  float and woq8, MHA and MQA, staggered admission, an end id that frees
  slots mid-run, a pool that cycles;
* (f) a CPU rehearsal of ``chip_smoke.py``'s serve path at a tiny size;
* (g) what serving does not port raises (beams, fp8, paged beams,
  left-padded prompts over the pool), and the options and sampling that
  it once refused run; (h) the manager's device."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.models.decoder import (DecoderConfig,
                                                               DecoderLMHead)
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
    from_jax_state, quantize_state)
from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops import paged_attention as ppa
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, InferenceRequest, KVCacheManager,
    SamplingConfig)
from eddie_wang_hackathon2023_tpu_torch.runtime.kv_cache_manager import \
    GenerationSequence
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _with_sink(pool, axis=0):
    """A torch pool of JAX's N blocks and the port's sink block past them
    (zeros) on the block axis."""
    shape = list(pool.shape)
    shape[axis] = 1
    return torch.cat([pool, torch.zeros(shape, dtype=pool.dtype)], axis)


def _np32(x):
    """A JAX or torch array as float32 numpy (bf16 values are exact)."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


# -- (a) the KV block manager ------------------------------------------------

@pytest.mark.parametrize("beam_width", [1, 2])
def test_kv_cache_manager_tables_match_jax(beam_width):
    """A seeded random trace of add_sequence / step / stop on both managers
    with a tight pool (freed blocks are reused in another order): the block
    tables and the free lists agree after every operation."""
    from eddie_wang_hackathon2023_tpu.runtime import kv_cache_manager as jkv
    from eddie_wang_hackathon2023_tpu_torch.runtime import \
        kv_cache_manager as pkv
    rs = np.random.RandomState(beam_width)
    T, mb, nb = 4, 6, 16 * beam_width
    mgrs = [m.KVCacheManager(num_layers=2, num_blocks=nb, tokens_per_block=T,
                             max_blocks_per_seq=mb, beam_width=beam_width)
            for m in (jkv, pkv)]
    live, counter, stops = [], 0, 0
    for _ in range(300):
        op = rs.randint(3)
        # at most 3 live sequences, each taking at most beam_width blocks a
        # call: the pool never runs dry
        room = len(mgrs[1].blocks_manager.free_blocks) >= 3 * beam_width
        if op == 0 and len(live) < 3 and room:
            plen = int(rs.randint(0, 2 * T + 1))
            for m in (jkv, pkv):
                mgrs[m is pkv].add_sequence(
                    m.GenerationSequence(counter, counter % 4), plen)
            live.append(counter)
            counter += 1
        elif op == 1 and live and room:
            fin = [bool(rs.rand() < 0.3) for _ in live]
            lens = mgrs[1].lens
            if all(f or lens[i] + 1 <= mb * T for i, f in enumerate(fin)):
                for m in mgrs:
                    m.step(fin)
        elif op == 2 and live:
            k = live.pop(int(rs.randint(len(live))))
            for m in (jkv, pkv):
                mgrs[m is pkv].stop(m.GenerationSequence(k, k % 4))
            stops += 1
        a, b = (m.get_block_index_arrays() for m in mgrs)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert [x.idx for x in mgrs[0].blocks_manager.free_blocks] == \
            [x.idx for x in mgrs[1].blocks_manager.free_blocks]
    assert stops > 10 and counter > 10


# -- (b) the pool writes ------------------------------------------------------

POOL_DTYPES = {"f32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16),
               "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("stacked", [False, True], ids=["pool", "stacked"])
def test_pool_writes_bit_equal_to_jax(dtype, stacked):
    """A prompt of 11 positions written through tables with -1 tails (row 1
    owns one block, so its positions 8.. are dropped), then two appends at
    per-row positions (row 1 once into a -1 slot): the pools are bit-equal,
    int8 with round-half-away."""
    from eddie_wang_hackathon2023_tpu.ops import paged_attention as jpa
    jdt, tdt = POOL_DTYPES[dtype]
    rs = np.random.RandomState(3)
    L, N, H, T, D, B, P = 2, 7, 2, 8, 16, 2, 11
    init = rs.randn(*((L,) if stacked else ()), N, 2, H, T, D) * 4
    if dtype == "int8":
        init = np.clip(np.round(init * 5), -128, 127)
    jpool = jnp.asarray(init.astype(np.float32)).astype(jdt)
    axis = int(stacked)
    tpool = _with_sink(_t(init.astype(np.float32)).to(tdt), axis)
    blocks = (slice(None),) * axis + (slice(N),)     # the port's first N
    table = np.asarray([[4, 0, -1], [6, -1, -1]], np.int32)
    k, v = (rs.randn(B, H, P, D).astype(np.float32) * 3 for _ in range(2))
    kw = dict(kv_orig_quant_scale=20.0 if dtype == "int8" else None,
              layer_idx=1 if stacked else None)
    jpool = jpa.paged_prefill(jpool, _j(k), _j(v), _j(table), **kw)
    out = ppa.paged_prefill(tpool, _t(k), _t(v), _t(table), **kw)
    assert out is tpool
    np.testing.assert_array_equal(_np32(tpool[blocks]), _np32(jpool))
    for pos in ([11, 7], [12, 8]):
        kn, vn = (rs.randn(B, H, 1, D).astype(np.float32) for _ in range(2))
        jpool = jpa.paged_append_kv(jpool, _j(kn), _j(vn), _j(table),
                                    _j(np.asarray(pos, np.int32)), **kw)
        ppa.paged_append_kv(tpool, _t(kn), _t(vn), _t(table),
                            _t(np.asarray(pos, np.int32)), **kw)
        np.testing.assert_array_equal(_np32(tpool[blocks]), _np32(jpool))


def test_write_through_a_minus_one_slot_leaves_the_last_block():
    """A tight pool whose last block (N-1) is live: rows whose table slot is
    -1 (a slot that is not live, at position -1 or at a stale length) write
    nothing there (only into the sink past it).  A torch index of -1 would
    wrap onto block N-1."""
    from eddie_wang_hackathon2023_tpu.ops import paged_attention as jpa
    rs = np.random.RandomState(5)
    N, H, T, D = 3, 2, 4, 8
    pool = rs.randn(N, 2, H, T, D).astype(np.float32)
    table = np.asarray([[2, 1], [-1, -1], [-1, -1], [0, -1]], np.int32)
    pos = np.asarray([5, -1, 6, 9], np.int32)       # row 3: past its table
    kn, vn = (rs.randn(4, H, 1, D).astype(np.float32) for _ in range(2))
    want = jpa.paged_append_kv(_j(pool), _j(kn), _j(vn), _j(table), _j(pos))
    got = ppa.paged_append_kv(_with_sink(_t(pool)), _t(kn), _t(vn),
                              _t(table), _t(pos))[:N]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), pool[2])      # block N-1
    np.testing.assert_array_equal(got[1, :, :, 1].numpy(),
                                  np.stack([kn[0, :, 0], vn[0, :, 0]]))
    # no row valid at all: the pool is unchanged
    none = ppa.paged_append_kv(_with_sink(_t(pool)), _t(kn[1:3]),
                               _t(vn[1:3]), _t(table[1:3]), _t(pos[1:3]))
    np.testing.assert_array_equal(none[:N].numpy(), pool)


# -- (c) the plain paged decode against the Pallas kernel and XLA ------------

@pytest.mark.parametrize("pool_dtype", ["f32", "int8"])
@pytest.mark.parametrize("hkv,h", [(4, 4), (1, 4), (2, 8)],
                         ids=["mha", "mqa", "gqa_rep4"])
def test_plain_paged_decode_matches_paged_kernel(pool_dtype, hkv, h):
    """Lengths at block edges (1, T-1, T, T+1, a full table), permuted
    non-monotonic tables with -1 tails, both layers of a stacked pool.  The
    JAX XLA formulation broadcasts only one KV head (its einsum rejects
    1 < Hkv < H), so GQA is held against the Pallas kernel alone."""
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        paged_decode_attention as j_xla
    from eddie_wang_hackathon2023_tpu.ops.pallas_decode_attention import \
        paged_decode_attention_pallas as j_pallas
    rs = np.random.RandomState(41 + hkv)
    L, T, D, NBLK, MB = 2, 8, 16, 24, 5
    seq = np.asarray([1, T - 1, T, T + 1, MB * T], np.int32)
    B = len(seq)
    pool = rs.randn(L, NBLK, 2, hkv, T, D).astype(np.float32)
    if pool_dtype == "int8":
        pool = np.clip(np.round(pool * 20), -127, 127).astype(np.int8)
    q = rs.randn(B, h, 1, D).astype(np.float32)
    perm = rs.permutation(NBLK)
    table = np.full((B, MB), -1, np.int32)
    k = 0
    for i in range(B):
        nb = -(-int(seq[i]) // T)
        table[i, :nb] = perm[k:k + nb]
        k += nb
    assert np.any(np.diff(table[-1]) < 0)             # not monotonic
    kscale = 0.05 if pool_dtype == "int8" else None
    scale = D ** -0.5
    for layer in range(L):
        want = j_pallas(_j(pool), layer, _j(q), _j(table), _j(seq), scale,
                        kv_quant_orig_scale=kscale, interpret=True)
        got = pdec.plain_paged_decode_attention(
            _t(pool), layer, _t(q), _t(table), _t(seq), scale,
            kv_quant_orig_scale=kscale)
        assert got.shape == (B, h, 1, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=f"layer {layer}")
        wrapped = pdec.fused_paged_decode_attention(
            _t(pool), layer, _t(q), _t(table), _t(seq), scale,
            kv_quant_orig_scale=kscale)
        assert torch.equal(wrapped, got)
        if hkv in (1, h):
            xla = j_xla(_j(q), _j(pool[layer]), _j(table), _j(seq),
                        scale=scale, kv_quant_orig_scale=kscale)
            np.testing.assert_allclose(got.numpy(), np.asarray(xla),
                                       rtol=2e-5, atol=2e-5)


# -- (d) the model over the pool ---------------------------------------------

MHA = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64)                       # 4 heads of 16
MQA = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=1, max_position_embeddings=64)


def _models(kw, woq: int, seed: int = 0):
    """(JAX model, port model) for one decoder config, fp32, random weights
    (LayerNorm weights 1 + N(0, 0.02), the rest N(0, 0.2)), weight-only with
    ``woq`` bits (8 or 4; 0 or False: float) on both sides."""
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    jstate = state
    if woq:
        jm, jstate = j_woq(jm, state, JQ.use_weight_only(woq == 4))
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jstate.items()})
    pc = DecoderConfig(**kw, dtype="float32", quant_mode=(
        QuantMode.use_weight_only(woq == 4) if woq else QuantMode(0)))
    pm = from_jax_state(quantize_state(state, pc), pc, device="cpu")
    return jm, pm


@pytest.mark.parametrize("family", ["mha", "mqa"])
def test_decoder_over_the_pool_matches_jax(family):
    """Two prompts (7 and 3 tokens, right-padded to 8) prefilled through
    their tables, then three ticks at per-row positions with a third row
    that is not live (table all -1, position -1): the live rows' logits and
    the pool's blocks (all but the port's sink) agree with the JAX model's
    (1e-4); the row that is not live writes nothing."""
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        PagedCacheState as JState
    jm, pm = _models(MHA if family == "mha" else MQA, woq=False, seed=4)
    params = jm.state_dict()
    rs = np.random.RandomState(6)
    T, P, NB = 4, 8, 9
    mgr = KVCacheManager(num_layers=2, num_blocks=NB, tokens_per_block=T,
                         max_blocks_per_seq=4)
    plens = [7, 3]
    for i, p in enumerate(plens):
        mgr.add_sequence(GenerationSequence(i, i), p)
    table = np.full((3, 4), -1, np.int32)
    table[:2] = mgr.get_block_index_arrays()[:, 0]
    ids = rs.randint(0, 97, (2, P)).astype(np.int32)
    jpool = jm.new_paged_pool(NB, T)
    pool = pm.new_paged_pool(NB, T)
    assert pool.shape[1] == jpool.shape[1] + 1
    assert pool.shape[2:] == jpool.shape[2:]
    j_lg, jst = jm.apply(params, _j(ids), JState(jpool, _j(table[:2])), 0,
                         _j(np.asarray(plens, np.int32)))
    with torch.inference_mode():
        lg, st = pm(_t(ids).long(), ppa.PagedCacheState(pool, _t(table[:2])),
                    0, _t(np.asarray(plens, np.int32)))
    np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=1e-4)
    jpool = jst.pool
    lens = np.asarray(plens + [0], np.int32)
    for _ in range(3):
        mgr.step([False, False])
        table[:2] = mgr.get_block_index_arrays()[:, 0]
        lens[:2] += 1
        tok = rs.randint(0, 97, (3, 1)).astype(np.int32)
        j_lg, jst = jm.apply(params, _j(tok), JState(jpool, _j(table)),
                             _j(lens - 1), _j(lens))
        with torch.inference_mode():
            lg, st = pm(_t(tok).long(), ppa.PagedCacheState(pool, _t(table)),
                        _t(lens - 1), _t(lens))
        assert st.pool is pool
        np.testing.assert_allclose(lg[:2].numpy(), np.asarray(j_lg)[:2],
                                   atol=1e-4)
        jpool = jst.pool
        np.testing.assert_allclose(pool[:, :NB].numpy(), np.asarray(jpool),
                                   atol=1e-4)


# -- (e) serving, token-exact with the JAX manager ---------------------------

def _serve(cbm, req_cls, sc, model, prompts, end_id, **kw):
    """{request id: output tokens} of one run, the requests released one per
    poll (staggered admission)."""
    results = {}
    queue = [req_cls(i, p, max_new_tokens=8, end_id=end_id)
             for i, p in enumerate(prompts)]

    def get_requests(n):
        return [queue.pop(0)] if queue else []

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]

    cbm(model, sc, max_batch_size=2, max_seq_len=32, paged=True,
        tokens_per_block=8, get_inference_requests=get_requests,
        send_response=send, **kw).run()
    return results


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "paged_kernel"])
@pytest.mark.parametrize("woq", [0, 8, 4], ids=["float", "woq8", "woq4"])
@pytest.mark.parametrize("family", ["mha", "mqa"])
def test_serving_token_exact_with_jax(family, woq, pallas, monkeypatch):
    """Six prompts of 1-7 tokens through 2 slots (tables of 4 blocks of 8)
    in a pool of 5 blocks, 8 new tokens; the end id is a token that request
    0 makes on its fourth step, so some requests end early and their slots
    and blocks are reused mid-run.  The JAX side runs its XLA formulation or
    its ``_paged_kernel`` in interpret mode (taken at batch <= 2), set
    before its first trace.  Weights float, int8 or int4 weight-only (per
    channel at width 64)."""
    from eddie_wang_hackathon2023_tpu.runtime.batch_manager import \
        ContinuousBatchingManager as JManager
    from eddie_wang_hackathon2023_tpu.runtime.batch_manager import \
        InferenceRequest as JRequest
    from eddie_wang_hackathon2023_tpu.runtime.sampling import \
        SamplingConfig as JSampling
    jm, pm = _models(MHA if family == "mha" else MQA, woq, seed=2)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 96, n).astype(np.int32)
               for n in (5, 2, 7, 3, 6, 1)]
    free = _serve(ContinuousBatchingManager, InferenceRequest,
                  SamplingConfig(end_id=-1, pad_id=96), pm, prompts, -1,
                  device="cpu")
    end_id = free[0][3]
    got = _serve(ContinuousBatchingManager, InferenceRequest,
                 SamplingConfig(end_id=-1, pad_id=96), pm, prompts, end_id,
                 device="cpu", num_blocks=5)
    monkeypatch.setenv("EWT_PALLAS_DECODE", pallas)
    jax.clear_caches()
    try:
        want = _serve(JManager, JRequest, JSampling(end_id=-1, pad_id=96),
                      jm, prompts, end_id, num_blocks=5)
    finally:
        monkeypatch.delenv("EWT_PALLAS_DECODE")
        jax.clear_caches()
    assert sorted(got) == list(range(len(prompts)))
    assert got == want
    assert len(got[0]) == free[0].index(end_id) + 1 < 8


def test_streaming_and_slot_reuse():
    """Streaming responses carry one token each and agree with the final
    response; six three-token requests through two slots all finish, in
    three waves of two ticks each (the first token comes from the prefill;
    as in the JAX manager, a poll that ends with no live slot counts as
    empty, and two empty polls end ``run``)."""
    _, pm = _models(MHA, woq=False, seed=3)
    chunks = []
    q = [InferenceRequest(0, np.asarray([5, 11], np.int32), max_new_tokens=5,
                          streaming=True)]
    ContinuousBatchingManager(
        pm, SamplingConfig(end_id=-1, pad_id=96), max_batch_size=2,
        max_seq_len=32, paged=True, tokens_per_block=8, device="cpu",
        get_inference_requests=lambda n: [q.pop()] if q else [],
        send_response=chunks.append).run()
    finals = [c for c in chunks if c.finished]
    assert len(finals) == 1 and len(finals[0].output_ids) == 5
    streamed = [c.output_ids[0] for c in chunks if not c.finished]
    assert streamed == finals[0].output_ids[:len(streamed)] and streamed
    done = []
    q2 = [InferenceRequest(i, np.asarray([3 + i], np.int32),
                           max_new_tokens=3) for i in range(6)]
    mgr = ContinuousBatchingManager(
        pm, SamplingConfig(end_id=-1, pad_id=96), max_batch_size=2,
        max_seq_len=32, paged=True, tokens_per_block=8, device="cpu",
        get_inference_requests=lambda n: [q2.pop(0)
                                          for _ in range(min(n, len(q2)))],
        send_response=lambda r: done.append(r.request_id))
    mgr.run()
    assert sorted(done) == list(range(6)) and mgr.decode_ticks == 6


# -- (f) chip_smoke.py's serve path, rehearsed -------------------------------

def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_serve_path_on_cpu(one_cpu_thread):
    """The serve path of ``chip_smoke.py`` at 2 layers of width 64 (heads of
    16, vocab 97): 64 requests of 60 prompt tokens through 8 slots, 20 new
    tokens each, the teacher-forced replay through the plain path exact (on
    the CPU both are the plain version), no kernel launched from CPU
    tensors, serve_bench's metrics printed."""
    smoke = _chip_smoke()
    config = dataclasses.replace(smoke.gpt_350m_config(), vocab_size=97,
                                 hidden_size=64, num_layers=2, num_heads=4,
                                 num_kv_heads=4)
    e2e, counts = smoke.serve_path(torch, np, config=config, device="cpu")
    assert set(counts.values()) == {0}
    assert e2e["requests"] == 64 and e2e["total_new_tokens"] == 64 * 20
    assert e2e["decode_ticks"] >= 8 * 19
    assert e2e["logits_rel_err"] == 0.0
    assert e2e["req_per_s"] > 0 and e2e["tokens_per_sec"] > 0


# -- (g) what is not ported, and what this once refused; (h) the device ------

def _drain(pm, sc=None, own=None, **kw):
    """{request id: tokens} of three requests (prompts of 2, 5 and 3
    tokens, 4 new tokens each) through 2 slots of the port's manager, and
    the manager."""
    prompts = [[1, 2], [5, 11, 17, 23, 31], [40, 2, 9]]
    q = [InferenceRequest(i, np.asarray(p, np.int32), max_new_tokens=4,
                          sampling=own) for i, p in enumerate(prompts)]
    out = {}
    kw = {**dict(paged=True, max_batch_size=2, max_seq_len=32,
                 tokens_per_block=8, device="cpu"), **kw}
    mgr = ContinuousBatchingManager(
        pm, sc or SamplingConfig(end_id=-1, pad_id=96),
        get_inference_requests=lambda n: [q.pop(0)] if q else [],
        send_response=lambda r: out.__setitem__(
            r.request_id, [int(t) for t in r.output_ids])
        if r.finished else None, **kw)
    mgr.run()
    return out, mgr


@pytest.mark.parametrize("option", [
    dict(paged=False), dict(mixed_admission=True), dict(max_beam_width=2),
    dict(steps_per_tick=2), dict(native_scheduler=True)],
    ids=lambda o: next(iter(o)))
def test_unported_manager_options_raise(option):
    """Beams in serving (``max_beam_width > 1``) raise.  The other options
    were refused before this slice and now run: the dense slot cache,
    mixed admission, two steps a tick and the native scheduler serve the
    greedy tokens of the paged one-step manager (the JAX comparisons are
    in ``test_torch_serving_modes.py``)."""
    from eddie_wang_hackathon2023_tpu_torch.native import batch_runtime
    _, pm = _models(MHA, woq=False)
    if "max_beam_width" in option:
        with pytest.raises(NotImplementedError):
            ContinuousBatchingManager(pm, SamplingConfig(), paged=True,
                                      device="cpu", **option)
        return
    want, _ = _drain(pm, native_scheduler=False)
    got, mgr = _drain(pm, **option)
    assert got == want and all(len(t) == 4 for t in got.values())
    if "native_scheduler" in option:
        assert isinstance(mgr.sched, batch_runtime.NativeScheduler)
    if "mixed_admission" in option:
        assert mgr.mixed_ticks > 0 and mgr.prefills == 0
    if "steps_per_tick" in option:
        assert mgr.decode_steps == 2 * mgr.decode_ticks
    if "paged" in option:
        assert mgr.cache is not None and mgr.prefills == 3


@pytest.mark.parametrize("sampling", [
    dict(top_k=5, temperature=0.8), dict(top_p=0.9),
    dict(repetition_penalty=1.2), dict(min_length=3),
    dict(bad_words_list=[[3]]), dict(stop_words_list=[[3, 4]]),
    dict(num_beams=2)], ids=lambda o: next(iter(o)))
def test_unported_sampling_raises(sampling):
    """Beams (``num_beams=2``) raise, for the manager's config and for a
    request's own.  The six other configs were refused before this slice
    and now run: as the manager's config and as each request's own (with
    the manager's seed, so the same noise) they give the same tokens, four
    a request in range, with the knob's effect where it shows (the JAX
    comparisons are in ``test_torch_serving_sampling.py``)."""
    _, pm = _models(MHA, woq=False)
    if "num_beams" in sampling:
        with pytest.raises(NotImplementedError):
            ContinuousBatchingManager(pm, SamplingConfig(**sampling),
                                      paged=True, device="cpu")
        q = [InferenceRequest(0, np.asarray([1, 2], np.int32),
                              max_new_tokens=2,
                              sampling=SamplingConfig(**sampling))]
        mgr = ContinuousBatchingManager(
            pm, SamplingConfig(), paged=True, device="cpu", max_seq_len=32,
            get_inference_requests=lambda n: [q.pop()] if q else [])
        with pytest.raises(NotImplementedError):
            mgr.run()
        return
    sc = SamplingConfig(end_id=-1, pad_id=96, **sampling)
    as_config, _ = _drain(pm, sc)
    as_own, _ = _drain(pm, own=sc)
    assert as_config == as_own and sorted(as_config) == [0, 1, 2]
    for toks in as_config.values():
        assert all(0 <= t < 97 for t in toks)
        if "bad_words_list" in sampling:
            assert 3 not in toks
        if "stop_words_list" in sampling:
            stop = [i for i in range(1, len(toks))
                    if toks[i - 1:i + 1] == [3, 4]]
            assert len(toks) == 4 or stop == [len(toks) - 1]
        else:
            assert len(toks) == 4


def test_unported_paged_modes_raise():
    """fp8 pools (the writes and the attention), paged beams, left-padded
    prompts over the pool, and several query tokens without their causal
    offsets raise.  The mixed windows are ported: a window's attention with
    per-row offsets, and a prompt/decode window through the model."""
    pool = torch.zeros(1, 3, 2, 1, 4, 16)
    q = torch.zeros(2, 4, 1, 16)
    table = torch.tensor([[0, 1], [2, -1]])
    seq = torch.tensor([3, 2])
    fp8 = pool.to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError):
        pdec.fused_paged_decode_attention(fp8, 0, q, table, seq, 0.25)
    with pytest.raises(NotImplementedError):
        ppa.paged_append_kv(fp8[0], q[:, :1], q[:, :1], table, seq - 1)
    out = ppa.paged_decode_attention(q, pool[0], table, seq,
                                     causal_offset=seq)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError):
        ppa.paged_decode_attention(q, pool[0], table, seq,
                                   beam_indirection=torch.zeros(1, 2, 8))
    with pytest.raises(ValueError):
        ppa.paged_decode_attention(torch.zeros(2, 4, 3, 16), pool[0], table,
                                   seq)
    model = DecoderLMHead(DecoderConfig(**MHA, dtype="float32"))
    state = ppa.PagedCacheState(model.new_paged_pool(4, 4),
                                torch.tensor([[0, 1], [2, -1]]))
    with torch.inference_mode():
        lg, st = model(torch.zeros(2, 3, dtype=torch.long), state,
                       torch.tensor([1, 2]), torch.tensor([4, 5]))
    assert lg.shape == (2, 3, 97) and st.pool is state.pool
    with torch.inference_mode(), pytest.raises(NotImplementedError):
        model(torch.zeros(2, 1, dtype=torch.long), state, torch.tensor([1, 2]),
              torch.tensor([2, 3]), attention_start=torch.tensor([0, 0]))


def test_manager_needs_cuda_unless_cpu_is_asked(monkeypatch):
    _, pm = _models(MHA, woq=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousBatchingManager(pm, SamplingConfig(), paged=True,
                                      device=device)
    mgr = ContinuousBatchingManager(pm, SamplingConfig(), paged=True,
                                    device="cpu")
    assert mgr.pool.device.type == "cpu"
