"""The paged pool's inputs in the port against the JAX package on the CPU:
the beam read over the pool, int8 pools, left-padded prompts, and what the
pool refuses.  Inputs come from numpy seeds (and seeded HF models) and go
to both sides.

* (a) ``paged_decode_attention(beam_indirection=)`` (the JAX masked
  cross-beam formulation) and ``plain_paged_beam_attention`` (the beam
  entry's plain version) against JAX's, bf16 and int8 pools, tables with
  shared prompt blocks, private partial blocks and -1 slots, fp32 q:
  allclose at rtol 1e-5, atol 1e-6 (fp32 sums in another order);
  MQA/GQA paged beams raising in both packages;
* (b) int8 pools through the manager (greedy, mixed admission, and beams
  over the pool): tokens equal to the JAX manager's, and the pool's N
  blocks equal to the JAX pool after the drain (the port's pool has one
  block more, the sink of the dropped writes; under beams one value in
  1e-4 may differ by one step, at an fp32 rounding tie);
* (c) ``attention_start`` on the pool (left-padded prompts): the logits
  of a prefill and a step allclose to the JAX model's (1e-5), the pool
  allclose (fp32) or equal (int8); as in the JAX package the pad is not masked, only the positions
  move;
* (d) ALiBi and GLM on the pool (the reference's faults, pinned): JAX
  Bloom over a pool attends without its bias, so its paged logits differ
  from its dense ones; JAX ChatGLM-6B cannot be admitted to a pool (its
  prompt is bidirectional, the paged prefill asserts a causal mask); the
  port raises ``NotImplementedError`` for both;
* (e) Bloom on the dense slot cache, token-exact with the JAX manager."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as pdec
from eddie_wang_hackathon2023_tpu_torch.ops import paged_attention as ppa
from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, InferenceRequest, SamplingConfig)
from test_torch_serving_modes import one_thread, sharp  # noqa: F401
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

MHA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=4, max_position_embeddings=64)      # 4 heads of 32


# -- (a) the beam read over the pool ------------------------------------------

def _beam_case(rs, bw=3, h=4, hk=4, t=8, d=16, int8=False):
    """A pool of 12 blocks of t tokens and one step's tables for 2 groups
    of bw beams: group 0's rows share a full prompt block and then each
    has a private block (2 t - 3 tokens); group 1's rows have a private
    partial block each (t - 2 tokens); the rest of each row -1.  The
    indirection is random over the group's beams, 2 t + 3 positions
    wide."""
    n, mb = 12, 4
    shape = (n, 2, hk, t, d)
    if int8:
        pool = rs.randint(-128, 128, shape).astype(np.int8)
    else:
        pool = rs.randn(*shape).astype(np.float32)
    table = np.full((2 * bw, mb), -1, np.int32)
    blocks = iter(range(n))
    shared = next(blocks)
    for w in range(bw):
        table[w, :2] = [shared, next(blocks)]
        table[bw + w, 0] = next(blocks)
    seq = np.repeat(np.asarray([2 * t - 3, t - 2], np.int32), bw)
    ind = rs.randint(0, bw, (2, bw, 2 * t + 3)).astype(np.int32)
    q = rs.randn(2 * bw, h, 1, d).astype(np.float32)
    return q, pool, table, seq, ind


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_beam_read_against_jax(int8):
    """The port's paged beam read and the beam entry's plain version
    against JAX's ``paged_decode_attention(beam_indirection=)`` on one
    pool (bf16 values, or int8 with its dequant scale), fp32 q."""
    from eddie_wang_hackathon2023_tpu.ops import paged_attention as jpa
    rs = np.random.RandomState(5)
    q, pool, table, seq, ind = _beam_case(rs, int8=int8)
    scale, kq = 0.3, np.asarray([0.05], np.float32)
    kw = dict(kv_quant_orig_scale=kq) if int8 else {}
    if int8:
        jpool, ppool = jnp.asarray(pool), torch.from_numpy(pool)
    else:
        jpool = jnp.asarray(pool).astype(jnp.bfloat16)
        ppool = torch.from_numpy(pool).to(torch.bfloat16)
    ref = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(seq),
        scale=scale, beam_indirection=jnp.asarray(ind),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    out = ppa.paged_decode_attention(
        torch.from_numpy(q), ppool, torch.from_numpy(table),
        torch.from_numpy(seq), scale=scale,
        beam_indirection=torch.from_numpy(ind), **pkw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    plain = pdec.plain_paged_beam_attention(
        ppool[None], 0, torch.from_numpy(q), torch.from_numpy(table),
        torch.from_numpy(seq), torch.from_numpy(ind), scale,
        pkw.get("kv_quant_orig_scale"))
    fused = pdec.fused_paged_beam_attention(
        ppool[None], 0, torch.from_numpy(q), torch.from_numpy(table),
        torch.from_numpy(seq), torch.from_numpy(ind), scale,
        pkw.get("kv_quant_orig_scale"))
    np.testing.assert_array_equal(plain.numpy(), out.numpy())
    np.testing.assert_array_equal(fused.numpy(), out.numpy())
    # the indirection acts: the table of the rows' own chains differs
    own = np.broadcast_to(np.arange(3)[None, :, None], ind.shape)
    other = ppa.paged_decode_attention(
        torch.from_numpy(q), ppool, torch.from_numpy(table),
        torch.from_numpy(seq), scale=scale,
        beam_indirection=torch.from_numpy(np.ascontiguousarray(own)), **pkw)
    assert not np.allclose(other.numpy(), ref, atol=1e-3)


def test_mqa_gqa_paged_beams_raise_in_both_packages():
    """4 query heads over a pool of 2 KV heads (GQA) and of 1 (MQA): the
    JAX formulation's reshape of q with the KV heads fails (TypeError);
    the port's read and the beam entry raise ``NotImplementedError``."""
    from eddie_wang_hackathon2023_tpu.ops import paged_attention as jpa
    for hk in (2, 1):
        rs = np.random.RandomState(hk)
        q, pool, table, seq, ind = _beam_case(rs, hk=hk)
        with pytest.raises(TypeError):
            jpa.paged_decode_attention(
                jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table),
                jnp.asarray(seq), beam_indirection=jnp.asarray(ind))
        args = (torch.from_numpy(q), torch.from_numpy(pool),
                torch.from_numpy(table), torch.from_numpy(seq))
        with pytest.raises(NotImplementedError):
            ppa.paged_decode_attention(*args,
                                       beam_indirection=torch.from_numpy(ind))
        with pytest.raises(NotImplementedError):
            pdec.fused_paged_beam_attention(
                args[1][None], 0, args[0], args[2], args[3],
                torch.from_numpy(ind), 0.25)


# -- (b) int8 pools through the manager ---------------------------------------

_KV8 = {}


def _kv8_models():
    """(JAX model, port model) of one fp32 decoder (``MHA``, seeded
    weights) with an int8 KV cache, its per-layer scales amax / 127 of
    the float model's cache after a prefill of seeded prompts."""
    if not _KV8:
        from eddie_wang_hackathon2023_tpu.models.decoder import \
            DecoderConfig as JConfig
        from eddie_wang_hackathon2023_tpu.models.decoder import \
            DecoderLMHead as JModel
        from eddie_wang_hackathon2023_tpu.quantization import \
            QuantMode as JQ
        from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
            DecoderConfig
        from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert \
            import from_jax_state, quantize_state
        from eddie_wang_hackathon2023_tpu_torch.quantization.mode import \
            QuantMode
        from test_torch_decoder import _models
        _, pm_f, state = _models(MHA, False, seed=2)
        ids = np.random.RandomState(8).randint(0, 96, (3, 12))
        with torch.inference_mode():
            cache = pm_f.new_kv_cache(3, 12)
            pm_f(torch.from_numpy(ids).long(), cache, 0, 12)
        t = (cache.abs().amax(dim=(1, 2, 3, 4, 5)) / 127).numpy() \
            .reshape(-1, 1).astype(np.float32)
        kv = {"blocks.attention.kv_orig_quant_scale": 1.0 / t,
              "blocks.attention.kv_quant_orig_scale": t}
        jm = JModel(JConfig(**MHA, dtype="float32",
                            quant_mode=JQ(0).set_int8_kv_cache()))
        jm.load_state_dict({k: jnp.asarray(v)
                            for k, v in {**state, **kv}.items()})
        pc = DecoderConfig(**MHA, dtype="float32",
                           quant_mode=QuantMode(0).set_int8_kv_cache())
        pm = from_jax_state(quantize_state({**state, **kv}, pc), pc,
                            device="cpu")
        _KV8["models"] = (jm, pm)
    return _KV8["models"]


def _drain(side, model, prompts, own=None, new=8, **kw):
    """({request id: tokens}, the manager) of one drain, the requests
    released one a poll, ``end_id=-1``, ``pad_id=0``."""
    if side == "jax":
        from eddie_wang_hackathon2023_tpu.runtime.batch_manager import (
            ContinuousBatchingManager as Manager, InferenceRequest as Req)
        from eddie_wang_hackathon2023_tpu.runtime.sampling import \
            SamplingConfig as Sampling
    else:
        Manager, Req, Sampling = (ContinuousBatchingManager,
                                  InferenceRequest, SamplingConfig)
        kw["device"] = "cpu"
    base = dict(end_id=-1, pad_id=0)
    queue = [Req(i, np.asarray(p, np.int32), max_new_tokens=new,
                 sampling=None if own is None else Sampling(**base, **own))
             for i, p in enumerate(prompts)]
    out = {}
    mgr = Manager(model, Sampling(**base),
                  get_inference_requests=lambda n: [queue.pop(0)] if queue
                  else [],
                  send_response=lambda r: out.__setitem__(
                      r.request_id, [int(x) for x in r.output_ids])
                  if r.finished else None, **kw)
    mgr.run()
    return out, mgr


KV8_PROMPTS = [np.random.RandomState(3).randint(0, 96, n).tolist()
               for n in (5, 20, 3, 9)]


@pytest.mark.parametrize("mode", [
    dict(), dict(mixed_admission=True, chunk_width=8),
    dict(max_beam_width=2)], ids=["greedy", "mixed", "beams"])
def test_int8_pool_serving_token_exact_with_jax(mode):
    """Four requests through 2 slots of an int8 pool in blocks of 8: the
    pool is int8, the tokens equal the JAX manager's, and after the drain
    the pool's blocks equal the JAX pool (blocks of both pools are handed
    out in one order; the port's sink block is not compared).  Greedy,
    mixed admission (a prompt of 20 tokens in chunks of 8), and beams of
    width 2 over the pool."""
    jm, pm = _kv8_models()
    own = dict(num_beams=2) if "max_beam_width" in mode else None
    kw = dict(max_batch_size=2, max_seq_len=48, paged=True,
              tokens_per_block=8, **mode)
    want, jmgr = _drain("jax", jm, KV8_PROMPTS, own, **kw)
    got, pmgr = _drain("port", pm, KV8_PROMPTS, own, **kw)
    assert pmgr.pool.dtype == torch.int8
    assert got == want and sorted(got) == [0, 1, 2, 3]
    n = jmgr.pool.shape[1]
    assert pmgr.pool.shape[1] == n + 1
    got, ref = pmgr.pool[:, :n].numpy(), np.asarray(jmgr.pool)
    if own is None:
        np.testing.assert_array_equal(got, ref)
    else:
        # beams: one K value of the 98304 lies within fp32 summation error
        # of a rounding tie, and its int8 differs by one step
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
    assert np.abs(ref.astype(int)).max() > 64


# -- (c) left-padded prompts on the pool ---------------------------------------

@pytest.mark.parametrize("kv8", [False, True], ids=["float", "int8"])
def test_attention_start_on_the_pool_matches_jax(sharp, kv8):  # noqa: F811
    """Three prompts left-padded to 8 (true lengths 8, 5, 3) prefilled into
    a pool in blocks of 4 with ``attention_start`` = the pad, then one
    step at position 8: the logits allclose to the JAX model's (1e-5; only
    the positions move, the pad is attended in both), the pool equal
    (fp32: allclose 1e-5, sums in another order; int8: equal)."""
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        PagedCacheState as JState
    if kv8:
        jm, pm = _kv8_models()
    else:
        jm, pm = sharp
    rs = np.random.RandomState(6)
    lens = np.asarray([8, 5, 3], np.int32)
    ids = rs.randint(1, 96, (3, 8)).astype(np.int32)
    start = (8 - lens).astype(np.int32)
    ids[np.arange(8)[None, :] < start[:, None]] = 0
    table = np.arange(3 * 3, dtype=np.int32).reshape(3, 3)
    nxt = rs.randint(1, 96, (3, 1)).astype(np.int32)
    params = jm.state_dict()
    jpool = jm.new_paged_pool(9, 4)
    lj1, js = jm.apply(params, jnp.asarray(ids), JState(jpool, jnp.asarray(
        table)), 0, jnp.full((3,), 8, jnp.int32),
        attention_start=jnp.asarray(start))
    lj2, js = jm.apply(params, jnp.asarray(nxt), js,
                       jnp.full((3,), 8, jnp.int32),
                       jnp.full((3,), 9, jnp.int32),
                       attention_start=jnp.asarray(start))
    ppool = pm.new_paged_pool(9, 4)
    tt = torch.from_numpy(table)
    with torch.inference_mode():
        lp1, ps = pm(torch.from_numpy(ids).long(),
                     ppa.PagedCacheState(ppool, tt), 0, torch.full((3,), 8),
                     attention_start=torch.from_numpy(start))
        lp2, ps = pm(torch.from_numpy(nxt).long(), ps, torch.full((3,), 8),
                     torch.full((3,), 9),
                     attention_start=torch.from_numpy(start))
    np.testing.assert_allclose(lp1.numpy(), np.asarray(lj1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lp2.numpy(), np.asarray(lj2), rtol=1e-5,
                               atol=1e-5)
    got, want = ps.pool[:, :9].numpy(), np.asarray(js.pool)
    if kv8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the start moves the positions: without it the logits differ
    with torch.inference_mode():
        lp0, _ = pm(torch.from_numpy(ids).long(), ppa.PagedCacheState(
            pm.new_paged_pool(9, 4), tt), 0, torch.full((3,), 8))
    assert not np.allclose(lp0.numpy()[1:], lp1.numpy()[1:], atol=1e-3)


# -- (d) ALiBi and GLM on the pool: the reference's faults, pinned -------------

def test_jax_bloom_on_a_pool_drops_its_bias_and_the_port_refuses():
    """JAX Bloom over a pool: its paged branch never reads the ALiBi
    slopes it makes (``layers/attention.py:466``), so the logits of a
    prefill and of one step differ from its dense cache's; the port's
    model and manager raise ``NotImplementedError`` on a pool instead."""
    from eddie_wang_hackathon2023_tpu.ops.paged_attention import \
        PagedCacheState as JState
    from test_torch_families_b import _bloom
    _, jm, pm, _ = _bloom()
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 96, (1, 6)).astype(np.int32)
    nxt = rs.randint(0, 96, (1, 1)).astype(np.int32)
    params = jm.state_dict()
    table = jnp.asarray([[0, 1]], jnp.int32)
    lp1, st = jm.apply(params, jnp.asarray(ids), JState(
        jm.new_paged_pool(2, 4), table), 0, jnp.asarray([6], jnp.int32))
    lp2, _ = jm.apply(params, jnp.asarray(nxt), st,
                      jnp.asarray([6], jnp.int32), jnp.asarray([7], jnp.int32))
    ld1, cache = jm.apply(params, jnp.asarray(ids), jm.new_kv_cache(1, 8), 0,
                          jnp.asarray([6], jnp.int32))
    ld2, _ = jm.apply(params, jnp.asarray(nxt), cache, 6,
                      jnp.asarray([7], jnp.int32))
    # far beyond fp32 rounding (1e-6 here): the bias is missing
    assert np.abs(np.asarray(lp1) - np.asarray(ld1)).max() > 1e-4
    assert np.abs(np.asarray(lp2) - np.asarray(ld2)).max() > 1e-4
    with torch.inference_mode(), pytest.raises(NotImplementedError):
        pm(torch.from_numpy(ids).long(), ppa.PagedCacheState(
            pm.new_paged_pool(2, 4), torch.tensor([[0, 1]])), 0,
            torch.tensor([6]))
    with pytest.raises(NotImplementedError):
        _drain("port", pm, [ids[0].tolist()], max_batch_size=1,
               max_seq_len=16, paged=True, tokens_per_block=4)


def test_jax_chatglm_cannot_be_admitted_to_a_pool_and_the_port_refuses():
    """JAX ChatGLM-6B (a tiny seeded THUDM-layout state) served over a
    pool: its bidirectional prompt meets the paged prefill's causal-mask
    assertion (``layers/attention.py:544``) at admission; the port's
    model and manager raise ``NotImplementedError``."""
    from test_torch_families_b import V, _glm
    _, jm, pm, _ = _glm()
    prompt = np.random.RandomState(4).randint(0, V - 1, 5).tolist()
    kw = dict(max_batch_size=1, max_seq_len=16, paged=True,
              tokens_per_block=4)
    with pytest.raises(AssertionError):
        _drain("jax", jm, [prompt], **kw)
    with pytest.raises(NotImplementedError):
        _drain("port", pm, [prompt], **kw)


# -- (e) Bloom on the dense slot cache -----------------------------------------

@pytest.mark.parametrize("spt", [1, 2])
def test_bloom_on_the_dense_slot_cache_token_exact_with_jax(spt):
    """The tiny seeded HF Bloom through 2 slots of the dense slot cache,
    four prompts of 2-9 tokens, 8 new ones (a slot used twice, ALiBi over
    each row's own columns): token-exact with the JAX manager, at one and
    two steps a tick."""
    from test_torch_families_b import _bloom
    _, jm, pm, _ = _bloom()
    prompts = [np.random.RandomState(9).randint(0, 96, n).tolist()
               for n in (4, 9, 2, 6)]
    kw = dict(max_batch_size=2, max_seq_len=32, steps_per_tick=spt)
    want, _ = _drain("jax", jm, prompts, **kw)
    got, mgr = _drain("port", pm, prompts, **kw)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert mgr.prefills == 4
