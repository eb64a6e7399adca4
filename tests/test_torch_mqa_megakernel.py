"""The megakernel's grouped (MQA/GQA) mode against the JAX package on the
CPU, at d 512 with 4 query heads of 128 over 1 or 2 KV heads (the
SantaCoder / StarCoder class).

* the packer against the JAX ``pack_decoder_blobs`` in its meaning: the q
  panel and every later panel bit-equal, the port's ``kvblob`` [L, d,
  2 dkv] equal to the first 2 dkv columns of the JAX combined k/v panel
  (whose other columns are its zero padding, which the port does not
  copy), scales, biases and norms bit-equal (the k and v pair rows zero
  after dkv on both sides); fp32 and int8 weight-only;
* the plain megakernel (``plain_fused_decoder_stack``, what the wrapper
  runs on CPU tensors) against the JAX ``fused_decoder_stack`` in
  interpret mode (rtol 2e-4 / atol 2e-3, the JAX package's megakernel
  tolerance, tests/test_megakernel.py:91-93) with fp32 and int8 panels,
  and the fresh K/V [L, 2, Hkv, D];
* a SantaCoder-class decode step through each side's megakernel branch
  (logits and the cache), and greedy ``GenerationSession`` at batch 1
  through the plain megakernel token-exact with the JAX session through
  its kernel (``EWT_MEGAKERNEL=1``, interpret mode) and with the port's
  layer-by-layer path;
* the eligibility gate (MQA/GQA at head dim 128, not 64), blobs and a
  cache of different KV heads refused, the plan and tiles at
  SantaCoder-1B's widths (the qkv stage's d + 2 dkv columns: no padding
  streamed);
* a CPU rehearsal of ``chip_smoke.py``'s santacoder paths.
"""
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
from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (GenerationSession,
                                                        ModelConfig,
                                                        SamplingConfig)
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

RTOL, ATOL = 2e-4, 2e-3
L, D, H, HD, FFN = 2, 512, 4, 128, 1280       # ffn padded to 1536 (3 d)


def _block_state(hkv, rs):
    """A stacked float DecoderBlock state of the separate-KV layout (JAX
    layout): GPT-2 topology (LayerNorm with biases, tanh GELU), seeded."""
    st = {"attention.qkv.weight": rs.randn(L, H, HD, D) * 0.04,
          "attention.qkv.kv_weight": rs.randn(L, 2, hkv, HD, D) * 0.04,
          "attention.qkv.bias": rs.randn(L, H, HD) * 0.05,
          "attention.qkv.kv_bias": rs.randn(L, 2, hkv, HD) * 0.05,
          "attention.dense.weight": rs.randn(L, D, D) * 0.04,
          "attention.dense.bias": rs.randn(L, D) * 0.05,
          "mlp.fc.weight": rs.randn(L, FFN, D) * 0.04,
          "mlp.fc.bias": rs.randn(L, FFN) * 0.05,
          "mlp.proj.weight": rs.randn(L, D, FFN) * 0.03,
          "mlp.proj.bias": rs.randn(L, D) * 0.05}
    for name in ("input_layernorm", "post_layernorm"):
        st[name + ".weight"] = 1 + rs.randn(L, D) * 0.1
        st[name + ".bias"] = rs.randn(L, D) * 0.1
    return {k: v.astype(np.float32) for k, v in st.items()}


def _woq8(state):
    """The JAX package's int8 weight-only quantiser on the block's linears
    (the separate-KV QKV's columns q | k | v joined, as the surgery lays
    them out)."""
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        quantize_weights_int8
    out = dict(state)
    for path in ("attention.qkv", "attention.dense", "mlp.fc", "mlp.proj"):
        w = out.pop(path + ".weight")
        if path.endswith("qkv"):
            kv = out.pop(path + ".kv_weight")
            w = np.concatenate([w.reshape(L, -1, D), kv.reshape(L, -1, D)],
                               axis=1)
        qs, ss = zip(*(quantize_weights_int8(np.ascontiguousarray(m.T))
                       for m in w))
        out[path + ".qweight"] = np.stack(qs)
        out[path + ".per_channel_scale"] = np.stack(ss)
    return out


def _state(hkv, int8):
    st = _block_state(hkv, np.random.RandomState(10 * hkv + int8))
    st = _woq8(st) if int8 else st
    kw = dict(n_layer=L, hidden=D, n_head=H, head_dim=HD, ffn=FFN,
              with_cross=False, n_kv_head=hkv)
    return st, kw


CASES = [(1, False), (1, True), (2, False), (2, True)]
IDS = ["mqa", "mqa_woq8", "gqa", "gqa_woq8"]


# -- the packer ----------------------------------------------------------------

@pytest.mark.parametrize("hkv,int8", CASES, ids=IDS)
def test_grouped_packer_matches_jax(hkv, int8):
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import \
        pack_decoder_blobs as j_pack
    st, kw = _state(hkv, int8)
    ref = j_pack({k: jnp.asarray(v) for k, v in st.items()}, **kw)
    out = mk.pack_decoder_blobs({k: torch.from_numpy(v)
                                 for k, v in st.items()}, **kw)
    dkv = hkv * HD
    jw = np.asarray(ref.wblob).astype(np.float32)
    w = out.wblob.float().numpy()
    # q; then dense, fc1, fc2 (the JAX image's panel 1 is k/v)
    assert w.shape == (L, 2 + 2 * 3, D, D) and jw.shape[1] == w.shape[1] + 1
    np.testing.assert_array_equal(w[:, 0], jw[:, 0])
    np.testing.assert_array_equal(w[:, 1:], jw[:, 2:])
    kv = out.kvblob.float().numpy()
    assert kv.shape == (L, D, 2 * dkv) and out.kvblob.dtype == out.wblob.dtype
    np.testing.assert_array_equal(kv, jw[:, 1, :, :2 * dkv])
    assert not jw[:, 1, :, 2 * dkv:].any()          # the TPU's padding
    for name in ("pair_scale", "pair_bias", "flat_scale", "flat_bias",
                 "ln_par", "kv_oq", "kv_qo"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert not out.pair_scale[:, 1:, dkv // 128:].any()
    assert mk.blob_layout(out) == (False, False, 3)
    assert mk.blob_kv_width(out) == dkv


# -- the plain megakernel against the JAX kernel --------------------------------

@pytest.mark.parametrize("hkv,int8", CASES, ids=IDS)
def test_plain_grouped_matches_jax_kernel(hkv, int8):
    """A 160-column cache at sequence 70 with the start index at 4 (a
    60-token prompt bucketed to 64), seeded; the fresh K/V at Hkv heads."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import (
        fused_decoder_stack as j_fds, pack_decoder_blobs as j_pack)
    st, kw = _state(hkv, int8)
    rs = np.random.RandomState(70 + hkv)
    x = rs.randn(1, D).astype(np.float32)
    cache = (rs.randn(L, 1, 2, hkv, HD, 160) * 0.5).astype(np.float32)
    seq, start = 70, 4
    hj, fj = j_fds(jnp.asarray(x), j_pack(st, **kw), jnp.asarray(cache),
                   jnp.asarray([seq], jnp.int32), HD ** -0.5,
                   start_index=jnp.asarray([start], jnp.int32), head_dim=HD,
                   interpret=True)
    mk.reset_launches()
    hp, fp = mk.fused_decoder_stack(
        torch.from_numpy(x), mk.pack_decoder_blobs(st, **kw),
        torch.from_numpy(cache), torch.tensor([seq], dtype=torch.int32),
        HD ** -0.5, start_index=torch.tensor([start], dtype=torch.int32),
        head_dim=HD)
    assert mk.launches["decoder_megakernel"] == 0       # plain on the CPU
    assert hp.shape == (1, D) and fp.shape == (L, 2, hkv, HD)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=RTOL,
                               atol=ATOL)
    assert np.abs(hp.numpy()).max() > 0.5


# -- the model and the session -------------------------------------------------

SANTA = dict(vocab_size=160, hidden_size=D, num_layers=L, num_heads=H,
             num_kv_heads=1, ffn_hidden_size=FFN, max_position_embeddings=96)
_MODELS = {}


def _models(woq: bool):
    """(JAX model, port model) of a tiny SantaCoder (one KV head), fp32,
    seeded weights (norm weights 1 + N(0, 0.02), the rest N(0, 0.04)),
    int8 weight-only on both sides with ``woq``; built once a module."""
    if woq in _MODELS:
        return _MODELS[woq]
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    jm = JModel(JConfig(**SANTA, dtype="float32"))
    rs = np.random.RandomState(12)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        state[name] = (1 + 0.02 * x if name.endswith("layernorm.weight")
                       or name == "ln_f.weight" else 0.04 * x)
    jstate = state
    if woq:
        jm, jstate = j_woq(jm, state, JQ.use_weight_only())
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jstate.items()})
    pc = DecoderConfig(**SANTA, dtype="float32", quant_mode=(
        QuantMode.use_weight_only() if woq else QuantMode(0)))
    pm = from_jax_state(quantize_state(state, pc), pc, device="cpu")
    _MODELS[woq] = (jm, pm)
    return jm, pm


@pytest.fixture
def jax_megakernel(monkeypatch):
    """The JAX package's megakernel on (interpret mode on the CPU), the
    decode tail off, set before the first trace and cleared after."""
    monkeypatch.setenv("EWT_MEGAKERNEL", "1")
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    jax.clear_caches()
    yield
    monkeypatch.delenv("EWT_MEGAKERNEL")
    jax.clear_caches()


@torch.inference_mode()
def test_santacoder_step_with_blobs_matches_jax(jax_megakernel):
    """A left-padded prompt (start 3), then two steps through each side's
    megakernel branch (one KV head): logits and the cache, against JAX and
    against the port's layer-by-layer step."""
    jm, pm = _models(False)
    assert pm.megakernel_eligible()
    params = jm.state_dict()
    jblobs = jm.megakernel_blobs(params)
    blobs = pm.megakernel_blobs()
    assert blobs.kvblob is not None and blobs.kvblob.shape == (L, D, 2 * HD)
    ids = np.asarray([[0, 0, 0, 5, 9, 2, 14, 7]], np.int32)
    start = np.asarray([3], np.int32)
    jl, jc = jm.apply(params, jnp.asarray(ids), jm.new_kv_cache(1, 16), 0,
                      jnp.asarray([8], jnp.int32),
                      attention_start=jnp.asarray(start))
    cache = pm.new_kv_cache(1, 16)
    assert cache.shape == (L, 1, 2, 1, HD, 16)
    pl, cache = pm(torch.from_numpy(ids).long(), cache, 0,
                   torch.tensor([8], dtype=torch.int32),
                   attention_start=torch.from_numpy(start))
    ref_cache = cache.clone()
    for i, tok in enumerate((3, 77)):
        jl, jc = jm.apply(params, jnp.asarray([[tok]], jnp.int32), jc, 8 + i,
                          jnp.asarray([9 + i], jnp.int32),
                          attention_start=jnp.asarray(start),
                          megakernel_blobs=jblobs)
        pl, cache = pm(torch.tensor([[tok]]), cache, 8 + i, 9 + i,
                       attention_start=torch.from_numpy(start),
                       megakernel_blobs=blobs)
        rl, ref_cache = pm(torch.tensor([[tok]]), ref_cache, 8 + i, 9 + i,
                           attention_start=torch.from_numpy(start))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pl.numpy(), rl.numpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("woq", [False, True], ids=["float", "woq8"])
def test_greedy_batch_1_through_the_grouped_megakernel_token_exact(
        woq, jax_megakernel):
    """A 5-token prompt (bucketed to 8: start 3), 8 new tokens: the port's
    session through the plain megakernel's grouped mode, the JAX session
    through its kernel and the port's session layer by layer agree token
    for token."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    jm, pm = _models(woq)
    mc = dict(vocab_size=160, num_layers=L, num_heads=H, hidden_size=D,
              max_seq_len=96, num_kv_heads=1)
    ids = np.asarray([[5, 9, 2, 14, 7]], np.int32)
    lens = np.asarray([5], np.int32)
    sess = GenerationSession(ModelConfig(**mc), pm,
                             SamplingConfig(end_id=-1, pad_id=0),
                             decode_megakernel=True)
    pt, pl, pc = sess.decode(ids, lens, max_new_tokens=8)
    assert sess._mk_blobs is not None and sess._mk_blobs.kvblob is not None
    lt, _, lc = GenerationSession(
        ModelConfig(**mc), pm, SamplingConfig(end_id=-1, pad_id=0),
        decode_megakernel=False).decode(ids, lens, max_new_tokens=8)
    jsess = JSession(JMC(**mc), jm, JSampling(end_id=-1, pad_id=0))
    jt, jl, jc = jsess.decode(ids, lens, max_new_tokens=8)
    assert jsess._mk_blobs is not None          # the JAX kernel ran
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pt, lt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pc, lc, rtol=1e-4, atol=1e-4)


def test_grouped_megakernel_eligibility():
    """MQA and GQA at head dim 128 (H a multiple of Hkv) are eligible, as
    in the JAX model (models/decoder.py:218-231); at head dim 64 not; an
    eligible MQA model at batch 1 gets blobs from its session."""
    with torch.device("meta"):
        def model(**kw):
            return DecoderLMHead(DecoderConfig(**{**SANTA, **kw}))
        assert model().megakernel_eligible()
        assert model(num_kv_heads=2).megakernel_eligible()
        assert model(dtype="bfloat16").megakernel_eligible()
        assert not model(num_heads=8, num_kv_heads=1).megakernel_eligible()
        assert not model(num_heads=8, num_kv_heads=2).megakernel_eligible()
        assert model(num_heads=8, num_kv_heads=8).megakernel_eligible()
        assert not model(position_embedding="alibi").megakernel_eligible()
        assert not model(deepnorm_alpha=2.0).megakernel_eligible()
        assert not model(bidirectional_context=True).megakernel_eligible()
    _, pm = _models(False)
    sess = GenerationSession(
        ModelConfig(vocab_size=160, num_layers=L, num_heads=H,
                    hidden_size=D, num_kv_heads=1), pm,
        SamplingConfig(end_id=-1, pad_id=0), decode_megakernel=True)
    assert sess._megakernel_blobs(2) is None
    assert sess._megakernel_blobs(1).kvblob is not None


def test_blobs_and_cache_of_different_kv_heads_raise():
    """Blobs packed for one KV head against a cache of two (and equal-heads
    blobs against a one-head cache) raise; the packer refuses the grouped
    mode at head dim 64 and with cross-attention, as the JAX packer
    does."""
    st, kw = _state(1, False)
    blobs = mk.pack_decoder_blobs(st, **kw)
    x, seq = torch.zeros(1, D), torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.fused_decoder_stack(x, blobs, torch.zeros(L, 1, 2, 2, HD, 16),
                               seq, 0.1, head_dim=HD)
    st2, kw2 = _state(2, False)
    eq = {k: v for k, v in st2.items() if "qkv" not in k}
    eq["attention.qkv.weight"] = np.zeros((L, 3, H, HD, D), np.float32)
    equal = mk.pack_decoder_blobs(eq, **{**kw2, "n_kv_head": H})
    with pytest.raises(ValueError):
        mk.fused_decoder_stack(x, equal, torch.zeros(L, 1, 2, 1, HD, 16),
                               seq, 0.1, head_dim=HD)
    with pytest.raises(NotImplementedError):
        mk.pack_decoder_blobs(st, **{**kw, "n_head": 8, "head_dim": 64})
    with pytest.raises(NotImplementedError):
        mk.pack_decoder_blobs(st, **{**kw, "with_cross": True})


@pytest.mark.parametrize("itemsize", [1, 2], ids=["int8", "bf16"])
def test_plan_at_santacoder_1b(itemsize):
    """d 2048, one KV head of 128, ffn 8192 (4 panels), 132 SMs: the qkv
    stage's 2304 columns (d + 2 dkv, not the TPU's 3 d) in items of 18,
    fc1's 8192 in items of 63 (at most 64 a block: one wave), every piece
    within 64 KB, the shared memory before the ring and two pieces within
    a block's 227 KB (4 KB left for static shared memory)."""
    d, nf, sms, dkv = 2048, 4, 132, 128
    plan = mk.megakernel_plan(d, nf, sms, with_cross=False, gated=False,
                              itemsize=itemsize, dkv=dkv)
    assert plan["item_c"] == [18, 16, 0, 0, 63, 16]
    assert plan["item_c"][0] * plan["items"][0] >= d + 2 * dkv
    assert max(plan["item_c"]) <= mk.ITEM_MAX_COLS
    assert max(plan["items"]) <= sms
    per_layer = sum(plan["item_c"][g] * plan["items"][g] * plan["item_k"][g]
                    for g in (0, 1, 4, 5))
    assert plan["layer_bytes"] == per_layer * itemsize
    # the streamed bytes against the TPU's padded k/v panel (3 d columns)
    padded = mk.megakernel_plan(d, nf, sms, False, False, itemsize)
    assert plan["layer_bytes"] < padded["layer_bytes"]
    vals = 16 // itemsize
    vin = max(plan["item_k"])
    part = max(max(plan["piece_c"][g] * plan["item_k"][g] // vals
                   for g in (0, 1, 4, 5)), 4 * 256)
    before = -(-(d * 4 + (vin + vin // 32 * 4) * 4 + part * 4) // 128) * 128
    piece = max(plan["piece_c"][g] * plan["item_k"][g] * itemsize
                for g in (0, 1, 4, 5))
    assert piece <= mk.PIECE_BYTES
    assert before + 2 * piece <= 227 * 1024 - 4096
    assert mk.kernel_takes(torch.bfloat16, d, nf, 128)


@pytest.mark.parametrize("itemsize", [1, 2], ids=["int8", "bf16"])
def test_grouped_tiles_round_trip(itemsize):
    """The qkv stage read back from the tiles is q's panel then the K and
    V columns (2 dkv of them, no padding), zeros past the stage's columns;
    the other stages as with equal heads."""
    st, kw = _state(2, itemsize == 1)
    blobs = mk.pack_decoder_blobs(st, **kw)
    if itemsize == 2:
        blobs = blobs._replace(wblob=blobs.wblob.bfloat16(),
                               kvblob=blobs.kvblob.bfloat16())
    sms = 100
    tiled = mk.megakernel_tiles(blobs, sms=sms)
    plan = mk.megakernel_plan(D, 3, sms, False, False, itemsize, 2 * HD)
    assert tiled.tiles.shape == (L, plan["layer_bytes"] // itemsize)
    w, kv = blobs.wblob, blobs.kvblob
    want = {0: torch.cat([w[:, 0], kv], dim=2), 1: w[:, 1],
            4: torch.cat([w[:, 2 + j] for j in range(3)], dim=2),
            5: torch.cat([w[:, 5 + j] for j in range(3)], dim=1)}
    for g, ref in want.items():
        got = mk.untile(tiled.tiles, plan, g)
        cols = ref.shape[2]
        assert torch.equal(got[..., :cols], ref), g
        assert not got[..., cols:].any()


# -- chip_smoke.py's santacoder paths, rehearsed --------------------------------

def test_chip_smoke_santacoder_path_on_cpu(one_cpu_thread):
    """``chip_smoke.santacoder_path`` at 2 layers of width 256 (2 query
    heads of 128 over one KV head, vocab 97), bf16 as on the card, on the
    decoder path's seeded float state: batch 1 through the megakernel's
    plain grouped mode in bf16 and woq8, 20 tokens for a prompt of 60, no
    kernel launched from CPU tensors, the replays and the comparison with
    the layer-by-layer session within 5e-2."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = dataclasses.replace(
        smoke.santacoder_float_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, max_position_embeddings=128)
    state = smoke.random_decoder_state(torch, np, config,
                                       np.random.default_rng(0))
    e2e, counts = smoke.santacoder_path(torch, np, state, config=config,
                                        device="cpu")
    assert sorted(counts) == ["santacoder", "santacoder_woq8"]
    assert all(set(c.values()) == {0} for c in counts.values())
    for name in counts:
        assert e2e[name]["megakernel"]
        assert e2e[name]["logits_rel_err"] < 5e-2
        assert e2e[name]["logits_rel_err_vs_layer"] < 5e-2
        assert 0.0 <= e2e[name]["equal_tokens_vs_layer"] <= 1.0
        assert e2e[name]["tokens_per_s"] > 0
