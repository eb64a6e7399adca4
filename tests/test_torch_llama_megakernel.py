"""The megakernel's decoder-only modes (LLaMA, GPT-J, GPT-NeoX, GPT-2 and
OPT classes) against the JAX package on the CPU, at d 256.

* the packer bit-equal to the JAX ``pack_decoder_blobs`` with
  ``with_cross=False``: gated (LLaMA), parallel (the input norm's key
  alone), sequential; int8 weight-only, fp32 and bf16 panels;
* the plain megakernel (``plain_fused_decoder_stack``, what the wrapper
  runs on CPU tensors) against the JAX ``fused_decoder_stack`` in
  interpret mode in every new mode at head dim 128 (and 64): RMSNorm,
  SiLU, the gated MLP with ffn 640 (zero-padded to 768), RoPE (GPT-NeoX
  full and partial, GPT-J interleaved partial), the parallel residual,
  ReLU, learned positions, a start index, two attention slices, int8 and
  float panels, an int8 self cache.  fp32, rtol 2e-4 / atol 2e-3 (the JAX
  package's megakernel tolerance, tests/test_megakernel.py:91-93); the
  int8 fresh K/V within one step (RoPE by a matrix product on the JAX
  side, elementwise here);
* a LLaMA decode step through each side's megakernel branch (logits,
  cache), and greedy ``GenerationSession`` at batch 1 through the plain
  megakernel token-exact with the JAX session through its kernel
  (``EWT_MEGAKERNEL=1``, interpret mode) and with the layer-by-layer
  path, float and ``woq8``, and a sampled call (the JAX loop's noise);
* the plan and tiles at LLaMA-1B's widths (bf16 and int8 panels: every
  piece within 64 KB, the shared memory within a block's 227 KB), the
  gated tiles' round trip, the eligibility gate;
* ``_check_modes`` still raising for batch > 1, the K-step tail, int4
  panels, group-wise scales, fp8 self-KV and a gated MLP with
  cross-attention (the grouped MQA/GQA mode is held in
  tests/test_torch_mqa_megakernel.py).
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

RTOL, ATOL = 2e-4, 2e-3
L, D = 2, 256
LLAMA = dict(vocab_size=160, hidden_size=D, num_layers=L, num_heads=2,
             max_position_embeddings=96, position_embedding="rope",
             norm="rmsnorm", norm_eps=1e-6, hidden_act="silu",
             gated_mlp=True, attn_bias=False, mlp_bias=False,
             tie_word_embeddings=False, ffn_hidden_size=640)

# one megakernel mode each: (head dim, packer options, call options,
# rotary dim and style or None, float panels)
MODES = {
    "llama": (128, dict(gated=True), dict(norm="rmsnorm", act="silu",
                                          gated=True), (128, True), True),
    "llama_woq8": (128, dict(gated=True), dict(norm="rmsnorm", act="silu",
                                               gated=True), (128, True),
                   False),
    "gptj": (128, dict(parallel=True), dict(act="gelu", parallel=True),
             (32, False), False),
    "neox": (128, dict(parallel=True), dict(act="gelu", parallel=True),
             (64, True), True),
    "gpt2": (128, {}, dict(act="gelu"), None, False),
    "opt": (64, {}, dict(act="relu"), None, True),
    "gptj_d64": (64, dict(parallel=True), dict(act="gelu", parallel=True),
                 (16, False), False),
}


def _block_state(head_dim, gated, parallel, rs, norm_bias):
    """A stacked float DecoderBlock state (JAX layout), seeded."""
    h = D // head_dim
    st = {"attention.qkv.weight": rs.randn(L, 3, h, head_dim, D) * 0.05,
          "attention.qkv.bias": rs.randn(L, 3, h, head_dim) * 0.05,
          "attention.dense.weight": rs.randn(L, D, D) * 0.05,
          "attention.dense.bias": rs.randn(L, D) * 0.05,
          "mlp.fc.weight": rs.randn(L, 640, D) * 0.05,
          "mlp.fc.bias": rs.randn(L, 640) * 0.05,
          "mlp.proj.weight": rs.randn(L, D, 640) * 0.05,
          "mlp.proj.bias": rs.randn(L, D) * 0.05,
          "input_layernorm.weight": 1 + rs.randn(L, D) * 0.1}
    if gated:
        st["mlp.gate.weight"] = rs.randn(L, 640, D) * 0.05
        st["mlp.gate.bias"] = rs.randn(L, 640) * 0.05
    if not parallel:
        st["post_layernorm.weight"] = 1 + rs.randn(L, D) * 0.1
    if norm_bias:
        st["input_layernorm.bias"] = rs.randn(L, D) * 0.1
        if not parallel:
            st["post_layernorm.bias"] = rs.randn(L, D) * 0.1
    return {k: v.astype(np.float32) for k, v in st.items()}


def _woq8(state):
    """The JAX package's int8 weight-only quantiser on the block's linears
    (``ops/quant_matmul.py``), as the surgery lays it out."""
    from eddie_wang_hackathon2023_tpu.ops.quant_matmul import \
        quantize_weights_int8
    out = dict(state)
    for path in ("attention.qkv", "attention.dense", "mlp.fc", "mlp.gate",
                 "mlp.proj"):
        w = out.pop(path + ".weight", None)
        if w is None:
            continue
        w = w.reshape(L, -1, D) if path.endswith("qkv") else w
        qs, ss = zip(*(quantize_weights_int8(np.ascontiguousarray(m.T))
                       for m in w))
        out[path + ".qweight"] = np.stack(qs)
        out[path + ".per_channel_scale"] = np.stack(ss)
    return out


def _keys(parallel):
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import \
        DECODER_KEYS
    keys = dict(DECODER_KEYS)
    if parallel:
        keys["ln"] = ("input_layernorm",)
    return keys


def _mode_state(mode):
    head_dim, pack, _, _, float_panels = MODES[mode]
    rs = np.random.RandomState(sorted(MODES).index(mode))
    norm_bias = pack.get("gated") is None
    st = _block_state(head_dim, pack.get("gated", False),
                      pack.get("parallel", False), rs, norm_bias)
    if not float_panels:
        st = _woq8(st)
    kw = dict(n_layer=L, hidden=D, n_head=D // head_dim, head_dim=head_dim,
              ffn=640, with_cross=False, gated=pack.get("gated", False),
              keys=_keys(pack.get("parallel", False)))
    return st, kw


# -- the packer ----------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [
    ("llama", "float32"), ("llama", "bfloat16"), ("llama_woq8", "float32"),
    ("gptj", "float32"), ("gpt2", "float32"), ("neox", "bfloat16")])
def test_packer_bit_equal_to_jax(mode, dtype):
    """Every field equal, the zero padding of the ffn (640 -> 768)
    included; bf16: the float state cast to bf16 on both sides (bf16
    panels, unit scales)."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import \
        pack_decoder_blobs as j_pack
    st, kw = _mode_state(mode)
    jst = {k: jnp.asarray(v, dtype if v.dtype == np.float32
                          and k.endswith("weight") else v.dtype)
           for k, v in st.items()}
    pst = {k: (torch.from_numpy(v).to(getattr(torch, dtype))
               if v.dtype == np.float32 and k.endswith("weight")
               else torch.from_numpy(v)) for k, v in st.items()}
    ref = j_pack(jst, **kw)
    out = mk.pack_decoder_blobs(pst, **kw)
    assert out.gscale is None and out.tiles is None
    assert out.wblob.dtype == (torch.int8 if not MODES[mode][4]
                               else getattr(torch, dtype))
    assert out.wblob.shape[1] == (4 + 3 * 3 if kw["gated"] else 4 + 2 * 3)
    for name in mk.MegakernelBlobs._fields[:8]:       # wblob .. kv_qo
        r = np.asarray(getattr(ref, name)).astype(np.float32)
        t = getattr(out, name).float().numpy()
        assert t.shape == r.shape, name
        np.testing.assert_array_equal(t, r, err_msg=name)
    assert mk.blob_layout(out) == (False, kw["gated"], 3)


# -- the plain megakernel against the JAX kernel --------------------------------

def _against_jax(mode, s_self, seq, start, self_int8=False, self_fp8=False):
    """(hidden, JAX hidden, fresh, JAX fresh) of one step on seeded
    inputs (an e4m3 cache and fresh K/V as float32 values)."""
    from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import (
        fused_decoder_stack as j_fds, make_rope_matrix,
        pack_decoder_blobs as j_pack)
    head_dim, _, call, rot, _ = MODES[mode]
    st, kw = _mode_state(mode)
    h = D // head_dim
    if self_int8 or self_fp8:
        steps = np.asarray([[0.011], [0.013]] if self_int8
                           else [[0.02], [0.025]], np.float32)
        st = {**st, "attention.kv_orig_quant_scale": 1 / steps,
              "attention.kv_quant_orig_scale": steps}
    rs = np.random.RandomState(seq)
    x = rs.randn(1, D).astype(np.float32)
    if self_int8:
        cache = rs.randint(-128, 128, (L, 1, 2, h, head_dim, s_self)).astype(
            np.int8)
    elif self_fp8:
        cache = torch.from_numpy((rs.randn(L, 1, 2, h, head_dim, s_self)
                                  * 30).astype(np.float32)).to(
            torch.float8_e4m3fn).float().numpy()
    else:
        cache = (rs.randn(L, 1, 2, h, head_dim, s_self) * 0.5).astype(
            np.float32)
    widx = seq - 1
    jrope, prope = None, None
    if rot is not None:
        pos = max(widx - start, 0)
        jrope = make_rope_matrix(jnp.asarray(pos), head_dim, rot[0], 10000.0,
                                 rot[1], 128 // head_dim)[None]
        prope = mk.Rotary(widx, rot[0], 10000.0, rot[1])
    jcache = jnp.asarray(cache)
    pcache = torch.from_numpy(cache)
    if self_fp8:
        jcache = jcache.astype(jnp.float8_e4m3fn)
        pcache = pcache.to(torch.float8_e4m3fn)
    hj, fj = j_fds(jnp.asarray(x), j_pack(st, **kw), jcache,
                   jnp.asarray([seq], jnp.int32), head_dim ** -0.5,
                   start_index=jnp.asarray([start], jnp.int32),
                   head_dim=head_dim, rope_mat=jrope, interpret=True, **call)
    mk.reset_launches()
    hp, fp = mk.fused_decoder_stack(
        torch.from_numpy(x), mk.pack_decoder_blobs(st, **kw),
        pcache, torch.tensor([seq], dtype=torch.int32),
        head_dim ** -0.5, start_index=torch.tensor([start],
                                                   dtype=torch.int32),
        head_dim=head_dim, rope=prope, **call)
    assert mk.launches["decoder_megakernel"] == 0       # plain on the CPU
    assert hp.shape == (1, D) and fp.shape == (L, 2, h, head_dim)
    if self_fp8:
        assert fp.dtype == torch.float8_e4m3fn
        return (hp.numpy(), np.asarray(hj), fp.float().numpy(),
                np.asarray(fj.astype(jnp.float32)))
    return hp.numpy(), np.asarray(hj), fp.numpy(), np.asarray(fj)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_matches_jax_kernel(mode):
    """A 160-column cache at sequence 70 with the start index at 4 (a
    60-token prompt bucketed to 64), seeded."""
    hid, hid_j, fresh, fresh_j = _against_jax(mode, 160, 70, 4)
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fresh, fresh_j, rtol=RTOL, atol=ATOL)
    assert np.abs(hid).max() > 0.5


def test_plain_matches_jax_kernel_two_slices():
    """LLaMA over 448 columns at sequence 300: two of the kernel's
    256-column attention slices, start 0."""
    hid, hid_j, fresh, fresh_j = _against_jax("llama", 448, 300, 0)
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fresh, fresh_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["llama_woq8", "gptj"])
def test_plain_matches_jax_kernel_int8_self(mode):
    """An int8 self cache with per-layer steps (``kv8``): the fresh K/V
    within one step (rotated k by a matrix product on the JAX side), nearly
    all equal, the hidden state within the float tolerance."""
    hid, hid_j, fresh, fresh_j = _against_jax(mode, 160, 70, 4,
                                              self_int8=True)
    assert fresh.dtype == fresh_j.dtype == np.int8
    diff = np.abs(fresh.astype(int) - fresh_j.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    assert np.abs(fresh.astype(int)).max() > 64
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)


# -- the model and the session -------------------------------------------------

_MODELS = {}


def _models(woq: bool):
    """(JAX model, port model) of the tiny LLaMA, fp32, seeded weights
    (norm weights 1 + N(0, 0.02), the rest N(0, 0.05)), int8 weight-only
    on both sides with ``woq``; built once a module."""
    if woq in _MODELS:
        return _MODELS[woq]
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderConfig as JConfig
    from eddie_wang_hackathon2023_tpu.models.decoder import \
        DecoderLMHead as JModel
    from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
    from eddie_wang_hackathon2023_tpu.quantization.surgery import \
        weight_only_quantize_state as j_woq
    jm = JModel(JConfig(**LLAMA, dtype="float32"))
    rs = np.random.RandomState(11)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        state[name] = (1 + 0.02 * x if name.endswith("layernorm.weight")
                       or name == "ln_f.weight" else 0.05 * x)
    jstate = state
    if woq:
        jm, jstate = j_woq(jm, state, JQ.use_weight_only())
    jm.load_state_dict({k: jnp.asarray(v) for k, v in jstate.items()})
    pc = DecoderConfig(**LLAMA, dtype="float32", quant_mode=(
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


@pytest.mark.parametrize("woq", [False, True], ids=["float", "woq8"])
@torch.inference_mode()
def test_decoder_step_with_blobs_matches_jax(woq, jax_megakernel):
    """A left-padded prompt (start 3), then two steps through each side's
    megakernel branch: logits and the cache, against JAX and against the
    port's layer-by-layer step."""
    jm, pm = _models(woq)
    assert pm.megakernel_eligible()
    params = jm.state_dict()
    jblobs = jm.megakernel_blobs(params)
    blobs = pm.megakernel_blobs()
    ids = np.asarray([[0, 0, 0, 5, 9, 2, 14, 7]], np.int32)
    start = np.asarray([3], np.int32)
    jl, jc = jm.apply(params, jnp.asarray(ids), jm.new_kv_cache(1, 16), 0,
                      jnp.asarray([8], jnp.int32),
                      attention_start=jnp.asarray(start))
    cache = pm.new_kv_cache(1, 16)
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
def test_greedy_batch_1_through_the_megakernel_token_exact(woq,
                                                           jax_megakernel):
    """A 5-token prompt (bucketed to 8: start 3), 10 new tokens: the port's
    session through the plain megakernel, the JAX session through its
    kernel, and the port's session layer by layer agree token for token;
    the blobs are packed once, and not at batch 2."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    jm, pm = _models(woq)
    mc = dict(vocab_size=160, num_layers=L, num_heads=2, hidden_size=D,
              max_seq_len=96)
    ids = np.asarray([[5, 9, 2, 14, 7]], np.int32)
    lens = np.asarray([5], np.int32)
    sess = GenerationSession(ModelConfig(**mc), pm,
                             SamplingConfig(end_id=-1, pad_id=0),
                             decode_megakernel=True)
    pt, pl, pc = sess.decode(ids, lens, max_new_tokens=10)
    assert sess._mk_blobs is not None
    blobs = sess._mk_blobs
    sess.decode(np.concatenate([ids, ids]), np.concatenate([lens, lens]),
                max_new_tokens=2)
    assert sess._mk_blobs is blobs
    lt, _, lc = GenerationSession(
        ModelConfig(**mc), pm, SamplingConfig(end_id=-1, pad_id=0),
        decode_megakernel=False).decode(ids, lens, max_new_tokens=10)
    jsess = JSession(JMC(**mc), jm, JSampling(end_id=-1, pad_id=0))
    jt, jl, jc = jsess.decode(ids, lens, max_new_tokens=10)
    assert jsess._mk_blobs is not None          # the JAX kernel ran
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pt, lt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pc, lc, rtol=1e-4, atol=1e-4)


def test_long_prompt_batch_1_through_the_megakernel():
    """A 1912-token prompt (bucket 2048: start 136) and 6 new tokens: the
    cache holds 2056 columns, so the self-attention takes 9 slices of 256
    (the 8th and 9th folded before the combine, as the kernel does).  The
    session through the plain megakernel and the same session layer by
    layer agree token for token; cum log-probs within 1e-4."""
    _, pm = _models(False)
    model = DecoderLMHead(DecoderConfig(**{**LLAMA,
                                           "max_position_embeddings": 4096},
                                        dtype="float32"))
    model.load_state_dict(pm.state_dict())
    mc = ModelConfig(vocab_size=160, num_layers=L, num_heads=2,
                     hidden_size=D, max_seq_len=4096)
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 160, (1, 1912)).astype(np.int32)
    lens = np.asarray([1912], np.int32)
    out = {}
    for on in (True, False):
        sess = GenerationSession(mc, model, SamplingConfig(end_id=-1,
                                                           pad_id=0),
                                 decode_megakernel=on)
        out[on] = sess.decode(ids, lens, max_new_tokens=6)
        assert (sess._mk_blobs is not None) == on
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    np.testing.assert_allclose(out[True][2], out[False][2], rtol=1e-4,
                               atol=1e-4)


def test_the_model_takes_the_megakernel_when_given_blobs(monkeypatch):
    """The session decides (one row, no beams, an eligible model); the
    model takes the megakernel whenever it is given blobs at a
    single-token step of batch 1."""
    _, pm = _models(False)
    mc = ModelConfig(vocab_size=160, num_layers=L, num_heads=2,
                     hidden_size=D, max_seq_len=96)
    sess = GenerationSession(mc, pm, SamplingConfig(end_id=-1, pad_id=0),
                             decode_megakernel=True)
    assert sess._megakernel_blobs(2) is None
    blobs = sess._megakernel_blobs(1)
    assert blobs is not None and blobs.wblob.device.type == "cpu"
    calls = []
    real = mk.fused_decoder_stack
    monkeypatch.setattr(mk, "fused_decoder_stack",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        pm(torch.tensor([[3]]), pm.new_kv_cache(1, 8), 0, 1,
           megakernel_blobs=blobs)
    assert calls == [1]


@pytest.mark.parametrize("n", [9, 40])
def test_plain_folds_slices_past_eight(n):
    """Past MAX_SPLITS slices the plain version (as the kernel) folds the
    8th and later ones into one before the combine: the same max, sum and
    P*V as one combine of all of them, within fp32 rounding (rel 1e-6)."""
    g = torch.Generator().manual_seed(n)
    parts = [(torch.randn(4, generator=g) * 3, torch.rand(4, generator=g),
              torch.randn(4, 128, generator=g)) for _ in range(n)]
    parts[2] = (torch.full((4,), -1e30), torch.zeros(4),
                torch.zeros(4, 128))                # a slice all masked
    for got, want in zip(mk._combine(parts), mk._merge(parts)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _jax_noise(seed):
    """The JAX generation loop's noise, one [rows, V] draw a step (``rng,
    sub = split(rng)`` from ``PRNGKey(seed)``), for a port session's
    ``_gumbel``."""
    state = dict(rng=jax.random.PRNGKey(seed))

    def gumbel(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))
    return gumbel


def test_sampled_batch_1_through_the_megakernel_token_exact(jax_megakernel):
    """A sampled call at batch 1 (temperature 0.8, top-k 8, top-p 0.9, a
    repetition penalty) through the plain megakernel, fed the JAX loop's
    noise, token-exact with the JAX session through its kernel; lengths
    exact, cum log-probs within 1e-4."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    jm, pm = _models(False)
    mc = dict(vocab_size=160, num_layers=L, num_heads=2, hidden_size=D,
              max_seq_len=96)
    sc = dict(end_id=-1, pad_id=0, temperature=0.8, top_k=8, top_p=0.9,
              repetition_penalty=1.1)
    ids = np.asarray([[5, 9, 2, 14, 7, 33]], np.int32)
    lens = np.asarray([6], np.int32)
    sess = GenerationSession(ModelConfig(**mc), pm, SamplingConfig(**sc),
                             decode_megakernel=True)
    sess._gumbel = _jax_noise(3)
    pt, pl, pc = sess.decode(ids, lens, max_new_tokens=8, seed=3)
    assert sess._mk_blobs is not None
    jt, jl, jc = JSession(JMC(**mc), jm, JSampling(**sc)).decode(
        ids, lens, max_new_tokens=8, seed=3)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-4)


def test_megakernel_eligibility():
    """LLaMA float and woq8 are eligible; on a card only what the kernel
    takes (bf16, heads of 64 or 128: ``kernel_takes``, which the check
    asks with the weights on a card); GQA at heads of 128 too (the grouped
    mode), not at heads of 64; woq4, d above 2048 and an odd rotary dim
    are not."""
    _, pm = _models(False)
    assert pm.megakernel_eligible()
    assert not mk.kernel_takes(torch.float32, D, 3, 128)
    assert mk.kernel_takes(torch.bfloat16, D, 3, 128)
    assert not mk.kernel_takes(torch.bfloat16, D, 3, 32)
    with torch.device("meta"):
        def model(**kw):
            return DecoderLMHead(DecoderConfig(**{**LLAMA, **kw}))
        assert model(dtype="bfloat16").megakernel_eligible()
        assert not model(quant_mode=QuantMode.use_weight_only(True)
                         ).megakernel_eligible()
        assert model(num_kv_heads=1).megakernel_eligible()
        assert not model(num_heads=4, num_kv_heads=1).megakernel_eligible()
        assert not model(hidden_size=4096, num_heads=32,
                         ffn_hidden_size=11008).megakernel_eligible()
        assert not model(rotary_pct=0.2).megakernel_eligible()  # 25
        assert model(hidden_act="gelu", gated_mlp=False, norm="layernorm",
                     position_embedding="learned").megakernel_eligible()


# -- the plan ------------------------------------------------------------------

def _smem_bytes(plan, d, itemsize):
    """The kernel's dynamic shared memory before the ring
    (``smem_layout``: the residual row, the padded input row, a vector's
    sum each of the largest piece) and the largest piece."""
    vals = 16 // itemsize
    live = [g for g in range(6) if plan["items"][g]]
    vin = max(plan["item_k"][g] for g in live)
    part = max(max(plan["piece_c"][g] * plan["item_k"][g] // vals
                   for g in live), 4 * 256)
    before = -(-(d * 4 + (vin + vin // 32 * 4) * 4 + part * 4) // 128) * 128
    piece = max(plan["piece_c"][g] * plan["item_k"][g] * itemsize
                for g in live)
    return before, piece


@pytest.mark.parametrize("itemsize", [1, 2], ids=["int8", "bf16"])
def test_plan_at_llama_1b(itemsize):
    """d 2048, ffn 5504 padded to 6144 (3 panels), gated, 132 SMs: items of
    at most 48 columns, one wave a stage, no cross stages; every piece of
    whole columns within 64 KB; the ring holds at least two pieces within
    the 227 KB a block may have (4 KB left for static shared memory)."""
    d, nf, sms = 2048, 3, 132
    plan = mk.megakernel_plan(d, nf, sms, with_cross=False, gated=True,
                              itemsize=itemsize)
    assert plan["items"][2] == plan["items"][3] == 0
    assert plan["item_c"] == [47, 16, 0, 0, 47, 16]
    assert max(plan["item_c"]) <= mk.ITEM_MAX_COLS
    for g in (0, 1, 4, 5):
        pc, k = plan["piece_c"][g], plan["item_k"][g]
        assert 1 <= pc <= plan["item_c"][g]
        assert pc * k * itemsize <= mk.PIECE_BYTES
    # the gated fc1 item holds its fc and its gate columns
    per_layer = sum(plan["item_c"][g] * plan["items"][g] * plan["item_k"][g]
                    * (2 if g == 4 else 1) for g in (0, 1, 4, 5))
    assert plan["layer_bytes"] == per_layer * itemsize
    before, piece = _smem_bytes(plan, d, itemsize)
    assert before + 2 * piece <= 227 * 1024 - 4096


@pytest.mark.parametrize("gated,itemsize", [(True, 2), (False, 1)])
def test_decoder_only_tiles_round_trip(gated, itemsize):
    """Each stage read back from the tiles is the stage's weight from the
    panels (q | k | v; fc1's and, gated, the gate's panels side by side;
    fc2's stacked along K), zeros in the padding columns."""
    nf, d, sms = 3, 128, 100
    rs = np.random.RandomState(1)
    npan = 4 + (3 if gated else 2) * nf
    w = torch.from_numpy(rs.randint(-127, 128, (L, npan, d, d)).astype(
        np.int8))
    if itemsize == 2:
        w = w.bfloat16()
    nflat = 2 + (2 if gated else 1) * nf
    blobs = mk.MegakernelBlobs(w, torch.zeros(L, 3, 1, 128),
                               torch.zeros(L, 3, 1, 128),
                               torch.zeros(L, nflat, d),
                               torch.zeros(L, nflat, d), torch.zeros(L, 4, d),
                               torch.ones(L), torch.ones(L))
    assert mk.blob_layout(blobs) == (False, gated, nf)
    tiled = mk.megakernel_tiles(blobs, sms=sms)
    plan = mk.megakernel_plan(d, nf, sms, False, gated, itemsize)
    assert tiled.tiles.dtype == w.dtype
    assert tiled.tiles.shape == (L, plan["layer_bytes"] // itemsize)
    pan = mk._panels(nf, False, gated)

    def side(p0):
        return torch.cat([w[:, p0 + j] for j in range(nf)], dim=2)
    want = {0: [torch.cat([w[:, 0], w[:, 1], w[:, 2]], dim=2)],
            1: [w[:, 3]], 4: [side(pan["fc1"])] + (
                [side(pan["gate"])] if gated else []),
            5: [torch.cat([w[:, pan["fc2"] + j] for j in range(nf)], dim=1)]}
    for g, refs in want.items():
        for mat, ref in enumerate(refs):
            got = mk.untile(tiled.tiles, plan, g, mat, gated)
            cols = ref.shape[2]
            assert torch.equal(got[..., :cols], ref), (g, mat)
            assert not got[..., cols:].any()


@pytest.mark.parametrize("mode", ["llama_woq8", "gptj"])
def test_plain_matches_jax_kernel_fp8_self(mode):
    """An e4m3 self cache with per-layer scales (the JAX kernel's
    ``self_fp8``): the fresh K/V within one e4m3 step of JAX's (the
    rotated k by a matrix product on the JAX side), nearly all equal, the
    hidden state within the float tolerance."""
    hid, hid_j, fresh, fresh_j = _against_jax(mode, 160, 70, 4,
                                              self_fp8=True)
    assert np.isfinite(fresh).all() and np.abs(fresh).max() > 32
    close = np.abs(fresh - fresh_j) <= np.abs(fresh_j) / 8
    assert close.all() and (fresh == fresh_j).mean() > 0.99
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)


# -- what stays refused ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["batch2", "tail", "int4_panels",
                                  "group_scales", "gated_cross"])
def test_modes_still_outside_the_port_raise(mode):
    st, kw = _mode_state("llama")
    blobs = mk.pack_decoder_blobs(st, **kw)
    x = torch.zeros(1, D)
    cache = torch.zeros(L, 1, 2, 2, 128, 16)
    seq = torch.tensor([3], dtype=torch.int32)
    call = dict(head_dim=128, norm="rmsnorm", act="silu", gated=True)
    if mode == "batch2":
        x, cache = torch.zeros(2, D), torch.zeros(L, 2, 2, 2, 128, 16)
    elif mode == "tail":
        call["tail_kv"] = (torch.zeros(4, L, 1, 2, 2, 128), 0)
    elif mode == "int4_panels":
        blobs = blobs._replace(wblob=blobs.wblob[:, :, :D // 2])
    elif mode == "group_scales":
        blobs = blobs._replace(gscale=torch.ones(L, 13, 2, D))
    elif mode == "gated_cross":
        call["cross_cache"] = torch.zeros(L, 1, 2, 2, 128, 16)
    with pytest.raises(NotImplementedError):
        mk.fused_decoder_stack(x, blobs, cache, seq, 0.1, **call)


def test_blobs_of_another_mode_raise():
    """Gated blobs called without ``gated``, and plain blobs with it."""
    st, kw = _mode_state("llama")
    blobs = mk.pack_decoder_blobs(st, **kw)
    x, cache = torch.zeros(1, D), torch.zeros(L, 1, 2, 2, 128, 16)
    seq = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.fused_decoder_stack(x, blobs, cache, seq, 0.1, head_dim=128,
                               norm="rmsnorm", act="silu")
    st, kw = _mode_state("gpt2")
    with pytest.raises(ValueError):
        mk.fused_decoder_stack(x, mk.pack_decoder_blobs(st, **kw), cache,
                               seq, 0.1, head_dim=128, gated=True)


# -- chip_smoke.py's llama paths, rehearsed ------------------------------------

@pytest.fixture
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_llama_path_on_cpu(one_cpu_thread):
    """``chip_smoke.llama_path`` at 2 layers of width 256 (LLaMA-1B's head
    dim 128, ffn 688, vocab 97), bf16 as on the card: the random models
    (float and woq8) build on the device from a generator, batch 1 through
    the megakernel's plain version and batch 8 layer by layer generate 20
    tokens for prompts of 60, no kernel is launched from CPU tensors, the
    teacher-forced replays agree, and the megakernel beside the
    layer-by-layer session is reported."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = dataclasses.replace(
        smoke.llama_1b_config(), vocab_size=97, hidden_size=256,
        num_layers=2, num_heads=2, num_kv_heads=2, ffn_hidden_size=688,
        max_position_embeddings=128)
    e2e, counts = smoke.llama_path(torch, np, config=config, device="cpu")
    assert sorted(counts) == ["llama", "llama_b8", "llama_fp8",
                              "llama_woq8"]
    assert e2e["llama_fp8"]["megakernel"]
    assert all(set(c.values()) == {0} for c in counts.values())
    assert e2e["llama"]["megakernel"] and e2e["llama_woq8"]["megakernel"]
    assert not e2e["llama_b8"]["megakernel"]
    for name in counts:
        assert e2e[name]["logits_rel_err"] < 5e-2
        assert e2e[name]["tokens_per_s"] > 0
    assert e2e["llama_b8"]["logits_rel_err"] == 0.0
    assert 0.0 <= e2e["llama"]["equal_tokens_vs_layer"] <= 1.0
    assert e2e["llama"]["logits_rel_err_vs_layer"] < 5e-2
