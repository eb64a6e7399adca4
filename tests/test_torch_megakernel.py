"""The port's whole-step decode megakernel path against the JAX package's,
on the CPU: the packed weight image, the plain version of the kernel
against the JAX kernel (interpret mode), the decoder with the image, and
the greedy pipeline with ``decode_megakernel=True``.  Plus the SmoothQuant
QKV projection of the encoder, which emits fp32 q/k/v in both packages.

Tolerances: fp32 on both sides; rtol 2e-4 / atol 2e-3 for the kernel and
the decoder step, the tolerance the JAX package's own megakernel tests
use (tests/test_megakernel.py:91-93); greedy tokens must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JConfig,
    WhisperDecoder as JDecoder, WhisperEncoder as JEncoder)
from eddie_wang_hackathon2023_tpu.models.whisper.model import (
    quantize_lm_head_state as j_quantize_lm_head_state)
from eddie_wang_hackathon2023_tpu.models.whisper.pipeline import (
    DecodingOptions as JOptions, WhisperPipeline as JPipeline)
from eddie_wang_hackathon2023_tpu.module import Module as JModule
from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import (
    fused_decoder_stack as j_fused_decoder_stack,
    pack_decoder_blobs as j_pack_decoder_blobs)
from eddie_wang_hackathon2023_tpu.plugin import plugin_config
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQuantMode
from eddie_wang_hackathon2023_tpu.quantization.surgery import (
    smooth_quantize as j_smooth_quantize,
    smooth_quantize_state_dict as j_smooth_quantize_state_dict,
    weight_only_quantize_state as j_weight_only_quantize_state)
from eddie_wang_hackathon2023_tpu_torch.layers.attention import (
    linear_classes)
from eddie_wang_hackathon2023_tpu_torch.models._state import unstack_blocks
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    BENCH_RECIPE, WhisperConfig, from_jax_state)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import (
    CrossAttnKV, WhisperDecoder, WhisperEncoder)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import (
    calibrate_cross_kv_scales)
from eddie_wang_hackathon2023_tpu_torch.quantization.mode import QuantMode

# the JAX package's megakernel test configuration
# (tests/test_megakernel.py:22-25): d 256, 4 heads of 64, 3 layers
DIMS = dict(n_mels=16, n_vocab=160, n_audio_ctx=160, n_audio_state=256,
            n_audio_head=4, n_audio_layer=2, n_text_ctx=160,
            n_text_state=256, n_text_head=4, n_text_layer=3,
            dtype="float32")
JCFG, PCFG = JConfig(**DIMS), WhisperConfig(**DIMS)
L, D, H, HD = 3, 256, 4, 64
SCALE = HD ** -0.5
RTOL, ATOL = 2e-4, 2e-3


def _jax_decoder():
    """A JAX decoder with int8 weight-only blocks, and its numpy state."""
    import jax
    qm = JQuantMode.use_weight_only()
    dec = JDecoder(JCFG, qm)
    dec.random_init(jax.random.PRNGKey(3), 0.05)
    sd = dec.state_dict()
    dec2 = JDecoder(JCFG, qm)
    dec2, sd = j_weight_only_quantize_state(dec2, sd, qm)
    dec2.load_state_dict(sd, strict=False)
    return dec2, {k: np.asarray(v) for k, v in sd.items()}


JDEC, DEC_SD = _jax_decoder()
BLOCK_STATE = {k[len("blocks."):]: v for k, v in DEC_SD.items()
               if k.startswith("blocks.")}
PACK_KW = dict(n_layer=L, hidden=D, n_head=H, head_dim=HD, ffn=4 * D,
               with_cross=True)


def _port_decoder():
    with torch.device("cpu"):
        dec = WhisperDecoder(PCFG, QuantMode.use_weight_only())
    dec.load_state_dict(unstack_blocks(DEC_SD))
    return dec.eval()


def _cross(int8: bool):
    """numpy cross cache [L,1,2,H,D,S] (int8 with per-layer scales)."""
    rs = np.random.RandomState(5)
    kv = rs.randn(L, 1, 2, H, HD, DIMS["n_audio_ctx"]).astype(np.float32) \
        * 0.4
    if not int8:
        return kv, None
    scales = (np.abs(kv).reshape(L, -1).max(1) / 127.0).astype(np.float32)
    q = np.clip(np.round(kv / scales[:, None, None, None, None, None]),
                -127, 127).astype(np.int8)
    return q, scales


def _j_cross(cross, scales):
    return jnp.asarray(cross) if scales is None else (jnp.asarray(cross),
                                                      jnp.asarray(scales))


def _p_cross(cross, scales):
    return (torch.from_numpy(cross) if scales is None
            else (torch.from_numpy(cross), torch.from_numpy(scales)))


def test_blobs_bit_equal_to_jax_packer():
    ref = j_pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    out = mk.pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    own = _port_decoder().megakernel_blobs()
    assert ref.gscale is None and out.gscale is None and own.gscale is None
    for name in mk.MegakernelBlobs._fields[:-1]:
        r = np.asarray(getattr(ref, name))
        for blobs in (out, own):
            t = getattr(blobs, name).numpy()
            assert t.dtype == r.dtype and t.shape == r.shape, name
            np.testing.assert_array_equal(t, r, err_msg=name)


@pytest.mark.parametrize("int8_cross", [False, True])
@pytest.mark.parametrize("s_self,seq", [(160, 1), (160, 5), (160, 130),
                                        (448, 300)])
def test_plain_matches_jax_kernel(int8_cross, s_self, seq):
    """seq 130: one past the 128-column self chunk; seq 300 on a 448-column
    cache: two of the port's 256-column attention slices."""
    rs = np.random.RandomState(seq)
    x = rs.randn(1, D).astype(np.float32)
    cache = (rs.randn(L, 1, 2, H, HD, s_self) * 0.5).astype(np.float32)
    cross, scales = _cross(int8_cross)
    jblobs = j_pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    hid_j, fresh_j = j_fused_decoder_stack(
        jnp.asarray(x), jblobs, jnp.asarray(cache),
        jnp.asarray([seq], jnp.int32), SCALE, cross_cache=jnp.asarray(cross),
        cross_scale=None if scales is None else jnp.asarray(scales),
        head_dim=HD)
    blobs = mk.pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    mk.reset_launches()
    hid, fresh = mk.fused_decoder_stack(
        torch.from_numpy(x), blobs, torch.from_numpy(cache),
        torch.tensor([seq], dtype=torch.int32), SCALE,
        cross_cache=torch.from_numpy(cross),
        cross_scale=None if scales is None else torch.from_numpy(scales),
        head_dim=HD)
    assert mk.launches["decoder_megakernel"] == 0    # plain on the CPU
    assert hid.shape == (1, D) and fresh.shape == (L, 2, H, HD)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(fresh.numpy(), np.asarray(fresh_j),
                               rtol=RTOL, atol=ATOL)


def _prefill_both(pdec, prompt, cross, scales):
    plen = len(prompt)
    jcache = JDEC.new_kv_cache(1)
    jl, jcache = JDEC(jnp.asarray([prompt], jnp.int32), jcache,
                      _j_cross(cross, scales), 0,
                      jnp.asarray([plen], jnp.int32))
    pcache = pdec.new_kv_cache(1)
    pl_, pcache = pdec(torch.tensor([prompt]), pcache,
                       _p_cross(cross, scales), 0, plen)
    return jl, jcache, pl_, pcache


@torch.inference_mode()
def test_decoder_with_blobs_matches_jax():
    """One step through each side's megakernel branch (logits and cache),
    then five greedy steps token for token."""
    pdec = _port_decoder()
    pblobs = pdec.megakernel_blobs()
    jblobs = j_pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    cross, scales = _cross(True)
    prompt = [3, 7, 11, 2, 9]
    plen = len(prompt)
    jl, jcache, pl_, pcache = _prefill_both(pdec, prompt, cross, scales)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    assert tok == int(pl_[0, -1].argmax())
    with plugin_config(decode_megakernel=True):
        jl, jcache = JDEC(jnp.asarray([[tok]], jnp.int32), jcache,
                          _j_cross(cross, scales), plen,
                          jnp.asarray([plen + 1], jnp.int32),
                          megakernel_blobs=jblobs)
        pl_, pcache = pdec(torch.tensor([[tok]]), pcache,
                           _p_cross(cross, scales), plen, plen + 1,
                           megakernel_blobs=pblobs)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pcache.numpy(), np.asarray(jcache),
                                   rtol=RTOL, atol=ATOL)
        jtoks, ptoks = [], []
        jt = pt = int(np.argmax(np.asarray(jl)[0, -1]))
        for i in range(1, 6):
            pos = plen + i
            jl, jcache = JDEC(jnp.asarray([[jt]], jnp.int32), jcache,
                              _j_cross(cross, scales), pos,
                              jnp.asarray([pos + 1], jnp.int32),
                              megakernel_blobs=jblobs)
            pl_, pcache = pdec(torch.tensor([[pt]]), pcache,
                               _p_cross(cross, scales), pos, pos + 1,
                               megakernel_blobs=pblobs)
            jt = int(np.argmax(np.asarray(jl)[0, -1]))
            pt = int(pl_[0, -1].argmax())
            jtoks.append(jt)
            ptoks.append(pt)
    assert ptoks == jtoks


# the pipeline: a Whisper of d 128 with heads of 64 (megakernel-eligible)
PIPE_DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=150,
                 n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                 n_text_ctx=48, n_text_state=128, n_text_head=2,
                 n_text_layer=2, dtype="float32")
SAMPLE_LEN = 12


def _random_state(module, rs, scale=0.05):
    return {n: (rs.standard_normal(p._shape) * scale).astype(np.float32)
            for n, p in module.named_parameters()}


def test_pipeline_decode_megakernel_token_exact():
    """``WhisperPipeline(..., decode_megakernel=True)`` with the bench
    recipe against the JAX pipeline with its megakernel, and against the
    port's own layer-by-layer path."""
    jcfg, pcfg = JConfig(**PIPE_DIMS), WhisperConfig(**PIPE_DIMS)
    enc_sd, dec_sd, ckv_sd = (
        _random_state(m, np.random.RandomState(seed)) for m, seed in
        ((JEncoder(jcfg), 0), (JDecoder(jcfg), 1), (JCrossAttnKV(jcfg), 2)))
    mel = (np.random.RandomState(7).randn(1, 80, 300).astype(np.float32))
    qm = JQuantMode.use_weight_only()
    sq = JQuantMode.use_smooth_quant(per_token=True, per_channel=True)
    enc = j_smooth_quantize(JEncoder(jcfg, JQuantMode(0)), sq)
    enc_sd = j_smooth_quantize_state_dict(enc, enc_sd, sq)
    dec, dec_sd = j_weight_only_quantize_state(
        JDecoder(jcfg, qm, quantize_lm_head=True), dec_sd, qm)
    dec_sd = j_quantize_lm_head_state(dec_sd)
    enc.load_state_dict(enc_sd, strict=False)
    ckv_sd["kv_scale"] = calibrate_cross_kv_scales(
        ckv_sd, [np.array(enc(mel))], device="cpu")
    dec.load_state_dict(dec_sd, strict=False)
    ckv = JCrossAttnKV(jcfg, int8_output=True, static_scale=True)
    ckv.load_state_dict(ckv_sd)
    assert dec.megakernel_eligible()
    jpipe = JPipeline(jcfg, enc, dec, ckv,
                      JOptions(language="en", sample_len=SAMPLE_LEN), qm)
    jpipe.bind_params()
    with plugin_config(decode_megakernel=True):
        assert jpipe._megakernel_blobs() is not None
        ref = jpipe.transcribe(mel)[0]

    mods = from_jax_state(enc_sd, dec_sd, ckv_sd, pcfg, recipe=BENCH_RECIPE,
                          device="cpu")
    opts = DecodingOptions(language="en", sample_len=SAMPLE_LEN)
    pipe = WhisperPipeline(pcfg, *mods, opts, decode_megakernel=True)
    assert pipe._megakernel_blobs() is not None
    out = pipe.transcribe(mel)[0]
    scanned = WhisperPipeline(pcfg, *mods, opts)    # default: off on the CPU
    assert scanned._megakernel_blobs() is None
    oracle = scanned.transcribe(mel)[0]
    want = [int(t) for t in ref.tokens]
    assert len(want) > 1
    assert out.tokens == want and oracle.tokens == want
    assert out.text == ref.text
    assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3


@pytest.mark.parametrize("dtype,on_card", [("float32", False),
                                           ("bfloat16", True)])
def test_megakernel_gate_follows_the_kernel_types(monkeypatch, dtype,
                                                  on_card):
    """The CUDA kernel takes bf16 activations and caches only: on a card
    an fp32 model keeps the layer-by-layer path.  On the CPU the plain
    version takes either."""
    cfg = WhisperConfig(**{**PIPE_DIMS, "dtype": dtype})
    with torch.device("cpu"):
        enc = WhisperEncoder(cfg)
        dec = WhisperDecoder(cfg, QuantMode.use_weight_only())
        ckv = CrossAttnKV(cfg, int8_output=True)
    assert dec.megakernel_eligible()
    assert dec.megakernel_eligible(torch.device("cuda")) == on_card
    pipe = WhisperPipeline(cfg, enc, dec, ckv,
                           DecodingOptions(language="en"),
                           decode_megakernel=True)
    assert pipe._megakernel_blobs() is not None
    pipe._mk_blobs = None
    monkeypatch.setattr(pipe, "device", torch.device("cuda"))
    assert (pipe._megakernel_blobs() is not None) == on_card


def _mode_call(mode):
    """A fused_decoder_stack call in a mode outside the port."""
    blobs = mk.pack_decoder_blobs(BLOCK_STATE, **PACK_KW)
    x = torch.zeros(1, D)
    cache = torch.zeros(L, 1, 2, H, HD, 16)
    cross = torch.zeros(L, 1, 2, H, HD, 16)
    seq = torch.tensor([3], dtype=torch.int32)
    kw = dict(cross_cache=cross, head_dim=HD)
    if mode == "batch2":
        x, cache = torch.zeros(2, D), torch.zeros(L, 2, 2, H, HD, 16)
        kw["cross_cache"] = torch.zeros(L, 2, 2, H, HD, 16)
    elif mode == "tail":
        kw["tail_kv"] = (torch.zeros(4, L, 1, 2, H, HD), 0)
    elif mode == "start_index":
        kw["start_index"] = torch.zeros(1, dtype=torch.int32)
    elif mode == "rope":
        kw["rope_mat"] = torch.eye(128)
    elif mode in ("gated", "parallel"):
        kw[mode] = True
    elif mode == "rmsnorm":
        kw["norm"] = "rmsnorm"
    elif mode == "silu":
        kw["act"] = "silu"
    elif mode == "int8_self_kv":
        cache = cache.to(torch.int8)
    elif mode == "gqa":
        cache = torch.zeros(L, 1, 2, 1, HD, 16)
    elif mode == "no_cross":
        kw["cross_cache"] = None
    elif mode == "float_panels":
        blobs = blobs._replace(wblob=blobs.wblob.float())
    elif mode == "int4_panels":
        blobs = blobs._replace(wblob=blobs.wblob[:, :, :D // 2])
    mk.fused_decoder_stack(x, blobs, cache, seq, SCALE, **kw)


@pytest.mark.parametrize("mode", ["batch2", "tail", "start_index", "rope",
                                  "gated", "parallel", "rmsnorm", "silu",
                                  "int8_self_kv", "gqa", "no_cross",
                                  "float_panels", "int4_panels"])
def test_modes_outside_the_port_raise(mode):
    with pytest.raises(NotImplementedError):
        _mode_call(mode)


def test_packer_refuses_float_state():
    float_state = {k.replace(".qweight", ".weight"): v
                   for k, v in BLOCK_STATE.items()}
    with pytest.raises(NotImplementedError):
        mk.pack_decoder_blobs(float_state, **PACK_KW)


class _JQKVHolder(JModule):
    def __init__(self, hidden, heads, head_dim):
        super().__init__()
        from eddie_wang_hackathon2023_tpu.layers.attention import QKVLinear
        self.qkv = QKVLinear(hidden, heads, heads, head_dim, dtype="bfloat16")


@torch.inference_mode()
def test_smoothquant_qkv_emits_fp32_like_jax():
    """In a bf16 model the SmoothQuant QKV projection returns fp32 q/k/v
    with the bias added in fp32, in both packages (the JAX surgery builds
    it with dtype None)."""
    hidden, heads, hd = 128, 2, 64
    rs = np.random.RandomState(11)
    state = {"qkv.weight": (rs.randn(3, heads, hd, hidden) * 0.05)
             .astype(np.float32),
             "qkv.bias": (rs.randn(3, heads, hd) * 0.05).astype(np.float32)}
    sq = JQuantMode.use_smooth_quant(per_token=True, per_channel=True)
    jmod = j_smooth_quantize(_JQKVHolder(hidden, heads, hd), sq)
    qstate = j_smooth_quantize_state_dict(jmod, state, sq)
    jmod.load_state_dict(qstate, strict=False)
    x = rs.randn(1, 5, hidden).astype(np.float32)
    ref = jmod.qkv(jnp.asarray(x, jnp.bfloat16))

    pmode = QuantMode.use_smooth_quant(per_token=True, per_channel=True)
    qkv_cls = linear_classes(pmode, torch.bfloat16)[0]
    pmod = qkv_cls(hidden, heads, hd, bias=True, dtype=torch.bfloat16)
    pmod.load_state_dict({k[len("qkv."):]: torch.from_numpy(np.asarray(v))
                          for k, v in qstate.items()
                          if k.startswith("qkv.")})
    out = pmod(torch.from_numpy(x).to(torch.bfloat16))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)
