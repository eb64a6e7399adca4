"""Whisper with int4 weights (``woq4``) and the megakernel's int4 and float
panels, against the JAX package, on the CPU: the recipe and the int4
surgery bit for bit, the packer (int4 per channel, float with
cross-attention) bit for bit, the int4 tiles, the plain megakernel against
the JAX kernel in interpret mode (int4 in groups of 128 and per channel,
int4 over an int8 self cache, float panels with float and int8 cross
caches), one decoder step with the image against the JAX decoder's
scanned step, the greedy ``woq4`` and float pipelines at batch 1 through
the megakernel token-exact with the JAX pipeline, the gate (the
Whisper-tiny width and decoder-only int4 stay layer by layer), that no
fp32 row reaches the int4 kernel on a bf16 Whisper, and CPU rehearsals of
``chip_smoke.py``'s woq4, float and woq4_scanned paths.

Tolerances: fp32 on both sides; rtol 2e-4 / atol 2e-3 for the kernel and
the decoder step (the JAX package's, tests/test_megakernel.py:91-93);
greedy tokens exact.  The JAX megakernel runs in interpret mode, seconds a
call, so its calls are few."""
import dataclasses
import importlib.util
import os

import jax
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
from eddie_wang_hackathon2023_tpu.ops.pallas_decoder_layer import (
    fused_decoder_stack as j_fused_decoder_stack,
    pack_decoder_blobs as j_pack_decoder_blobs)
from eddie_wang_hackathon2023_tpu.plugin import plugin_config
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQuantMode
from eddie_wang_hackathon2023_tpu.quantization.surgery import (
    smooth_quantize as j_smooth_quantize,
    smooth_quantize_state_dict as j_smooth_quantize_state_dict,
    weight_only_quantize as j_weight_only_quantize,
    weight_only_quantize_state as j_weight_only_quantize_state)
from eddie_wang_hackathon2023_tpu_torch.models._state import unstack_blocks
from eddie_wang_hackathon2023_tpu_torch.models.decoder import (
    DecoderConfig, DecoderLMHead)
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    Recipe, WhisperConfig, from_jax_state, quantize_states)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import (
    DECODER_LINEARS, ENCODER_LINEARS, WhisperDecoder)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import unpack_int4
from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import (
    calibrate_cross_kv_scales)
from eddie_wang_hackathon2023_tpu_torch.quantization.mode import QuantMode

# the JAX package's megakernel test configuration: d 256, 4 heads of 64, 3
# layers (int4 groups of 128 divide d/2 = 128: 2 a panel)
DIMS = dict(n_mels=16, n_vocab=160, n_audio_ctx=160, n_audio_state=256,
            n_audio_head=4, n_audio_layer=2, n_text_ctx=160,
            n_text_state=256, n_text_head=4, n_text_layer=3,
            dtype="float32")
JCFG, PCFG = JConfig(**DIMS), WhisperConfig(**DIMS)
L, D, H, HD = 3, 256, 4, 64
SCALE = HD ** -0.5
RTOL, ATOL = 2e-4, 2e-3
PACK_KW = dict(n_layer=L, hidden=D, n_head=H, head_dim=HD, ffn=4 * D,
               with_cross=True)
WOQ4 = JQuantMode.use_weight_only(use_int4_weights=True)


def _blocks(sd):
    return {k[len("blocks."):]: np.asarray(v) for k, v in sd.items()
            if k.startswith("blocks.")}


def _float_decoder_state():
    dec = JDecoder(JCFG)
    dec.random_init(jax.random.PRNGKey(3), 0.05)
    return {k: np.asarray(v) for k, v in dec.state_dict().items()}


FLOAT_SD = _float_decoder_state()


def _jax_int4(group):
    """The JAX decoder quantised int4 by its surgery with ``group`` rows a
    scale group (0: per channel), and its numpy state."""
    with plugin_config(int4_group_size=group):
        dec, sd = j_weight_only_quantize_state(JDecoder(JCFG, WOQ4),
                                               dict(FLOAT_SD), WOQ4)
    dec.load_state_dict(sd, strict=False)
    return dec, {k: np.asarray(v) for k, v in sd.items()}


JDEC4, SD4 = _jax_int4(128)
_, SD4_PC = _jax_int4(0)
STATES = {"int4_g128": _blocks(SD4), "int4_pc": _blocks(SD4_PC),
          "float": _blocks(FLOAT_SD)}
# per-layer self-KV dequantise steps of an int8 self cache
KV_STEP = np.asarray([[0.0021], [0.0034], [0.0027]], np.float32)


def _port_decoder(sd, mode):
    with torch.device("cpu"):
        dec = WhisperDecoder(PCFG, mode)
    dec.load_state_dict(unstack_blocks(sd))
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


# -- the recipe and the int4 surgery -----------------------------------------

def test_recipe_takes_woq4_as_bench_py():
    """``woq4`` gives int4 weight-only decoders (and encoders unless
    ``sqenc``), winning over ``woq8``, as ``bench.py:73-74`` builds them."""
    sq = QuantMode.use_smooth_quant(per_token=True, per_channel=True)
    int4 = QuantMode.use_weight_only(True)
    assert int(int4) == int(WOQ4)
    r = Recipe.parse("woq4+ckv8+lmq8+sqenc")
    assert (r.decoder, r.encoder, r.lm_head, r.ckv8) == (int4, sq, True,
                                                         True)
    for recipe in ("woq4", "woq4+woq8"):
        r = Recipe.parse(recipe)
        assert r.decoder == r.encoder == int4 and not r.lm_head
    r = Recipe.parse("woq4+kv8+ckv8")
    assert r.decoder == int4.set_int8_kv_cache() and r.encoder == int4
    assert Recipe.parse("woq8").decoder == QuantMode.use_weight_only()
    assert Recipe.parse("ckv8+lmq8+sqenc").decoder == QuantMode(0)
    with pytest.raises(NotImplementedError):
        Recipe.parse("woq4+fp8")


def test_int4_surgery_bit_equal_to_jax():
    """``quantize_states`` under ``woq4`` gives the JAX surgery's int4
    state bit for bit: ``qweight`` [in/2, out] in the half-split order and
    group scales [in/G, out] (G 128 where it divides the in-features), the
    decoder's and (no ``sqenc``) the encoder's."""
    enc = JEncoder(JCFG)
    enc.random_init(jax.random.PRNGKey(4), 0.05)
    enc_sd = {k: np.asarray(v) for k, v in enc.state_dict().items()}
    _, jenc = j_weight_only_quantize_state(JEncoder(JCFG, WOQ4),
                                           dict(enc_sd), WOQ4)
    penc, pdec, _ = quantize_states(enc_sd, FLOAT_SD, {}, "woq4")
    for ref, out, paths in ((jenc, penc, ENCODER_LINEARS),
                            (SD4, pdec, DECODER_LINEARS)):
        for path in paths:
            for key in (path + ".qweight", path + ".per_channel_scale"):
                r, t = np.asarray(ref[key]), np.asarray(out[key])
                assert t.dtype == r.dtype and t.shape == r.shape, key
                np.testing.assert_array_equal(t, r, err_msg=key)
    assert pdec["blocks.attn.qkv.qweight"].shape == (L, D // 2, 3 * D)
    assert pdec["blocks.attn.qkv.per_channel_scale"].shape == (L, 2, 3 * D)
    assert pdec["blocks.mlp2.per_channel_scale"].shape == (L, 8, D)


# -- the packer and the tiles --------------------------------------------------

@pytest.mark.parametrize("kind", ["int4_g128", "int4_pc", "float"])
def test_packer_bit_equal_to_jax(kind):
    """The int4 (per-panel half-split nibbles; group scales [L, NPAN, NG,
    d] with unit pair and flat scales, or per-channel scales on them) and
    the float blobs with cross-attention equal the JAX packer's bit for
    bit, and so do the port decoder's own (int4 in groups of 128, as the
    port builds it, and float)."""
    state = STATES[kind]
    ref = j_pack_decoder_blobs(state, **PACK_KW)
    outs = [mk.pack_decoder_blobs(state, **PACK_KW)]
    if kind != "int4_pc":
        sd = SD4 if kind == "int4_g128" else FLOAT_SD
        mode = (QuantMode.use_weight_only(True) if kind == "int4_g128"
                else QuantMode(0))
        outs.append(_port_decoder(sd, mode).megakernel_blobs())
    for out in outs:
        for name in mk.MegakernelBlobs._fields[:9]:
            r = getattr(ref, name)
            if r is None:
                assert getattr(out, name) is None, name
                continue
            r, t = np.asarray(r), getattr(out, name).numpy()
            assert t.dtype == r.dtype and t.shape == r.shape, name
            np.testing.assert_array_equal(t, r, err_msg=name)
        assert mk.blob_int4(out) == {"int4_g128": 2, "int4_pc": 0,
                                     "float": None}[kind]


@pytest.mark.parametrize("kind", ["int4_g128", "int4_pc"])
@pytest.mark.parametrize("sms", [132, 16])
def test_int4_tiles_round_trip(kind, sms):
    """Each stage read back from the int4 tiles is the stage's weight
    composed from the unpacked panels (q | k | v, the fc1 panels side by
    side, the fc2 panels stacked along K), with zeros in the padding
    columns, and its group scales in bf16 composed as the panels; a GEMV
    through the tiles equals one through the panels (bf16 weights, exact
    fp64 sums)."""
    blobs = mk.pack_decoder_blobs(STATES[kind], **PACK_KW)
    groups = mk.blob_int4(blobs)
    tiled = mk.megakernel_tiles(blobs, sms=sms)
    plan = mk.megakernel_plan(D, 4, sms, int4=groups)
    assert tiled.tiles.dtype == torch.int8
    assert tuple(tiled.tiles.shape) == (L, plan["layer_bytes"])
    assert plan["piece_c"] == plan["item_c"]
    w = unpack_int4(blobs.wblob)

    def compose(t):
        return [torch.cat([t[:, 0], t[:, 1], t[:, 2]], dim=2), t[:, 3],
                t[:, 4], t[:, 5], torch.cat([t[:, 6 + j] for j in range(4)],
                                            dim=2),
                torch.cat([t[:, 10 + j] for j in range(4)], dim=1)]
    gs = compose(blobs.gscale) if groups else [None] * 6
    rs = np.random.RandomState(2)
    for g, (ref, ref_gs) in enumerate(zip(compose(w), gs)):
        q, sc = mk.untile(tiled.tiles, plan, g, int4=groups)
        k, cols = ref.shape[1:]
        assert torch.equal(q[..., :cols], ref), mk.GEMV_STAGES[g]
        assert not q[..., cols:].any()
        if groups:
            assert torch.equal(sc[..., :cols], ref_gs.bfloat16())
        else:
            assert sc is None
        v = torch.from_numpy(rs.randn(1, k).astype(np.float32)).bfloat16()
        for layer in range(L):
            def weight(qq, ss):
                if ss is None:
                    return qq.double()
                rows = qq.shape[0] // ss.shape[0]
                return (qq.bfloat16() * ss.bfloat16().repeat_interleave(
                    rows, 0)).double()
            got = v.double() @ weight(q[layer, :, :cols],
                                      None if sc is None
                                      else sc[layer, :, :cols])
            want = v.double() @ weight(ref[layer], None if ref_gs is None
                                       else ref_gs[layer])
            assert torch.equal(got, want)


# -- the plain megakernel against the JAX kernel -----------------------------

@pytest.mark.parametrize("kind,int8_cross,self_int8,s_self,seq", [
    ("int4_g128", True, False, 160, 130), ("int4_pc", False, False, 160, 5),
    ("int4_g128", True, True, 160, 44), ("float", False, False, 448, 300),
    ("float", True, False, 160, 130)])
def test_plain_matches_jax_kernel(kind, int8_cross, self_int8, s_self, seq):
    """The port's plain megakernel against the JAX kernel in interpret mode
    on the same seeded inputs: int4 in groups of 128 and per channel, int4
    over an int8 self cache (the fresh int8 K/V bit-equal), float panels
    over float and int8 cross caches; no launch from CPU tensors."""
    state = dict(STATES[kind])
    if self_int8:
        state["attn.kv_orig_quant_scale"] = 1.0 / KV_STEP
        state["attn.kv_quant_orig_scale"] = KV_STEP
    rs = np.random.RandomState(seq)
    x = rs.randn(1, D).astype(np.float32)
    if self_int8:
        cache = rs.randint(-128, 128, (L, 1, 2, H, HD, s_self)).astype(
            np.int8)
    else:
        cache = (rs.randn(L, 1, 2, H, HD, s_self) * 0.5).astype(np.float32)
    cross, scales = _cross(int8_cross)
    hid_j, fresh_j = j_fused_decoder_stack(
        jnp.asarray(x), j_pack_decoder_blobs(state, **PACK_KW),
        jnp.asarray(cache), jnp.asarray([seq], jnp.int32), SCALE,
        cross_cache=jnp.asarray(cross),
        cross_scale=None if scales is None else jnp.asarray(scales),
        head_dim=HD)
    mk.reset_launches()
    hid, fresh = mk.fused_decoder_stack(
        torch.from_numpy(x), mk.pack_decoder_blobs(state, **PACK_KW),
        torch.from_numpy(cache), torch.tensor([seq], dtype=torch.int32),
        SCALE, cross_cache=torch.from_numpy(cross),
        cross_scale=None if scales is None else torch.from_numpy(scales),
        head_dim=HD)
    assert mk.launches["decoder_megakernel"] == 0
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), rtol=RTOL,
                               atol=ATOL)
    if self_int8:
        assert fresh.dtype == torch.int8
        np.testing.assert_array_equal(fresh.numpy(), np.asarray(fresh_j))
    else:
        np.testing.assert_allclose(fresh.numpy(), np.asarray(fresh_j),
                                   rtol=RTOL, atol=ATOL)


# -- the decoder with the image, and the pipelines ---------------------------

@pytest.mark.parametrize("kind", ["int4_g128", "float"])
@torch.inference_mode()
def test_decoder_step_with_image_matches_jax(kind):
    """A prefill, then steps of the port's decoder through its megakernel
    branch (the plain version of the int4 or float image) against the JAX
    decoder's scanned steps: logits and cache within the kernel's
    tolerance, then greedy tokens exact."""
    if kind == "int4_g128":
        jdec, sd, mode = JDEC4, SD4, QuantMode.use_weight_only(True)
    else:
        jdec = JDecoder(JCFG)
        jdec.load_state_dict(FLOAT_SD)
        sd, mode = FLOAT_SD, QuantMode(0)
    pdec = _port_decoder(sd, mode)
    assert pdec.megakernel_eligible()
    blobs = pdec.megakernel_blobs()
    cross, scales = _cross(True)
    jcross = (jnp.asarray(cross), jnp.asarray(scales))
    pcross = (torch.from_numpy(cross), torch.from_numpy(scales))
    prompt = [3, 7, 11, 2, 9]
    plen = len(prompt)
    jl, jcache = jdec(jnp.asarray([prompt], jnp.int32), jdec.new_kv_cache(1),
                      jcross, 0, jnp.asarray([plen], jnp.int32))
    pl_, pcache = pdec(torch.tensor([prompt]), pdec.new_kv_cache(1), pcross,
                       0, plen)
    jt = pt = int(np.argmax(np.asarray(jl)[0, -1]))
    assert pt == int(pl_[0, -1].argmax())
    jtoks, ptoks = [], []
    for i in range(5):
        pos = plen + i
        jl, jcache = jdec(jnp.asarray([[jt]], jnp.int32), jcache, jcross,
                          pos, jnp.asarray([pos + 1], jnp.int32))
        mk.reset_launches()
        pl_, pcache = pdec(torch.tensor([[pt]]), pcache, pcross, pos,
                           pos + 1, megakernel_blobs=blobs)
        if i == 0:
            np.testing.assert_allclose(pl_.numpy(), np.asarray(jl),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(pcache.numpy(), np.asarray(jcache),
                                       rtol=RTOL, atol=ATOL)
        jt = int(np.argmax(np.asarray(jl)[0, -1]))
        pt = int(pl_[0, -1].argmax())
        jtoks.append(jt)
        ptoks.append(pt)
    assert ptoks == jtoks


# a Whisper of d 256 with heads of 64: int4 groups of 128 divide d/2
PIPE_DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=150,
                 n_audio_state=256, n_audio_head=4, n_audio_layer=2,
                 n_text_ctx=48, n_text_state=256, n_text_head=4,
                 n_text_layer=2, dtype="float32")
SAMPLE_LEN = 10


def _random_state(module, rs, scale=0.05):
    return {n: (rs.standard_normal(p._shape) * scale).astype(np.float32)
            for n, p in module.named_parameters()}


@pytest.mark.parametrize("recipe", ["woq4+ckv8+lmq8+sqenc",
                                    "ckv8+lmq8+sqenc"])
def test_pipeline_decode_megakernel_token_exact(recipe):
    """``WhisperPipeline(..., decode_megakernel=True)`` with the int4
    recipe (the image's int4 panels in groups of 128) and the float one
    (float panels) against the JAX pipeline with its megakernel, and
    against the port's own layer-by-layer path."""
    jcfg, pcfg = JConfig(**PIPE_DIMS), WhisperConfig(**PIPE_DIMS)
    enc_sd, dec_sd, ckv_sd = (
        _random_state(m, np.random.RandomState(seed)) for m, seed in
        ((JEncoder(jcfg), 0), (JDecoder(jcfg), 1), (JCrossAttnKV(jcfg), 2)))
    mel = np.random.RandomState(7).randn(1, 80, 300).astype(np.float32)
    int4 = recipe.startswith("woq4")
    qm = WOQ4 if int4 else JQuantMode(0)
    sq = JQuantMode.use_smooth_quant(per_token=True, per_channel=True)
    enc = j_smooth_quantize(JEncoder(jcfg, JQuantMode(0)), sq)
    enc_sd = j_smooth_quantize_state_dict(enc, enc_sd, sq)
    dec = JDecoder(jcfg, qm, quantize_lm_head=True)
    if int4:
        dec, dec_sd = j_weight_only_quantize_state(dec, dec_sd, qm)
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
    jax.clear_caches()

    mods = from_jax_state(enc_sd, dec_sd, ckv_sd, pcfg, recipe=recipe,
                          device="cpu")
    opts = DecodingOptions(language="en", sample_len=SAMPLE_LEN)
    pipe = WhisperPipeline(pcfg, *mods, opts, decode_megakernel=True)
    blobs = pipe._megakernel_blobs()
    assert mk.blob_int4(blobs) == (2 if int4 else None)
    out = pipe.transcribe(mel)[0]
    oracle = WhisperPipeline(pcfg, *mods, opts).transcribe(mel)[0]
    want = [int(t) for t in ref.tokens]
    assert len(want) > 1
    assert out.tokens == want and oracle.tokens == want
    assert out.text == ref.text
    assert abs(out.avg_logprob - ref.avg_logprob) < 1e-3


# -- the gate ------------------------------------------------------------------

@pytest.mark.parametrize("width,heads,eligible", [(256, 4, True),
                                                  (384, 6, False)])
def test_int4_gate_follows_the_jax_package(width, heads, eligible):
    """An int4 Whisper decoder takes the megakernel where the groups of 128
    divide d/2 (d 256), in both packages; Whisper-tiny's width (d 384: 128
    does not divide 192) stays layer by layer in both.  Float decoders
    take it at both widths."""
    dims = {**DIMS, "n_text_state": width, "n_text_head": heads}
    jcfg, pcfg = JConfig(**dims), WhisperConfig(**dims)
    jdec = j_weight_only_quantize(JDecoder(jcfg, WOQ4), WOQ4)
    with torch.device("meta"):
        pdec = WhisperDecoder(pcfg, QuantMode.use_weight_only(True))
        pfloat = WhisperDecoder(pcfg)
    assert jdec.megakernel_eligible() is eligible
    assert pdec.megakernel_eligible("cpu") is eligible
    assert JDecoder(jcfg).megakernel_eligible()
    assert pfloat.megakernel_eligible("cpu")


def test_decoder_only_int4_stays_layer_by_layer():
    """A decoder-only model under woq4 keeps its layer-by-layer path in
    both packages, where its woq8 twin takes the megakernel; the packer
    refuses int4 without cross-attention."""
    from eddie_wang_hackathon2023_tpu.models.decoder import (
        DecoderConfig as JDecoderConfig, DecoderLMHead as JDecoderLMHead)
    kw = dict(vocab_size=97, hidden_size=256, num_layers=2, num_heads=4,
              max_position_embeddings=64)
    for bits4, eligible in ((False, True), (True, False)):
        pmode = QuantMode.use_weight_only(bits4)
        jmode = JQuantMode.use_weight_only(use_int4_weights=bits4)
        with torch.device("meta"):
            pm = DecoderLMHead(DecoderConfig(**kw, dtype="float32",
                                             quant_mode=pmode))
        jm = j_weight_only_quantize(JDecoderLMHead(JDecoderConfig(
            **kw, dtype="float32", quant_mode=jmode)), jmode)
        assert pm.megakernel_eligible() is eligible
        assert jm.megakernel_eligible() is eligible
    st = {k.replace("attn.", "attention.").replace("mlp1", "mlp.fc")
          .replace("mlp2", "mlp.proj").replace("attn_ln", "input_layernorm")
          .replace("mlp_ln", "post_layernorm"): v
          for k, v in STATES["int4_g128"].items()
          if not k.startswith("cross")}
    with pytest.raises(NotImplementedError):
        mk.pack_decoder_blobs(st, n_layer=L, hidden=D, n_head=H,
                              head_dim=HD, ffn=4 * D, with_cross=False)


# -- what reaches the int4 kernel ---------------------------------------------

@pytest.fixture
def smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def one_cpu_thread():
    """One intra-op thread for the rehearsals' thousands of tiny ops (the
    fixture of tests/test_torch_whisper.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# large-v2's head dim at a tiny size: d 256, 4 heads of 64, 2+2 layers, in
# bf16 as on the card
SMOKE_DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=150,
                  n_audio_state=256, n_audio_head=4, n_audio_layer=2,
                  n_text_ctx=96, n_text_state=256, n_text_head=4,
                  n_text_layer=2, dtype="bfloat16")


@pytest.mark.parametrize("recipe,decode_megakernel", [
    ("woq4+ckv8+lmq8", False), ("woq4+ckv8+lmq8+sqenc", True)])
def test_only_bf16_rows_reach_the_int4_kernel(smoke, one_cpu_thread,
                                              monkeypatch, recipe,
                                              decode_megakernel):
    """On a bf16 Whisper every row the int4 kernel gets is bf16 (the
    kernel takes no other): the int4 encoder's linears, the prompt
    prefill's and each layer-by-layer step's (the SmoothQuant encoder's
    fp32 q/k/v never reach an int4 linear)."""
    seen = []
    plain = iq.plain_quant_matmul_int4

    def spy(x, qweight, scales):
        seen.append((x.dtype, x.numel() // x.shape[-1]))
        return plain(x, qweight, scales)
    monkeypatch.setattr(iq, "plain_quant_matmul_int4", spy)
    cfg = WhisperConfig(**SMOKE_DIMS)
    built = smoke.build_whisper(torch, np, cfg, torch.device("cpu"), recipe,
                                "cpu")
    pipe = smoke.whisper_pipeline(built, decode_megakernel, sample_len=6)
    pipe.transcribe(built["mel"])
    rows = {m for _, m in seen}
    assert {dt for dt, _ in seen} == {torch.bfloat16}
    assert 3 in rows                          # the prompt prefill
    assert (1 in rows) is not decode_megakernel
    # the encoder's 150 frames padded to 256
    assert (256 in rows) is ("sqenc" not in recipe)


# -- chip_smoke.py's woq4, float and woq4_scanned paths, rehearsed -----------

def test_chip_smoke_woq4_float_paths_on_cpu(smoke, one_cpu_thread):
    """``chip_smoke.py``'s woq4 and float paths on the main path's model
    (its decoder made anew from the same float state for each recipe), and
    the woq4_scanned path, at the tiny size cut to 1+1 layers, in fp32 (a
    bf16 step on the CPU spends most of its time casting the lm_head):
    every transcription decodes its 40 tokens, the woq4 and float paths
    through the megakernel's plain version (int4 in groups of 128, float
    panels), no kernel launched from CPU tensors, and each replay against
    the plain layer-by-layer path within the gate (the main path itself is
    rehearsed in tests/test_torch_whisper.py: here its tokens alone)."""
    cfg = WhisperConfig(**{**SMOKE_DIMS, "n_audio_layer": 1,
                           "n_text_layer": 1, "dtype": "float32"})
    built = smoke.build_whisper(torch, np, cfg, torch.device("cpu"),
                                "woq8+ckv8+lmq8+sqenc", "main")
    main = dict(tokens=smoke.whisper_pipeline(built, True).transcribe(
        built["mel"])[0].tokens)
    out, counts = smoke.whisper_variant_paths(torch, np, built, main,
                                              device="cpu")
    assert out["woq4"]["megakernel_mode"] == "int4 panels, groups of 128"
    assert out["float"]["megakernel_mode"] == "float32 panels"
    scan, scan_counts = smoke.woq4_scanned_path(torch, np, cfg, "cpu")
    assert not scan["megakernel"]
    for e2e in (out["woq4"], out["float"], scan):
        assert len(e2e["tokens"]) == smoke.SAMPLE_LEN
        assert e2e["logits_rel_err"] < 5e-2
    for c in (counts["woq4"], counts["float"], scan_counts):
        assert set(c.values()) == {0}
    assert 0.0 <= out["woq4"]["tokens_equal_main"] <= 1.0
