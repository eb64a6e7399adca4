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


def _int4_block_state():
    """The same decoder's blocks quantised int4 weight-only by the JAX
    surgery (groups of 128: 2 a panel at d 256)."""
    import jax
    qm = JQuantMode.use_weight_only(use_int4_weights=True)
    dec = JDecoder(JCFG, qm)
    dec.random_init(jax.random.PRNGKey(3), 0.05)
    _, sd = j_weight_only_quantize_state(JDecoder(JCFG, qm),
                                         dec.state_dict(), qm)
    return {k[len("blocks."):]: np.asarray(v) for k, v in sd.items()
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
    # the port's tiles (the card's repack) follow the JAX packer's fields
    assert out.tiles is None and own.tiles is None
    for name in mk.MegakernelBlobs._fields[:8]:       # wblob .. kv_qo
        r = np.asarray(getattr(ref, name))
        for blobs in (out, own):
            t = getattr(blobs, name).numpy()
            assert t.dtype == r.dtype and t.shape == r.shape, name
            np.testing.assert_array_equal(t, r, err_msg=name)
    # int4 panels with group scales: each [d, d] panel half-split along its
    # own K rows, the group scales cut as the panels
    state4 = _int4_block_state()
    ref4 = j_pack_decoder_blobs(state4, **PACK_KW)
    out4 = mk.pack_decoder_blobs(state4, **PACK_KW)
    assert out4.wblob.shape == (L, 6 + 2 * 4, D // 2, D)
    assert out4.gscale.shape == (L, 6 + 2 * 4, 2, D)
    for name in mk.MegakernelBlobs._fields[:9]:       # wblob .. gscale
        r = np.asarray(getattr(ref4, name))
        t = getattr(out4, name).numpy()
        assert t.dtype == r.dtype and t.shape == r.shape, name
        np.testing.assert_array_equal(t, r, err_msg=name)


# -- the kernel's GEMV plan and its repacked tiles --------------------------

@pytest.mark.parametrize("d", [1280, 384, 256, 128])
@pytest.mark.parametrize("sms", [132, 114, 100, 16])
def test_megakernel_plan_items_cover_every_column(d, sms):
    """Each GEMV stage's items of c columns by all of K cover its columns,
    none wholly past them, at most one a block; the tiles of a layer are
    the stages' items in order (the checks of the C entry's plan_ok)."""
    nf = 4
    plan = mk.megakernel_plan(d, nf, sms)
    cols = (3 * d, d, d, d, nf * d, d)
    ks = (d, d, d, d, d, nf * d)
    off = 0
    for g in range(len(mk.GEMV_STAGES)):
        c, n, k = (plan[f][g] for f in ("item_c", "items", "item_k"))
        assert k == ks[g] and k % 16 == 0
        assert 1 <= n <= sms and c * n >= cols[g] > c * (n - 1)
        if sms >= 107 and d <= mk.MAX_D:
            assert c <= mk.ITEM_MAX_COLS
        assert plan["tile_off"][g] == off
        off += c * n * k
    assert plan["layer_bytes"] == off


def test_megakernel_plan_at_large_v2():
    """Whisper large-v2 on 132 SMs: every stage one wave (128 items; fc1's
    5120 columns 132 items of 39, the last one 11 wide, so 28 padding
    columns of 1280 bytes)."""
    plan = mk.megakernel_plan(1280, 4, 132)
    assert plan["item_c"] == [30, 10, 10, 10, 39, 10]
    assert plan["items"] == [128, 128, 128, 128, 132, 128]
    assert plan["layer_bytes"] == 14 * 1280 * 1280 + 28 * 1280


def _random_wblob(L, d, nf, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(-128, 128, (L, 6 + 2 * nf, d, d))
                            .astype(np.int8))


@pytest.mark.parametrize("d,sms", [(128, 132), (256, 100), (384, 16)])
def test_megakernel_tiles_round_trip(d, sms):
    """Each stage read back from the tiles (``untile``) is the stage's weight
    composed from the K-major panels (q | k | v, the fc1 panels side by
    side, the fc2 panels stacked along K), with zeros in the padding
    columns; the tiles carry the grid they were cut for."""
    L, nf = 2, 4
    w = _random_wblob(L, d, nf, seed=d)
    blobs = mk.MegakernelBlobs(w, *[torch.zeros(1)] * 7)
    tiled = mk.megakernel_tiles(blobs, sms=sms)
    assert tiled.tiles_grid == sms and tiled.tiles.dtype == torch.int8
    plan = mk.megakernel_plan(d, nf, sms)
    assert tuple(tiled.tiles.shape) == (L, plan["layer_bytes"])
    want = [torch.cat([w[:, 0], w[:, 1], w[:, 2]], dim=2), w[:, 3], w[:, 4],
            w[:, 5], torch.cat([w[:, 6 + j] for j in range(nf)], dim=2),
            torch.cat([w[:, 6 + nf + j] for j in range(nf)], dim=1)]
    for g, ref in enumerate(want):
        got = mk.untile(tiled.tiles, plan, g)
        cols = ref.shape[2]
        assert torch.equal(got[..., :cols], ref), mk.GEMV_STAGES[g]
        assert not got[..., cols:].any()


def test_gemv_through_tiles_equals_the_blob():
    """A plain GEMV read through the repacked tiles equals one read through
    the blob's panels bit for bit (exact fp64 sums), per stage and layer,
    on a seeded row;
    and the layers sliced from tiled blobs keep their tiles."""
    L, d, nf = 2, 256, 4
    w = _random_wblob(L, d, nf, seed=1)
    blobs = mk.megakernel_tiles(mk.MegakernelBlobs(w, *[torch.zeros(L)] * 7),
                                sms=132)
    plan = mk.megakernel_plan(d, nf, 132)
    rs = np.random.RandomState(2)
    pan = [torch.cat([w[:, 0], w[:, 1], w[:, 2]], dim=2), w[:, 3], w[:, 4],
           w[:, 5], torch.cat([w[:, 6 + j] for j in range(nf)], dim=2),
           torch.cat([w[:, 6 + nf + j] for j in range(nf)], dim=1)]
    for g, ref in enumerate(pan):
        k, cols = ref.shape[1:]
        v = torch.from_numpy(rs.randn(1, k).astype(np.float32)).bfloat16()
        for layer in range(L):
            tile_w = mk.untile(blobs.tiles, plan, g)[layer, :, :cols]
            # bf16 x int8 products summed in fp64 are exact in any order
            assert torch.equal(v.double() @ tile_w.double(),
                               v.double() @ ref[layer].double())
    one = mk.blob_layers(blobs, 1, 2)
    assert torch.equal(one.tiles, blobs.tiles[1:2])
    assert torch.equal(one.wblob, w[1:2]) and one.tiles_grid == 132


# per-layer self-KV dequantise steps of an int8 self cache (amax / 127 of
# fresh K/V of about 0.3: some values clip), stored as the convert step
# stores them
KV_STEP = np.asarray([[0.0021], [0.0034], [0.0027]], np.float32)
KV_STATE = {**BLOCK_STATE, "attn.kv_orig_quant_scale": 1.0 / KV_STEP,
            "attn.kv_quant_orig_scale": KV_STEP}


def _plain_against_jax_kernel(int8_cross, s_self, seq, self_int8):
    """The port's plain megakernel against the JAX kernel in interpret mode
    on the same seeded inputs: (hidden, JAX hidden, fresh, JAX fresh)."""
    rs = np.random.RandomState(seq)
    x = rs.randn(1, D).astype(np.float32)
    if self_int8:
        cache = rs.randint(-128, 128, (L, 1, 2, H, HD, s_self)).astype(
            np.int8)
    else:
        cache = (rs.randn(L, 1, 2, H, HD, s_self) * 0.5).astype(np.float32)
    state = KV_STATE if self_int8 else BLOCK_STATE
    cross, scales = _cross(int8_cross)
    jblobs = j_pack_decoder_blobs(state, **PACK_KW)
    hid_j, fresh_j = j_fused_decoder_stack(
        jnp.asarray(x), jblobs, jnp.asarray(cache),
        jnp.asarray([seq], jnp.int32), SCALE, cross_cache=jnp.asarray(cross),
        cross_scale=None if scales is None else jnp.asarray(scales),
        head_dim=HD)
    blobs = mk.pack_decoder_blobs(state, **PACK_KW)
    mk.reset_launches()
    hid, fresh = mk.fused_decoder_stack(
        torch.from_numpy(x), blobs, torch.from_numpy(cache),
        torch.tensor([seq], dtype=torch.int32), SCALE,
        cross_cache=torch.from_numpy(cross),
        cross_scale=None if scales is None else torch.from_numpy(scales),
        head_dim=HD)
    assert mk.launches["decoder_megakernel"] == 0    # plain on the CPU
    assert hid.shape == (1, D) and fresh.shape == (L, 2, H, HD)
    assert fresh.dtype == (torch.int8 if self_int8 else torch.float32)
    return hid.numpy(), np.asarray(hid_j), fresh.numpy(), np.asarray(fresh_j)


@pytest.mark.parametrize("int8_cross", [False, True])
@pytest.mark.parametrize("s_self,seq", [(160, 1), (160, 5), (160, 130),
                                        (448, 300)])
def test_plain_matches_jax_kernel(int8_cross, s_self, seq):
    """seq 130: one past the 128-column self chunk; seq 300 on a 448-column
    cache: two of the port's 256-column attention slices."""
    hid, hid_j, fresh, fresh_j = _plain_against_jax_kernel(
        int8_cross, s_self, seq, self_int8=False)
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fresh, fresh_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s_self,seq", [(160, 1), (160, 5), (160, 130),
                                        (448, 300)])
def test_plain_matches_jax_kernel_int8_self(s_self, seq):
    """The same cases over an int8 self cache with per-layer scales (the
    JAX kernel's ``self_quant`` mode), with the int8 cross cache of the
    recipes that use it: the fresh K/V bit-equal, the hidden state within
    the float mode's tolerance."""
    hid, hid_j, fresh, fresh_j = _plain_against_jax_kernel(
        True, s_self, seq, self_int8=True)
    assert fresh_j.dtype == np.int8
    np.testing.assert_array_equal(fresh, fresh_j)
    assert np.abs(fresh.astype(int)).max() > 64      # the range is used
    np.testing.assert_allclose(hid, hid_j, rtol=RTOL, atol=ATOL)


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
    elif mode == "gated":
        # with cross-attention (the JAX kernel refuses it too)
        kw[mode] = True
    elif mode == "fp8_cross":
        # an e4m3 cross cache (the e4m3 self cache is ported:
        # tests/test_torch_fp8.py)
        kw["cross_cache"] = cross.to(torch.float8_e4m3fn)
    elif mode == "gqa":
        cache = torch.zeros(L, 1, 2, 1, HD, 16)
    elif mode == "int4_group_past_half":
        # groups of 256 rows (one a panel) do not divide d/2 = 128
        blobs = blobs._replace(wblob=blobs.wblob[:, :, :D // 2],
                               gscale=torch.ones(L, 14, 1, D))
    elif mode == "int4_decoder_only":
        # int4 blobs handed to the decoder-only set (no cross cache)
        blobs = blobs._replace(wblob=blobs.wblob[:, :, :D // 2])
        kw["cross_cache"] = None
    elif mode == "no_cross":
        kw["cross_cache"] = None
    mk.fused_decoder_stack(x, blobs, cache, seq, SCALE, **kw)


@pytest.mark.parametrize("mode", ["batch2", "tail", "gated", "fp8_cross",
                                  "gqa", "int4_group_past_half",
                                  "int4_decoder_only"])
def test_modes_outside_the_port_raise(mode):
    """The modes still refused.  The start index, RoPE, the parallel
    residual, RMSNorm, SiLU and decoders without cross-attention are
    ported (tests/test_torch_llama_megakernel.py), and so are Whisper's
    int4 and float panels (tests/test_torch_whisper_woq4.py); a group of
    int4 rows that does not divide d/2 and int4 without cross-attention
    (as the JAX package keeps decoder-only int4 off the megakernel) are
    not."""
    with pytest.raises(NotImplementedError):
        _mode_call(mode)


def test_blobs_packed_for_another_mode_raise():
    """Blobs packed with cross-attention called without a cross cache."""
    with pytest.raises(ValueError):
        _mode_call("no_cross")


def test_float_blobs_with_cross_bit_equal_to_jax_packer():
    """A float Whisper block state (the head-major fused QKV [L, 3, H, D, d]
    and the [L, out, in] linears) packs into K-major panels of its type
    with unit scales, bit for bit as the JAX packer's."""
    import jax
    dec = JDecoder(JCFG)
    dec.random_init(jax.random.PRNGKey(4), 0.05)
    state = {k[len("blocks."):]: np.asarray(v)
             for k, v in dec.state_dict().items() if k.startswith("blocks.")}
    ref = j_pack_decoder_blobs(state, **PACK_KW)
    out = mk.pack_decoder_blobs(state, **PACK_KW)
    assert ref.gscale is None and out.gscale is None
    assert out.wblob.dtype == torch.float32
    assert out.wblob.shape == (L, 6 + 2 * 4, D, D)
    for name in mk.MegakernelBlobs._fields[:8]:
        r = np.asarray(getattr(ref, name))
        t = getattr(out, name).numpy()
        assert t.dtype == r.dtype and t.shape == r.shape, name
        np.testing.assert_array_equal(t, r, err_msg=name)
    assert not (out.pair_scale != 1).any() and not (out.flat_scale != 1).any()


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
