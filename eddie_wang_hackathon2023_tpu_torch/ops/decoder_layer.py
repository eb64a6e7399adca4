"""The whole decode step of a Whisper decoder (every layer) in one kernel.

Counterpart of the JAX package's ``ops/pallas_decoder_layer.py``
(``fused_decoder_stack``, :865), for the modes of the Whisper int8 recipe
at batch 1: int8 weight-only panels with per-channel scales, LayerNorm,
tanh GELU, cross-attention over an int8 (or float) cross cache with
per-layer scales, and a float or int8 self cache with the fresh token's K/V
(int8: the fresh K/V quantised with the blobs' per-layer ``kv_oq``, the
cache and the fresh column dequantised with ``kv_qo``, as the TPU kernel's
``self_quant`` mode).  On a
CUDA tensor the wrapper makes ONE cooperative launch of the kernel of
``csrc/decoder_layer.cu``, which reads its GEMV weights from the blobs'
``tiles`` (:func:`megakernel_tiles`, cut by :func:`megakernel_plan` for the
card's SM count); on a CPU tensor it runs the plain version,
:func:`plain_fused_decoder_stack`, which runs the kernel's stages with its
attention slices and rounding points.

Not ported, and raising ``NotImplementedError``: int4 or float panels,
RMSNorm, the gated MLP, the parallel residual, RoPE, MQA/GQA, fp8
self-KV, the K-step tail, a start index, decoders without cross-attention
and batch > 1.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..functional import gelu, layer_norm, matmul_fp32, round_half_away
from . import _build
from .attention import NEG

# launches of the CUDA kernel, counted where the wrapper launches it
launches = {"decoder_megakernel": 0}

# the kernel's attention split, mirrored here: ATTN_SPLIT-column slices of
# the cache, at most MAX_SPLITS a head (the plain version combines its
# attention slices the same way)
ATTN_SPLIT = 256
MAX_SPLITS = 8
HEAD_DIM = 64
# the GEMV stages of a layer, in the kernel's order (``Stage`` in
# csrc/decoder_layer.cu)
GEMV_STAGES = ("qkv", "dense", "crossq", "crossdense", "fc1", "fc2")
# the kernel's limits: a thread holds 5 elements of a d-row and 20 of
# fc1's (d <= 1280, ffn <= 5120: Whisper large), a warp sums 6 columns of
# an item (48 an item: 5120 columns need 107 SMs)
MAX_D, MAX_FFN, ITEM_MAX_COLS = 1280, 5120, 48

# state-dict key prefixes of the Whisper ResidualAttentionBlock (the JAX
# packer's WHISPER_KEYS)
WHISPER_KEYS = dict(qkv="attn.qkv", dense="attn.dense",
                    crossq="cross_attn.q_linear",
                    crossdense="cross_attn.dense",
                    fc1="mlp1", fc2="mlp2",
                    ln=("attn_ln", "cross_attn_ln", "mlp_ln"),
                    kv="attn")


def reset_launches() -> None:
    launches["decoder_megakernel"] = 0


class MegakernelBlobs(NamedTuple):
    """Packed per-layer weights of :func:`fused_decoder_stack` (the JAX
    package's layout and names)."""
    wblob: torch.Tensor        # [L, NPAN, d, d] int8 K-major panels
    pair_scale: torch.Tensor   # [L, 4, d/128, 128] f32: q, k, v, cross-q
    pair_bias: torch.Tensor    # [L, 4, d/128, 128] f32
    flat_scale: torch.Tensor   # [L, NF, d] f32: dense, cross-dense, fc1.., fc2
    flat_bias: torch.Tensor    # [L, NF, d] f32
    ln_par: torch.Tensor       # [L, 6, d] f32: weight, bias of each LN
    kv_oq: torch.Tensor        # [L] f32 self-KV quantise scale (int8 cache)
    kv_qo: torch.Tensor        # [L] f32 self-KV dequantise scale
    gscale: Optional[torch.Tensor] = None   # int4 group scales: not ported
    # the kernel's item-contiguous copy of wblob [L, layer_bytes] int8 and
    # the grid it was cut for (:func:`megakernel_tiles`; the card only)
    tiles: Optional[torch.Tensor] = None
    tiles_grid: Optional[int] = None


def megakernel_plan(d: int, nf: int, sms: int) -> Dict[str, list]:
    """The megakernel's GEMV items for width ``d``, ``nf`` fc panels and a
    grid of ``sms`` blocks: per stage of :data:`GEMV_STAGES`, ``item_c``
    output columns an item by all ``item_k`` rows of K, ``items`` items (at
    most one a block: c = ceil(columns / sms), so each stage is one wave),
    ``tile_off`` the stage's byte offset in a layer's tiles and
    ``layer_bytes`` a layer's (the last item's columns past the stage's are
    zeros), and ``ring_cap`` the bytes of the shared-memory ring that
    streams the items (0: all the block's shared memory left, about a
    layer's items).  The C entry refuses any other plan."""
    cols = (3 * d, d, d, d, nf * d, d)
    ks = (d, d, d, d, d, nf * d)
    plan = dict(item_c=[], items=[], item_k=list(ks), tile_off=[])
    off = 0
    for n, k in zip(cols, ks):
        c = -(-n // sms)
        items = -(-n // c)
        plan["item_c"].append(c)
        plan["items"].append(items)
        plan["tile_off"].append(off)
        off += c * items * k
    plan["layer_bytes"] = off
    plan["ring_cap"] = 0
    return plan


def _stage_weights(wblob: torch.Tensor):
    """Each GEMV stage's weight of every layer transposed, [L, columns, K]
    (K contiguous), from the K-major panels [L, NPAN, d, d]."""
    L, npan, d, _ = wblob.shape
    nf = (npan - 6) // 2
    pan = _panels(nf)
    return [
        wblob[:, pan["q"]:pan["q"] + 3].transpose(2, 3).reshape(L, 3 * d, d),
        wblob[:, pan["dense"]].transpose(1, 2),
        wblob[:, pan["crossq"]].transpose(1, 2),
        wblob[:, pan["crossdense"]].transpose(1, 2),
        wblob[:, pan["fc1"]:pan["fc1"] + nf].transpose(2, 3)
        .reshape(L, nf * d, d),
        wblob[:, pan["fc2"]:pan["fc2"] + nf].reshape(L, nf * d, d)
        .transpose(1, 2)]


def megakernel_tiles(blobs: "MegakernelBlobs", sms: Optional[int] = None
                     ) -> "MegakernelBlobs":
    """``blobs`` with ``tiles``: the panels of ``wblob`` repacked once into
    the kernel's item-contiguous layout for a grid of ``sms`` blocks (the
    SM count of wblob's card by default): per layer, per stage of
    :data:`GEMV_STAGES`, ``items`` items of ``item_c`` columns, each its
    columns' K rows contiguous (:func:`megakernel_plan`)."""
    w = blobs.wblob
    L, npan, d, _ = w.shape
    nf = (npan - 6) // 2
    if sms is None:
        sms = torch.cuda.get_device_properties(
            w.device).multi_processor_count
    plan = megakernel_plan(d, nf, sms)
    parts = []
    for g, m in enumerate(_stage_weights(w)):
        rows = plan["item_c"][g] * plan["items"][g]
        parts.append(torch.nn.functional.pad(
            m, (0, 0, 0, rows - m.shape[1])).reshape(L, -1))
    return blobs._replace(tiles=torch.cat(parts, dim=1).contiguous(),
                          tiles_grid=sms)


def untile(tiles: torch.Tensor, plan: Dict[str, list], stage: int
           ) -> torch.Tensor:
    """Stage ``stage``'s weight [L, K, columns] (K-major, as the panels
    hold it) read back from tiles [L, layer_bytes] laid out by ``plan``;
    the padding columns included."""
    c, n, k = (plan[f][stage] for f in ("item_c", "items", "item_k"))
    off = plan["tile_off"][stage]
    L = tiles.shape[0]
    return tiles[:, off:off + c * n * k].reshape(L, c * n, k).transpose(1, 2)


def blob_layers(blobs: "MegakernelBlobs", lo: int, hi: int
                ) -> "MegakernelBlobs":
    """The layers lo..hi-1 of ``blobs`` (every per-layer tensor sliced)."""
    return blobs._replace(**{
        f: v[lo:hi] for f, v in blobs._asdict().items()
        if torch.is_tensor(v)})


# the wblob panel of each projection (the JAX package's ``_panel_of`` with
# cross-attention); fc1 and fc2 take nf panels each from the one named
def _panels(nf: int) -> Dict[str, int]:
    return dict(q=0, k=1, v=2, dense=3, crossq=4, crossdense=5, fc1=6,
                fc2=6 + nf)


# flat scale/bias slots: dense, cross-dense, the fc1 slices, fc2
def _flat_slots(nf: int) -> Dict[str, int]:
    return dict(dense=0, crossdense=1, fc1=2, fc2=2 + nf)


def woq_block_eligible(qkv, mods, hidden: int) -> bool:
    """Every projection of the block int8 weight-only per output channel
    (the int8 half of the JAX package's check; the int4 panels are not
    ported, so an int4 block never reaches the megakernel)."""
    from ..quantization.layers import (WeightOnlyQuantLinear,
                                       WeightOnlyQuantQKVLinear)
    if not isinstance(qkv, WeightOnlyQuantQKVLinear) or qkv.bits != 8:
        return False
    return all(isinstance(m, WeightOnlyQuantLinear) and m.bits == 8
               for m in mods)


def pack_decoder_blobs(state: dict, *, n_layer: int, hidden: int,
                       n_head: int, head_dim: int, ffn: int,
                       with_cross: bool = True, device=None
                       ) -> MegakernelBlobs:
    """The megakernel's weight image from a stacked block state dict (keys
    of :data:`WHISPER_KEYS` without the ``blocks.`` prefix, numpy arrays or
    tensors, int8 weight-only: ``attn.qkv.qweight`` [L, d, 3d],
    ``mlp1.qweight`` [L, d, ffn], ...).  A pure relayout, equal bit for bit
    to the JAX package's ``pack_decoder_blobs`` on the same state: q/k/v and
    fc1 are cut along their output columns into [d, d] panels, fc2 along its
    input rows; ffn is zero-padded to a multiple of d."""
    if not with_cross:
        raise NotImplementedError("decoders without cross-attention are not "
                                  "ported to the megakernel")
    kk = WHISPER_KEYS
    if kk["qkv"] + ".qweight" not in state:
        raise NotImplementedError("float megakernel panels are not ported "
                                  "(int8 weight-only only)")
    L, d = n_layer, hidden
    hp, dl = d // 128, 128
    nf = -(-ffn // d)
    pffn = nf * d
    f32 = torch.float32

    def g(key):
        v = state[key]
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return t if device is None else t.to(device)

    if g(kk["qkv"] + ".qweight").shape[-2] != d:
        raise NotImplementedError("int4 megakernel panels are not ported")
    if g(kk["qkv"] + ".per_channel_scale").dim() != 2:
        raise NotImplementedError("group-wise scales are not ported")

    def zeros_or(key, shape):
        v = state.get(key)
        if v is None:
            return torch.zeros(shape, dtype=f32, device=device)
        return g(key).to(f32)

    def pad_cols(w):                     # [L, d, ffn] -> [L, d, pffn]
        return w if pffn == ffn else torch.nn.functional.pad(
            w, (0, pffn - ffn))

    def pad_rows(w):                     # [L, ffn, d] -> [L, pffn, d]
        return w if pffn == ffn else torch.nn.functional.pad(
            w, (0, 0, 0, pffn - ffn))

    def pad_flat(v, fill):               # [L, ffn] -> [L, pffn]
        if pffn == ffn:
            return v
        extra = torch.full((L, pffn - ffn), fill, dtype=v.dtype,
                           device=v.device)
        return torch.cat([v, extra], dim=1)

    def scale(key):
        return g(key + ".per_channel_scale").to(f32)

    qkv_w = g(kk["qkv"] + ".qweight")
    fc1 = pad_cols(g(kk["fc1"] + ".qweight"))
    fc2 = pad_rows(g(kk["fc2"] + ".qweight"))
    panels = [qkv_w[:, :, 0:d], qkv_w[:, :, d:2 * d], qkv_w[:, :, 2 * d:],
              g(kk["dense"] + ".qweight"), g(kk["crossq"] + ".qweight"),
              g(kk["crossdense"] + ".qweight")]
    panels += [fc1[:, :, j * d:(j + 1) * d] for j in range(nf)]
    panels += [fc2[:, j * d:(j + 1) * d, :] for j in range(nf)]
    wblob = torch.stack(panels, dim=1).contiguous()

    def to_pair(p):                      # [L, d] -> [L, hp, dl]
        return p.reshape(L, hp, dl)

    qkv_s = scale(kk["qkv"])                                   # [L, 3d]
    qkv_b = zeros_or(kk["qkv"] + ".bias",
                     (L, 3, n_head, head_dim)).reshape(L, 3 * d)
    pair_s = [qkv_s[:, 0:d], qkv_s[:, d:2 * d], qkv_s[:, 2 * d:],
              scale(kk["crossq"])]
    pair_b = [qkv_b[:, 0:d], qkv_b[:, d:2 * d], qkv_b[:, 2 * d:],
              zeros_or(kk["crossq"] + ".bias", (L, d))]
    pair_scale = torch.stack([to_pair(p) for p in pair_s], dim=1)
    pair_bias = torch.stack([to_pair(p) for p in pair_b], dim=1)

    fc1_s = pad_flat(scale(kk["fc1"]), 1.0)
    fc1_b = pad_flat(zeros_or(kk["fc1"] + ".bias", (L, ffn)), 0.0)
    flat_s = [scale(kk["dense"]), scale(kk["crossdense"])]
    flat_b = [zeros_or(kk["dense"] + ".bias", (L, d)),
              zeros_or(kk["crossdense"] + ".bias", (L, d))]
    flat_s += [fc1_s[:, j * d:(j + 1) * d] for j in range(nf)]
    flat_b += [fc1_b[:, j * d:(j + 1) * d] for j in range(nf)]
    flat_s.append(scale(kk["fc2"]))
    flat_b.append(zeros_or(kk["fc2"] + ".bias", (L, d)))
    flat_scale = torch.stack(flat_s, dim=1)
    flat_bias = torch.stack(flat_b, dim=1)

    ln_rows = []
    for name in kk["ln"]:
        ln_rows += [g(name + ".weight").to(f32),
                    zeros_or(name + ".bias", (L, d))]
    ln_par = torch.stack(ln_rows, dim=1)

    kv_key = kk["kv"] + ".kv_orig_quant_scale"
    if state.get(kv_key) is not None:
        kv_oq = g(kv_key).to(f32).reshape(L)
        kv_qo = g(kk["kv"] + ".kv_quant_orig_scale").to(f32).reshape(L)
    else:
        kv_oq = kv_qo = torch.ones((L,), dtype=f32, device=device)
    return MegakernelBlobs(wblob, pair_scale, pair_bias, flat_scale,
                           flat_bias, ln_par, kv_oq, kv_qo, None)


def _check_modes(x, blobs: MegakernelBlobs, self_cache, cross_cache,
                 head_dim: int, start_index, tail_kv, act: str, norm: str,
                 gated: bool, parallel: bool, rope_mat) -> None:
    """Raise ``NotImplementedError`` for every mode outside this port."""
    d = x.shape[-1]
    outside = [
        (x.shape[0] != 1 or self_cache.shape[1] != 1, "batch > 1"),
        (tail_kv is not None, "the K-step decode tail"),
        (start_index is not None, "a start index (left padding)"),
        (rope_mat is not None, "RoPE"),
        (gated, "the gated MLP"), (parallel, "the parallel residual"),
        (norm != "layernorm", f"norm {norm!r}"),
        (act != "gelu", f"activation {act!r}"),
        (cross_cache is None, "decoders without cross-attention"),
        (blobs.gscale is not None or blobs.wblob.dtype != torch.int8
         or blobs.wblob.shape[2] != d, "int4 or float panels"),
        (self_cache.dtype != torch.int8 and self_cache.element_size() == 1,
         "fp8 self-KV"),
        (self_cache.shape[3] * head_dim != d, "MQA/GQA"),
    ]
    for bad, what in outside:
        if bad:
            raise NotImplementedError(f"megakernel: {what} is not ported")


def _attn_slice(q, k_all, v_all, c: int, n_valid: int, qk_scale: float,
                adt):
    """One ATTN_SPLIT-column slice c of the cache [H, D, S] against q
    [H, D]: (max [H], sum [H], P*V [H, D]) with P rounded to ``adt``."""
    h, d = q.shape
    c0, c1 = c * ATTN_SPLIT, min(n_valid, (c + 1) * ATTN_SPLIT)
    if c1 <= c0:
        return (torch.full((h,), NEG, device=q.device),
                torch.zeros((h,), device=q.device),
                torch.zeros((h, d), device=q.device))
    k = k_all[..., c0:c1].to(adt).float()
    v = v_all[..., c0:c1].to(adt).float()
    s = torch.einsum("hd,hds->hs", q.float(), k) * qk_scale
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    pv = torch.einsum("hs,hds->hd", p.to(adt).float(), v)
    return m, p.sum(-1), pv


def _combine(parts):
    """Slices -> (max M [H], sum [H], P*V [H, D]) relative to M."""
    m = torch.stack([p[0] for p in parts], 1)
    big = m.amax(1)
    w = torch.exp(m - big[:, None])
    tot = (torch.stack([p[1] for p in parts], 1) * w).sum(1)
    acc = (torch.stack([p[2] for p in parts], 1) * w[..., None]).sum(1)
    return big, tot, acc


def plain_fused_decoder_stack(x, blobs: MegakernelBlobs, self_cache, seq_len,
                              scale: float, cross_cache=None,
                              cross_scale=None, head_dim: int = HEAD_DIM,
                              eps: float = 1e-5):
    """The plain PyTorch version of :func:`fused_decoder_stack`: the
    kernel's stages, attention slices and rounding points, layer by
    layer.  With an int8 self cache the fresh K/V are quantised with
    ``blobs.kv_oq`` as :func:`..ops.attention.quantize_cache_values` does,
    and the self-attention is scaled by ``blobs.kv_qo`` as the TPU kernel
    scales it (``pallas_decoder_layer.py:554,740-743``)."""
    adt = x.dtype
    quant = self_cache.dtype == torch.int8
    L, _, _, H, D, S = self_cache.shape
    d = x.shape[-1]
    nf = (blobs.wblob.shape[1] - 6) // 2
    pan, slots = _panels(nf), _flat_slots(nf)
    n_valid = min(max(int(torch.as_tensor(seq_len).reshape(-1)[0]) - 1, 0),
                  S)
    sc = cross_cache.shape[-1]
    fresh = torch.empty((L, 2, H, D), dtype=self_cache.dtype,
                        device=x.device)

    def affine(acc, s, b):               # fp32 * scale -> adt, + adt bias
        return (acc * s).to(adt) + b.to(adt)

    x = x.reshape(1, d).to(adt)
    for layer in range(L):
        w = blobs.wblob[layer]
        ps = blobs.pair_scale[layer].reshape(4, d)
        pb = blobs.pair_bias[layer].reshape(4, d)
        fs, fb = blobs.flat_scale[layer], blobs.flat_bias[layer]
        ln = blobs.ln_par[layer]
        kscale = (1.0 if cross_scale is None
                  else cross_scale.reshape(-1)[layer].float())
        kqo = blobs.kv_qo[layer].float() if quant else 1.0

        def gemv(v, panel):
            return matmul_fp32(v, w[panel].to(adt))

        def project(v, name):            # dense / cross-dense
            f = slots[name]
            return affine(gemv(v.reshape(1, d).to(adt), pan[name]), fs[f],
                          fb[f])

        # LN1 -> q, k, v; self-attention over the cache, then the fresh
        # token's column in fp32
        h = layer_norm(x, ln[0], ln[1], eps)
        q, k_f, v_f = (affine(gemv(h, pan[n]), ps[i], pb[i]).reshape(H, D)
                       for i, n in enumerate(("q", "k", "v")))
        if quant:
            # the integers the cache write would store, kept in fp32
            k_f, v_f = (torch.clamp(round_half_away(
                t.float() * blobs.kv_oq[layer].float()), -128, 127)
                for t in (k_f, v_f))
        fresh[layer, 0], fresh[layer, 1] = k_f, v_f
        kc, vc = self_cache[layer, 0, 0], self_cache[layer, 0, 1]
        big, tot, acc = _combine([
            _attn_slice(q, kc, vc, c, n_valid, scale * kqo, adt)
            for c in range(max(1, -(-n_valid // ATTN_SPLIT)))])
        sf = (q.float() * k_f.float()).sum(-1) * (scale * kqo)
        m_fin = torch.maximum(big, sf)
        alpha, pf = torch.exp(big - m_fin), torch.exp(sf - m_fin)
        # the TPU kernel's form (:740-743); kqo is 1 over a float cache
        ctx = (acc * alpha[:, None] * kqo
               + v_f.float() * (kqo * pf)[:, None]) \
            / (tot * alpha + pf)[:, None]
        x = x + project(ctx, "dense")
        # LN2 -> cross-q; cross-attention, the context scaled by
        # kscale / denominator at the end
        h = layer_norm(x, ln[2], ln[3], eps)
        q = affine(gemv(h, pan["crossq"]), ps[3], pb[3]).reshape(H, D)
        kc, vc = cross_cache[layer, 0, 0], cross_cache[layer, 0, 1]
        _, tot, acc = _combine([
            _attn_slice(q, kc, vc, c, sc, scale * kscale, adt)
            for c in range(-(-sc // ATTN_SPLIT))])
        x = x + project(acc * (kscale / tot)[:, None], "crossdense")
        # LN3 -> fc1 + GELU, fc2 over its nf panels accumulated in fp32
        h = layer_norm(x, ln[4], ln[5], eps)
        acc2 = 0.0
        for j in range(nf):
            f = slots["fc1"] + j
            hj = gelu(affine(gemv(h, pan["fc1"] + j), fs[f], fb[f]))
            acc2 = acc2 + gemv(hj, pan["fc2"] + j)
        x = x + affine(acc2, fs[slots["fc2"]], fb[slots["fc2"]])
    return x, fresh


class _MegaArgs(ctypes.Structure):
    """The kernel's ``MegaArgs`` (csrc/decoder_layer.cu), field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "tiles", "pair_scale", "pair_bias", "flat_scale", "flat_bias",
        "ln_par", "self_cache", "cross_cache", "cross_scale", "kv_oq",
        "kv_qo", "seq_len", "hid", "fresh", "act_a", "act_b", "att", "ctx",
        "barrier", "heads")]
        + [("layer_bytes", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "n_layer", "d", "n_head", "s_self", "s_cross", "nflat", "nf",
            "f_dense", "f_crossdense", "f_fc1", "f_fc2", "cross_int8",
            "self_int8", "ring_bytes")]
        + [(n, ctypes.c_int * len(GEMV_STAGES))
           for n in ("item_c", "items", "item_k", "tile_off")]
        + [("scale", ctypes.c_float), ("eps", ctypes.c_float)])


def fused_decoder_stack(x, blobs: MegakernelBlobs, self_cache, seq_len,
                        scale: float, cross_cache=None, cross_scale=None,
                        start_index=None, tail_kv=None,
                        head_dim: int = HEAD_DIM, eps: float = 1e-5,
                        act: str = "gelu", norm: str = "layernorm",
                        gated: bool = False, parallel: bool = False,
                        rope_mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer of one decode step in ONE kernel.

    x [1, d] (embedded token + position); self_cache [L, 1, 2, H, D, S]
    seq-minor, without the fresh token (int8: quantised with
    ``blobs.kv_oq``, read with ``blobs.kv_qo``); seq_len [1] int32
    INCLUDING the fresh token; cross_cache [L, 1, 2, H, D, Sc] with
    per-layer ``cross_scale`` [L] when int8.  Returns (hidden [1, d] before
    the final LN, fresh K/V [L, 2, H, D] in the cache dtype); the cache is
    not written.  On the card: bf16 x, a bf16 or int8 self cache, head dim
    64, and one cooperative launch (a refused launch raises; nothing falls
    back)."""
    _check_modes(x, blobs, self_cache, cross_cache, head_dim, start_index,
                 tail_kv, act, norm, gated, parallel, rope_mat)
    if not x.is_cuda:
        return plain_fused_decoder_stack(x, blobs, self_cache, seq_len,
                                         scale, cross_cache, cross_scale,
                                         head_dim, eps)
    L, _, _, H, D, S = self_cache.shape
    d = x.shape[-1]
    sc = cross_cache.shape[-1]
    dev = x.device
    if D != HEAD_DIM:
        raise NotImplementedError(f"megakernel is built for head dim "
                                  f"{HEAD_DIM}, got {D}")
    if x.dtype != torch.bfloat16 or self_cache.dtype not in (
            torch.bfloat16, torch.int8):
        raise TypeError("megakernel takes bf16 activations and a bf16 or "
                        "int8 self cache")
    self_int8 = self_cache.dtype == torch.int8
    if cross_cache.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"megakernel cross cache dtype {cross_cache.dtype}")
    nf = (blobs.wblob.shape[1] - 6) // 2
    # the kernel reads the caches in 4-byte words: rows of whole words
    word = 4 // cross_cache.element_size()
    if (d % HEAD_DIM or d > MAX_D or nf * d > MAX_FFN
            or S % (4 // self_cache.element_size()) or sc % word
            or max(S, sc) > MAX_SPLITS * ATTN_SPLIT
            or cross_cache.shape[:5] != (L, 1, 2, H, D)):
        raise ValueError(f"megakernel shapes: d {d}, ffn {nf * d}, heads "
                         f"{H}, self {S}, cross {tuple(cross_cache.shape)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = megakernel_plan(d, nf, sms)
    if max(plan["item_c"]) > ITEM_MAX_COLS:
        raise ValueError(f"megakernel: {sms} SMs give items of "
                         f"{max(plan['item_c'])} columns, past "
                         f"{ITEM_MAX_COLS}")
    tiles = blobs.tiles
    if (tiles is None or blobs.tiles_grid != sms
            or tiles.dtype != torch.int8
            or tuple(tiles.shape) != (L, plan["layer_bytes"])):
        raise ValueError("megakernel blobs need the tiles of this card's "
                         "plan: build them with megakernel_tiles(blobs)")
    kv_scales = (blobs.kv_oq, blobs.kv_qo) if self_int8 else ()
    for t in (self_cache, cross_cache, tiles, *blobs[1:6], *kv_scales):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("megakernel operands must be contiguous on "
                             f"{dev}")
    if (not torch.is_tensor(seq_len) or seq_len.numel() != 1
            or seq_len.device != dev):
        raise TypeError(f"seq_len must be a [1] tensor on {dev}")
    # every tensor the kernel reads or writes is held in a local until the
    # launch is enqueued (a freed temporary could be reused and overwritten
    # on the stream first)
    seq_t = seq_len.reshape(1).to(torch.int32).contiguous()
    xin = x.reshape(d).contiguous()
    cs_t = None
    if cross_scale is not None and cross_cache.dtype == torch.int8:
        cs_t = torch.as_tensor(cross_scale, dtype=torch.float32,
                               device=dev).reshape(L).contiguous()
    hid = torch.empty((1, d), dtype=torch.bfloat16, device=dev)
    fresh = torch.empty((L, 2, H, D), dtype=self_cache.dtype, device=dev)
    # finished GEMV outputs: q, k, v / cross-q / GELU(fc1) and dense /
    # cross-dense / fc2
    act_a = torch.empty((max(3, nf) * d,), dtype=torch.float32, device=dev)
    act_b = torch.empty((d,), dtype=torch.float32, device=dev)
    att = torch.empty((H * MAX_SPLITS * (D + 2),), dtype=torch.float32,
                      device=dev)
    ctx = torch.empty((d,), dtype=torch.float32, device=dev)
    # the grid barrier's arrivals, then each head's finished attention
    # slices (self and cross, every layer): zeros, one call's
    sync = torch.zeros((1 + 2 * L * H,), dtype=torch.int32, device=dev)
    slots = _flat_slots(nf)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ints(key):
        return (ctypes.c_int * len(GEMV_STAGES))(*plan[key])

    args = _MegaArgs(
        ptr(xin), ptr(tiles), ptr(blobs.pair_scale),
        ptr(blobs.pair_bias), ptr(blobs.flat_scale), ptr(blobs.flat_bias),
        ptr(blobs.ln_par), ptr(self_cache), ptr(cross_cache), ptr(cs_t),
        *(ptr(t) for t in kv_scales or (None, None)), ptr(seq_t), ptr(hid), ptr(fresh), ptr(act_a), ptr(act_b),
        ptr(att), ptr(ctx), ptr(sync), ptr(sync) + 4, plan["layer_bytes"],
        L, d, H, S, sc, blobs.flat_scale.shape[1], nf,
        slots["dense"], slots["crossdense"], slots["fc1"], slots["fc2"],
        int(cross_cache.dtype == torch.int8), int(self_int8),
        plan["ring_cap"],
        ints("item_c"), ints("items"), ints("item_k"), ints("tile_off"),
        float(scale), float(eps))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.load("decoder_layer")
    _build.check(lib.decoder_megakernel(ctypes.byref(args), stream),
                 "decoder_megakernel (cooperative launch)")
    launches["decoder_megakernel"] += 1
    return hid, fresh
