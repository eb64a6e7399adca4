"""The whole decode step of a decoder (every layer) in one kernel.

Counterpart of the JAX package's ``ops/pallas_decoder_layer.py``
(``fused_decoder_stack``, :865) at batch 1, in two sets of modes:

* Whisper's decoder (``with_cross``): weight-only panels, int8 with
  per-channel scales or int4 (the half-split nibbles of each [d, d]
  panel, ``wblob`` [L, NPAN, d/2, d]) with per-channel scales or group
  scales ``gscale`` [L, NPAN, NG, d] whose group divides d/2, or float
  panels (bf16 on the card) with unit scales; LayerNorm, tanh GELU,
  cross-attention over an int8 (or float) cross cache with per-layer
  scales;
* the decoder-only families (GPT-2, OPT, LLaMA, GPT-J, GPT-NeoX): no
  cross-attention, int8 weight-only or float (bf16 on the card) panels
  with unit scales, LayerNorm or RMSNorm, the gated MLP act(fc) * gate,
  the parallel residual (the MLP reads the input norm), RoPE on q and the
  fresh k (GPT-NeoX halves or GPT-J interleaved pairs, a partial rotary
  dim, the angles from ``write_index`` less the start held on the device),
  the activations tanh GELU, ReLU, erf GELU and SiLU, head dim 64 or 128,
  and the grouped (MQA/GQA) mode at head dim 128 (SantaCoder / StarCoder,
  GQA LLaMA): the qkv stage's d + 2 dkv columns (dkv = Hkv x head dim;
  the blobs' ``kvblob`` [L, d, 2 dkv] holds the K and V columns beside the
  q panel, not padded to a [d, d] panel as the TPU's are), each query
  head h reading KV head h // rep of a cache of Hkv heads, the fresh K/V
  [L, 2, Hkv, D];

both over a float, int8 or fp8 (e4m3) self cache with the fresh token's
K/V (int8: the fresh K/V quantised with the blobs' per-layer ``kv_oq``,
the cache and the fresh column dequantised with ``kv_qo``, as the TPU
kernel's ``self_quant`` mode; e4m3: the same scales around the saturating
cast, the fresh column's score and value taken from the values it stores,
as the TPU kernel's ``self_fp8`` mode), keys below the start index
masked.  On a CUDA
tensor the wrapper makes ONE cooperative launch of the kernel of
``csrc/decoder_layer.cu`` (the decoder-only set and Whisper's set, one
and their e4m3 self-cache instantiations, are four libraries built from
it: ``decoder_stack``, ``decoder_layer``, ``decoder_stack_fp8`` and
``decoder_layer_fp8``, :func:`library_name`), which
reads its GEMV weights from the blobs' ``tiles`` (:func:`megakernel_tiles`,
cut by :func:`megakernel_plan` for the card's SM count); on a CPU tensor
it runs the plain version, :func:`plain_fused_decoder_stack`, which runs
the kernel's stages with its attention slices and rounding points.

Not ported, and raising ``NotImplementedError``: int4 panels without
cross-attention (the JAX package keeps decoder-only int4 off its
megakernel, ``woq_block_eligible(allow_int4=False)``), a group that does
not divide d/2, group scales on int8 or float panels, the gated MLP with
cross-attention (the JAX kernel refuses it too), the grouped mode with
cross-attention or at head dim 64 (the JAX kernel refuses both), an fp8
cross cache (no JAX path makes one), the K-step tail and batch > 1.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..functional import (ACT2FN, apply_rope, layer_norm, matmul_fp32,
                          rms_norm, rope_angles, rope_freqs, round_half_away)
from . import _build
from .attention import FP8, NEG, cache_kind, quantize_cache_values
from .quant_matmul import unpack_int4

# launches of the CUDA kernel, counted where the wrapper launches it
launches = {"decoder_megakernel": 0}

# the kernel's attention split, mirrored here: ATTN_SPLIT-column slices of
# the cache, any number a head without cross-attention (Whisper's caches:
# at most MAX_SPLITS); a head's finish combines MAX_SPLITS of them, the
# MAX_SPLITS-th and later ones folded into one first (the plain version
# combines its attention slices the same way)
ATTN_SPLIT = 256
MAX_SPLITS = 8
# Whisper's head dim (the set with cross-attention is built for it); the
# decoder-only set's
HEAD_DIM = 64
HEAD_DIMS = (64, 128)
# the GEMV stages of a layer, in the kernel's order (``Stage`` in
# csrc/decoder_layer.cu); the gated MLP's gate rides fc1's stage
GEMV_STAGES = ("qkv", "dense", "crossq", "crossdense", "fc1", "fc2")
# the kernel's limits: a thread of the decoder-only set holds 8 elements
# of a d-row (d <= 2048) and 24 of fc2's input row (ffn padded to a
# multiple of d up to 6144 in one round of loads, up to 8192 with a
# second: SantaCoder-1B's), its items are at most 64 columns (8192 columns
# need 128 SMs), summed in pieces of at most 48 (a warp sums 6)
MAX_D, MAX_FFN, ITEM_MAX_COLS, PIECE_MAX_COLS = 2048, 8192, 64, 48
# Whisper's set (with cross-attention) holds 5 and 20 (d <= 1280, ffn <=
# 5120: Whisper large), its items whole pieces (at most 48 columns)
MAX_D_CROSS, MAX_FFN_CROSS = 1280, 5120
# an item is streamed into the ring in pieces of whole columns, of at most
# these bytes (or one column)
PIECE_BYTES = 65536
# the activations of the kernel's epilogue, by their code (MegaArgs::act)
ACTIVATIONS = ("gelu", "relu", "gelu_exact", "silu")

# state-dict key prefixes of the Whisper ResidualAttentionBlock and of the
# decoder-only DecoderBlock (the JAX packer's WHISPER_KEYS, DECODER_KEYS;
# under the parallel residual ``ln`` is the input norm alone)
WHISPER_KEYS = dict(qkv="attn.qkv", dense="attn.dense",
                    crossq="cross_attn.q_linear",
                    crossdense="cross_attn.dense",
                    fc1="mlp1", fc2="mlp2",
                    ln=("attn_ln", "cross_attn_ln", "mlp_ln"),
                    kv="attn")
DECODER_KEYS = dict(qkv="attention.qkv", dense="attention.dense",
                    fc1="mlp.fc", fc2="mlp.proj", gate="mlp.gate",
                    ln=("input_layernorm", "post_layernorm"),
                    kv="attention")


class Rotary(NamedTuple):
    """RoPE of a megakernel step: the fresh token's cache column (its
    position is that less the row's start, floored at 0), the rotated
    channels of a head, the base and the style (GPT-NeoX halves, or GPT-J
    interleaved pairs)."""
    write_index: int
    rotary_dim: int
    theta: float = 10000.0
    neox: bool = True


def reset_launches() -> None:
    launches["decoder_megakernel"] = 0


class MegakernelBlobs(NamedTuple):
    """Packed per-layer weights of :func:`fused_decoder_stack` (the JAX
    package's layout and names)."""
    # [L, NPAN, d, d] K-major panels, int8 or float, or int4 [L, NPAN, d/2,
    # d] (each panel's half-split nibbles: byte i of a column holds K rows
    # i and i + d/2); a meta tensor, type and shape only, where the tiles
    # alone hold the weights
    wblob: torch.Tensor
    pair_scale: torch.Tensor   # [L, NQ, d/128, 128] f32: q, k, v (, cross-q)
    pair_bias: torch.Tensor    # [L, NQ, d/128, 128] f32
    flat_scale: torch.Tensor   # [L, NF, d] f32: dense (, cross-dense),
    flat_bias: torch.Tensor    # [L, NF, d] f32  fc1.., (gate..,) fc2
    ln_par: torch.Tensor       # [L, 2 n_ln, d] f32: weight, bias of each norm
    kv_oq: torch.Tensor        # [L] f32 self-KV quantise scale (int8 cache)
    kv_qo: torch.Tensor        # [L] f32 self-KV dequantise scale
    # int4 group scales [L, NPAN, NG, d] f32 (NG groups of d / NG K rows a
    # panel; pair_scale and flat_scale then hold ones), None per channel
    gscale: Optional[torch.Tensor] = None
    # the kernel's item-contiguous copy of wblob [L, layer_bytes / itemsize]
    # in wblob's type and the grid it was cut for (:func:`megakernel_tiles`;
    # the card only)
    tiles: Optional[torch.Tensor] = None
    tiles_grid: Optional[int] = None
    # the grouped (MQA/GQA) mode: the K and V columns [L, d, 2 dkv]
    # K-major, in wblob's type (wblob then lacks the k and v panels); None
    # with equal heads
    kvblob: Optional[torch.Tensor] = None


def blob_layout(blobs: "MegakernelBlobs") -> Tuple[bool, bool, int]:
    """(with_cross, gated, nf) of packed blobs, from their slot counts: 4
    pair rows with cross-attention, 3 without; NPAN = 6 + 2 nf with it,
    4 + 2 nf or (gated) 4 + 3 nf without (2 + .. in the grouped mode,
    whose k and v are ``kvblob``), and NF = 2 + nf or 2 + 2 nf.  Blobs
    whose scales are placeholders (not [L, NQ, d/128, 128]) read as the
    Whisper layout."""
    npan = blobs.wblob.shape[1]
    if blobs.pair_scale.dim() != 4 or blobs.pair_scale.shape[1] == 4:
        return True, False, (npan - 6) // 2
    nflat = blobs.flat_scale.shape[1]
    nf = (npan - (2 if blobs.kvblob is not None else 4)) - (nflat - 2)
    return False, nflat - 2 == 2 * nf, nf


def blob_int4(blobs: "MegakernelBlobs") -> Optional[int]:
    """The groups of a panel (0: per-channel scales) of int4 blobs, None
    for int8 or float panels."""
    w = blobs.wblob
    if w.shape[2] != w.shape[3] // 2:
        return None
    return 0 if blobs.gscale is None else blobs.gscale.shape[2]


def int4_item_bytes(c: int, k: int, d: int, groups: int) -> int:
    """Bytes of an int4 item of ``c`` columns by ``k`` rows of K (a panel
    of width ``d``, ``groups`` scale groups a panel): the nibbles, then
    the columns' group scales in bf16, padded to 16 bytes."""
    return c * k // 2 + -(-(c * (k // d) * groups * 2) // 16) * 16


def blob_kv_width(blobs: "MegakernelBlobs") -> Optional[int]:
    """dkv (KV heads x head dim) of grouped blobs, None with equal
    heads."""
    return None if blobs.kvblob is None else blobs.kvblob.shape[2] // 2


def megakernel_plan(d: int, nf: int, sms: int, with_cross: bool = True,
                    gated: bool = False, itemsize: int = 1,
                    dkv: Optional[int] = None,
                    int4: Optional[int] = None) -> Dict[str, list]:
    """The megakernel's GEMV items for width ``d``, ``nf`` fc panels, a grid
    of ``sms`` blocks and weights of ``itemsize`` bytes (or, ``int4`` not
    None, int4 weights with ``int4`` scale groups a panel, 0 per channel):
    per stage of :data:`GEMV_STAGES`, ``item_c`` output columns an item by
    all ``item_k`` rows of K, ``items`` items (at most one a block: c =
    ceil(columns / sms), so each stage is one wave), ``tile_off`` the
    stage's byte offset in a layer's tiles and ``layer_bytes`` a layer's
    (the last item's columns past the stage's are zeros; the gated fc1
    item is its c fc columns, then the same c gate columns; an int4 item
    :func:`int4_item_bytes`), ``piece_c`` the columns of each load into
    the ring (whole columns of at most PIECE_BYTES and at most
    PIECE_MAX_COLS; Whisper's int8 and int4 items whole), and ``ring_cap``
    the bytes of the shared-memory ring (0: all the block's shared memory
    left).  Without cross-attention its two
    stages have no items.  The qkv stage has d + 2 ``dkv`` columns (3 d
    with equal heads).  The C entry refuses any other plan."""
    cols = (d + 2 * (dkv or d), d, d, d, nf * d, d)
    ks = (d, d, d, d, d, nf * d)
    plan = dict(item_c=[], items=[], item_k=list(ks), tile_off=[],
                piece_c=[])
    off = 0
    for g, (n, k) in enumerate(zip(cols, ks)):
        plan["tile_off"].append(off)
        if not with_cross and g in (2, 3):
            for f in ("item_c", "items", "piece_c"):
                plan[f].append(0)
            continue
        c = -(-n // sms)
        items = -(-n // c)
        plan["item_c"].append(c)
        plan["items"].append(items)
        whole = int4 is not None or (with_cross and itemsize == 1)
        plan["piece_c"].append(c if whole else min(
            c, PIECE_MAX_COLS, max(1, PIECE_BYTES // (k * itemsize))))
        item = (c * k * itemsize if int4 is None
                else int4_item_bytes(c, k, d, int4))
        off += item * items * (2 if gated and g == 4 else 1)
    plan["layer_bytes"] = off
    plan["ring_cap"] = 0
    return plan


def _stage_weights(wblob: torch.Tensor, with_cross: bool = True,
                   gated: bool = False, kvblob=None):
    """Each GEMV stage's weight of every layer transposed, [L, columns, K]
    (K contiguous), from the K-major panels [L, NPAN, k, d] (k = d; or the
    panels' group scales, k = NG, and K their rows) (and, grouped, the K
    and V columns ``kvblob`` [L, d, 2 dkv] after q's); None for a stage the
    model has not, (fc, gate) for the gated fc1 stage."""
    L, npan, k, d = wblob.shape
    grouped = kvblob is not None
    base = 6 if with_cross else 2 if grouped else 4
    nf = (npan - base) // (3 if gated else 2)
    pan = _panels(nf, with_cross, gated, grouped)

    def cols(p0, n):                     # panels p0.. side by side
        return wblob[:, p0:p0 + n].transpose(2, 3).reshape(L, n * d, k)

    def one(p):
        return wblob[:, p].transpose(1, 2)
    fc1 = cols(pan["fc1"], nf)
    if gated:
        fc1 = (fc1, cols(pan["gate"], nf))
    qkv = (torch.cat([one(pan["q"]), kvblob.transpose(1, 2)], dim=1)
           if grouped else cols(pan["q"], 3))
    return [qkv, one(pan["dense"]),
            one(pan["crossq"]) if with_cross else None,
            one(pan["crossdense"]) if with_cross else None, fc1,
            wblob[:, pan["fc2"]:pan["fc2"] + nf].reshape(L, nf * k, d)
            .transpose(1, 2)]


def _int4_words(q: torch.Tensor) -> torch.Tensor:
    """int4 values [..., K] (int8 in [-8, 7]) -> the tiles' bytes [..., K/2]:
    each 4-byte word holds 8 rows of K, nibble p (bits 4p..4p+3) row 2p and
    nibble p + 4 row 2p + 1 (p < 4), each the value plus 8 (0..15), so that
    (word >> 4p) & 0x000F000F are rows 2p and 2p + 1 in the two halves of a
    bf16 pair."""
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    u = u.reshape(*q.shape[:-1], -1, 4, 2).transpose(-1, -2)
    u = u.reshape(*q.shape[:-1], -1, 2, 2, 2)          # parity, pair, nibble
    return (u[..., 0] | (u[..., 1] << 4)).reshape(
        *q.shape[:-1], -1).view(torch.int8)


def _int4_values(b: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_int4_words`: tile bytes [..., K/2] -> int8
    values [..., K]."""
    u = b.view(torch.uint8).reshape(*b.shape[:-1], -1, 2, 2)
    u = torch.stack([u & 0xF, u >> 4], dim=-1)        # parity, pair, nibble
    u = u.reshape(*b.shape[:-1], -1, 2, 4).transpose(-1, -2)
    return (u.reshape(*b.shape[:-1], -1).to(torch.int16) - 8).to(torch.int8)


def megakernel_tiles(blobs: "MegakernelBlobs", sms: Optional[int] = None
                     ) -> "MegakernelBlobs":
    """``blobs`` with ``tiles``: the panels of ``wblob`` repacked once into
    the kernel's item-contiguous layout for a grid of ``sms`` blocks (the
    SM count of wblob's card by default): per layer, per stage of
    :data:`GEMV_STAGES` the model has, ``items`` items of ``item_c``
    columns, each its columns' K rows contiguous (the gated fc1 item its
    fc columns, then its gate columns; :func:`megakernel_plan`).  int4
    panels: each column's K rows in :func:`_int4_words`' bytes, then the
    item's group scales [c, K / group] in bf16 (the kernel's activation
    type, to which the TPU kernel rounds them), padded to 16 bytes."""
    w = blobs.wblob
    L, _, _, d = w.shape
    with_cross, gated, nf = blob_layout(blobs)
    int4 = blob_int4(blobs)
    if sms is None:
        sms = torch.cuda.get_device_properties(
            w.device).multi_processor_count
    plan = megakernel_plan(d, nf, sms, with_cross, gated, w.element_size(),
                           blob_kv_width(blobs), int4)
    if int4 is not None:
        w = unpack_int4(w)
    gs = (None if not int4 else
          _stage_weights(blobs.gscale, with_cross, gated))
    parts = []
    for g, m in enumerate(_stage_weights(w, with_cross, gated,
                                         blobs.kvblob)):
        if m is None:
            continue
        c, n = plan["item_c"][g], plan["items"][g]
        mats = m if isinstance(m, tuple) else (m,)
        padded = [torch.nn.functional.pad(t, (0, 0, 0, c * n - t.shape[1]))
                  .reshape(L, n, c, -1) for t in mats]
        if int4 is None:
            parts.append(torch.cat(padded, dim=2).reshape(L, -1))
            continue
        item = [_int4_words(padded[0]).reshape(L, n, -1)]
        if int4:
            sc = torch.nn.functional.pad(gs[g], (0, 0, 0, c * n
                                                 - gs[g].shape[1]), value=1.0)
            sc = sc.to(torch.bfloat16).reshape(L, n, -1).view(torch.int8)
            item.append(torch.nn.functional.pad(sc, (0, -sc.shape[2] % 16)))
        parts.append(torch.cat(item, dim=2).reshape(L, -1))
    return blobs._replace(tiles=torch.cat(parts, dim=1).contiguous(),
                          tiles_grid=sms)


def untile(tiles: torch.Tensor, plan: Dict[str, list], stage: int,
           mat: int = 0, gated: bool = False, int4: Optional[int] = None):
    """Stage ``stage``'s weight [L, K, columns] (K-major, as the panels
    hold it) read back from tiles [L, layer_bytes / itemsize] laid out by
    ``plan``, the padding columns included (the gated fc1 stage: its fc,
    ``mat`` 0, or its gate, 1).  int4 tiles (``int4`` the groups of a
    panel): (the int8 values [L, K, columns], the bf16 group scales [L,
    K / group, columns], or None per channel)."""
    c, n, k = (plan[f][stage] for f in ("item_c", "items", "item_k"))
    off = plan["tile_off"][stage] // tiles.element_size()
    L = tiles.shape[0]
    if int4 is not None:
        d = plan["item_k"][0]
        size = int4_item_bytes(c, k, d, int4)
        t = tiles[:, off:off + n * size].reshape(L, n, size)
        q = _int4_values(t[..., :c * k // 2].reshape(L, n, c, k // 2))
        q = q.reshape(L, c * n, k).transpose(1, 2)
        if not int4:
            return q, None
        ng = int4 * k // d
        sc = t[..., c * k // 2:c * k // 2 + 2 * c * ng].contiguous().view(
            torch.bfloat16).reshape(L, c * n, ng).transpose(1, 2)
        return q, sc
    mats = 2 if gated and stage == 4 else 1
    t = tiles[:, off:off + mats * c * n * k].reshape(L, n, mats, c, k)
    return t[:, :, mat].reshape(L, c * n, k).transpose(1, 2)


def blob_layers(blobs: "MegakernelBlobs", lo: int, hi: int
                ) -> "MegakernelBlobs":
    """The layers lo..hi-1 of ``blobs`` (every per-layer tensor sliced)."""
    return blobs._replace(**{
        f: v[lo:hi] for f, v in blobs._asdict().items()
        if torch.is_tensor(v)})


# the wblob panel of each projection (the JAX package's ``_panel_of``);
# fc1 (, gate) and fc2 take nf panels each from the one named; grouped,
# k and v are the blobs' kvblob
def _panels(nf: int, with_cross: bool = True,
            gated: bool = False, grouped: bool = False) -> Dict[str, int]:
    if with_cross:
        return dict(q=0, k=1, v=2, dense=3, crossq=4, crossdense=5, fc1=6,
                    fc2=6 + nf)
    if grouped:
        return dict(q=0, dense=1, fc1=2, gate=2 + nf,
                    fc2=2 + (2 * nf if gated else nf))
    return dict(q=0, k=1, v=2, dense=3, fc1=4, gate=4 + nf,
                fc2=4 + (2 * nf if gated else nf))


# flat scale/bias slots: dense (, cross-dense), the fc1 slices, (the gate
# slices,) fc2
def _flat_slots(nf: int, with_cross: bool = True,
                gated: bool = False) -> Dict[str, int]:
    if with_cross:
        return dict(dense=0, crossdense=1, fc1=2, gate=2, fc2=2 + nf)
    return dict(dense=0, crossdense=0, fc1=1, gate=1 + nf,
                fc2=1 + (2 * nf if gated else nf))


def woq_block_eligible(qkv, mods, hidden: int,
                       allow_int4: bool = True) -> bool:
    """The JAX package's check (``pallas_decoder_layer.py:242-278``): every
    projection of the block weight-only, uniformly int8 per output channel
    or uniformly int4 with one group size (0: per channel) that divides
    d/2, so that each K group lies in one nibble plane of a panel's
    half-split packing.  ``allow_int4`` False (the decoder-only models,
    as the JAX package's) refuses int4."""
    from ..quantization.layers import (WeightOnlyQuantLinear,
                                       WeightOnlyQuantQKVLinear)
    if not isinstance(qkv, WeightOnlyQuantQKVLinear):
        return False
    bits = {qkv.bits} | {getattr(m, "bits", None) for m in mods}
    if bits == {4} and not allow_int4:
        return False
    if bits not in ({8}, {4}):
        return False
    groups = {qkv.group_size} | {getattr(m, "group_size", None)
                                 for m in mods}
    if len(groups) != 1:
        return False
    gs = groups.pop()
    if gs and (8 in bits or hidden % (2 * gs)):
        return False
    return all(isinstance(m, WeightOnlyQuantLinear) for m in mods)


def kernel_takes(dtype, d: int, nf: int, head_dim: int) -> bool:
    """Whether the CUDA kernel's decoder-only set takes a model: bf16
    activations, heads of 64 or 128, d a multiple of 128 up to MAX_D and
    the ffn padded to a multiple of d up to MAX_FFN."""
    return (dtype == torch.bfloat16 and head_dim in HEAD_DIMS
            and d % 128 == 0 and d <= MAX_D and nf * d <= MAX_FFN)


def pack_decoder_blobs(state: dict, *, n_layer: int, hidden: int,
                       n_head: int, head_dim: int, ffn: int,
                       with_cross: bool = True, gated: bool = False,
                       n_kv_head: Optional[int] = None,
                       keys: Optional[dict] = None, device=None
                       ) -> MegakernelBlobs:
    """The megakernel's weight image from a stacked block state dict (keys
    of ``keys``, by default :data:`WHISPER_KEYS` with cross-attention and
    :data:`DECODER_KEYS` without, lacking the ``blocks.`` prefix; numpy
    arrays or tensors): int8 weight-only (``attn.qkv.qweight`` [L, d, 3d],
    ``mlp1.qweight`` [L, d, ffn], ...), float (``attn.qkv.weight`` [L, 3,
    H, D, d], ``mlp1.weight`` [L, ffn, d], ...: transposed to K-major
    panels of the weights' type, with unit scales) or, with
    cross-attention, int4 weight-only (``qweight`` [L, in/2, out] in the
    matrix's half-split nibbles, scales [L, out] or group scales [L, in/G,
    out]: unpacked, cut into panels and each panel re-packed half-split
    along its own K rows, ``wblob`` [L, NPAN, d/2, d]; group scales cut as
    the panels into ``gscale`` [L, NPAN, d/G, d], qkv and fc1 by output
    columns, fc2 by K groups, the padding ones, with unit pair and flat
    scales).  A pure relayout, equal bit for bit to the JAX package's
    ``pack_decoder_blobs`` on the same state: q/k/v, fc1 and the gate are
    cut along their output columns into [d, d] panels, fc2 along its input
    rows; ffn is zero-padded to a multiple of d.

    Grouped (``n_kv_head`` < ``n_head``, MQA/GQA): the separate-KV layout
    (``attention.qkv.weight`` [L, H, D, d] + ``kv_weight`` [L, 2, Hkv, D,
    d], or one int8 qweight [L, d, d + 2 dkv] with its columns q | k | v)
    gives the q panel and ``kvblob`` [L, d, 2 dkv] (K, then V columns):
    the JAX packer's combined k/v panel without its zero padding to
    [d, d]; the k and v pair rows are [L, d/128, 128] with their first
    dkv / 128 rows filled and zeros after, as the JAX packer's.  Head dim
    128 and 2 dkv <= d only, as there."""
    n_kv_head = n_kv_head or n_head
    grouped = n_kv_head != n_head
    dkv = n_kv_head * head_dim
    if grouped and (with_cross or head_dim != 128 or 2 * dkv > hidden
                    or n_head % n_kv_head):
        raise NotImplementedError(
            f"the megakernel's grouped mode: {n_head} query heads over "
            f"{n_kv_head} KV heads of {head_dim}, cross-attention "
            f"{with_cross} (it takes heads of 128, 2 dkv <= d and no "
            "cross-attention)")
    if gated and with_cross:
        raise NotImplementedError("no gated decoder has cross-attention")
    kk = keys or (WHISPER_KEYS if with_cross else DECODER_KEYS)
    quantized = kk["qkv"] + ".qweight" in state
    L, d = n_layer, hidden
    hp, dl = d // 128, 128
    nf = -(-ffn // d)
    pffn = nf * d
    f32 = torch.float32
    if device is None:
        # the state's own device (the zeros and ones made here join it)
        device = next((v.device for v in state.values()
                       if torch.is_tensor(v)), None)

    def g(key):
        v = state[key]
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return t if device is None else t.to(device)

    bits4 = quantized and g(kk["qkv"] + ".qweight").shape[-2] == d // 2
    grouped4 = bits4 and g(kk["qkv"] + ".per_channel_scale").dim() == 3
    if bits4 and not with_cross:
        raise NotImplementedError("int4 megakernel panels without "
                                  "cross-attention (the JAX package keeps "
                                  "decoder-only int4 off the megakernel)")

    def zeros_or(key, shape):
        v = state.get(key)
        if v is None:
            return torch.zeros(shape, dtype=f32, device=device)
        return g(key).to(f32)

    def scale(key, shape):     # unit scales for float panels and groups
        if not quantized or grouped4:
            return torch.ones(shape, dtype=f32, device=device)
        return g(key + ".per_channel_scale").to(f32)

    def weight(key):                     # K-major [L, in, out]
        if quantized:
            return maybe_unpack(g(key + ".qweight"))
        return g(key + ".weight").transpose(-1, -2)

    def maybe_unpack(w):                 # int4 [L, in/2, out] -> [L, in, out]
        return unpack_int4(w) if bits4 else w

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

    kvblob = None
    if quantized:
        qkv_w = maybe_unpack(g(kk["qkv"] + ".qweight"))
        if grouped:                      # [L, d, d + 2 dkv]: q | k | v
            qkv_panels = [qkv_w[:, :, 0:d]]
            kvblob = qkv_w[:, :, d:].contiguous()
        else:
            qkv_panels = [qkv_w[:, :, 0:d], qkv_w[:, :, d:2 * d],
                          qkv_w[:, :, 2 * d:]]
    elif grouped:
        # q [L, H, D, d] and kv [L, 2, Hkv, D, d] -> the K-major q panel
        # and the K | V columns
        qkv_panels = [g(kk["qkv"] + ".weight").reshape(L, d, d)
                      .transpose(-1, -2)]
        kvblob = g(kk["qkv"] + ".kv_weight").reshape(
            L, 2 * dkv, d).transpose(-1, -2).contiguous()
    else:
        # head-major [L, 3, H, D, d] -> three K-major [L, d, d] panels
        qkv_hm = g(kk["qkv"] + ".weight").reshape(L, 3, d, d)
        qkv_panels = [qkv_hm[:, i].transpose(-1, -2) for i in range(3)]
    fc1 = pad_cols(weight(kk["fc1"]))
    fc2 = pad_rows(weight(kk["fc2"]))
    panels = qkv_panels + [weight(kk["dense"])]
    if with_cross:
        panels += [weight(kk["crossq"]), weight(kk["crossdense"])]
    panels += [fc1[:, :, j * d:(j + 1) * d] for j in range(nf)]
    if gated:
        gate = pad_cols(weight(kk["gate"]))
        panels += [gate[:, :, j * d:(j + 1) * d] for j in range(nf)]
    panels += [fc2[:, j * d:(j + 1) * d, :] for j in range(nf)]
    wblob = torch.stack(panels, dim=1)
    if bits4:
        # each [d, d] panel re-packed half-split along its own K rows
        wblob = (wblob[:, :, :d // 2] & 0xF) | (
            (wblob[:, :, d // 2:] & 0xF) << 4)
    wblob = wblob.contiguous()

    gscale = None
    if grouped4:
        # [L, NPAN, NG, d]: qkv, dense, cross-q, cross-dense and fc1 by
        # output columns (fc1's padding ones), fc2 by K groups
        qkv_gs = g(kk["qkv"] + ".per_channel_scale").to(f32)
        ng = qkv_gs.shape[1]
        fc1_gs = g(kk["fc1"] + ".per_channel_scale").to(f32)
        if pffn != ffn:
            fc1_gs = torch.cat([fc1_gs, fc1_gs.new_ones(
                (L, ng, pffn - ffn))], dim=2)
        fc2_gs = g(kk["fc2"] + ".per_channel_scale").to(f32)
        if fc2_gs.shape[1] != nf * ng:
            fc2_gs = torch.cat([fc2_gs, fc2_gs.new_ones(
                (L, nf * ng - fc2_gs.shape[1], d))], dim=1)
        gsp = [qkv_gs[:, :, 0:d], qkv_gs[:, :, d:2 * d], qkv_gs[:, :, 2 * d:],
               g(kk["dense"] + ".per_channel_scale").to(f32),
               g(kk["crossq"] + ".per_channel_scale").to(f32),
               g(kk["crossdense"] + ".per_channel_scale").to(f32)]
        gsp += [fc1_gs[:, :, j * d:(j + 1) * d] for j in range(nf)]
        gsp += [fc2_gs[:, j * ng:(j + 1) * ng, :] for j in range(nf)]
        gscale = torch.stack(gsp, dim=1).contiguous()

    def to_pair(p):          # [L, d or dkv] -> [L, hp, dl], zeros after
        r = p.reshape(L, -1, dl)
        if r.shape[1] < hp:
            r = torch.cat([r, r.new_zeros((L, hp - r.shape[1], dl))], dim=1)
        return r

    if grouped:
        qkv_s = scale(kk["qkv"], (L, d + 2 * dkv))
        q_b = zeros_or(kk["qkv"] + ".bias",
                       (L, n_head, head_dim)).reshape(L, d)
        kv_b = zeros_or(kk["qkv"] + ".kv_bias",
                        (L, 2, n_kv_head, head_dim)).reshape(L, 2 * dkv)
        pair_s = [qkv_s[:, 0:d], qkv_s[:, d:d + dkv], qkv_s[:, d + dkv:]]
        pair_b = [q_b, kv_b[:, :dkv], kv_b[:, dkv:]]
    else:
        qkv_s = scale(kk["qkv"], (L, 3 * d))                    # [L, 3d]
        qkv_b = zeros_or(kk["qkv"] + ".bias",
                         (L, 3, n_head, head_dim)).reshape(L, 3 * d)
        pair_s = [qkv_s[:, 0:d], qkv_s[:, d:2 * d], qkv_s[:, 2 * d:]]
        pair_b = [qkv_b[:, 0:d], qkv_b[:, d:2 * d], qkv_b[:, 2 * d:]]
    if with_cross:
        pair_s.append(scale(kk["crossq"], (L, d)))
        pair_b.append(zeros_or(kk["crossq"] + ".bias", (L, d)))
    pair_scale = torch.stack([to_pair(p) for p in pair_s], dim=1)
    pair_bias = torch.stack([to_pair(p) for p in pair_b], dim=1)

    flat_s = [scale(kk["dense"], (L, d))]
    flat_b = [zeros_or(kk["dense"] + ".bias", (L, d))]
    if with_cross:
        flat_s.append(scale(kk["crossdense"], (L, d)))
        flat_b.append(zeros_or(kk["crossdense"] + ".bias", (L, d)))
    mlp_in = [kk["fc1"]] + ([kk["gate"]] if gated else [])
    for key in mlp_in:
        s_ = pad_flat(scale(key, (L, ffn)), 1.0)
        b_ = pad_flat(zeros_or(key + ".bias", (L, ffn)), 0.0)
        flat_s += [s_[:, j * d:(j + 1) * d] for j in range(nf)]
        flat_b += [b_[:, j * d:(j + 1) * d] for j in range(nf)]
    flat_s.append(scale(kk["fc2"], (L, d)))
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
                           flat_bias, ln_par, kv_oq, kv_qo, gscale,
                           kvblob=kvblob)


def _check_modes(x, blobs: MegakernelBlobs, self_cache, cross_cache,
                 head_dim: int, tail_kv, act: str, norm: str,
                 gated: bool) -> None:
    """Raise ``NotImplementedError`` for every mode outside this port, and
    ``ValueError`` where the blobs were packed for another mode."""
    d = x.shape[-1]
    with_cross = cross_cache is not None
    if blobs.wblob.shape[2] not in (d, d // 2) or blobs.wblob.shape[3] != d:
        raise ValueError(f"megakernel panels {tuple(blobs.wblob.shape)} "
                         f"for width {d}")
    int4 = blob_int4(blobs)
    group = d // int4 if int4 else 0
    outside = [
        (x.shape[0] != 1 or self_cache.shape[1] != 1, "batch > 1"),
        (tail_kv is not None, "the K-step decode tail"),
        (norm not in ("layernorm", "rmsnorm"), f"norm {norm!r}"),
        (act not in ACTIVATIONS, f"activation {act!r}"),
        (with_cross and gated, "the gated MLP with cross-attention"),
        (int4 is not None and not with_cross,
         "int4 panels without cross-attention (the decoder-only set)"),
        (int4 is None and blobs.gscale is not None,
         "group-wise scales on int8 or float panels"),
        (bool(int4) and (d % int4 or (d // 2) % group),
         f"int4 groups of {group} rows that do not divide d/2 = {d // 2}"),
        (with_cross and cross_cache.dtype == FP8, "an fp8 cross cache"),
        (self_cache.shape[3] * head_dim != d
         and (with_cross or head_dim != 128),
         "the grouped (MQA/GQA) mode with cross-attention or heads other "
         "than 128"),
    ]
    for bad, what in outside:
        if bad:
            raise NotImplementedError(f"megakernel: {what} is not ported")
    if int4 is not None and blobs.wblob.dtype != torch.int8:
        raise ValueError(f"int4 panels of {blobs.wblob.dtype}: packed int8")
    b_cross, b_gated, _ = blob_layout(blobs)
    if (b_cross, b_gated) != (with_cross, gated):
        raise ValueError(f"megakernel blobs packed with cross-attention "
                         f"{b_cross} and gated {b_gated}, called with "
                         f"{with_cross} and {gated}")
    dkv = self_cache.shape[3] * head_dim
    if (blob_kv_width(blobs) or d) != dkv:
        raise ValueError(f"megakernel blobs packed for "
                         f"{blob_kv_width(blobs) or d} K/V columns, called "
                         f"with a cache of {self_cache.shape[3]} KV heads "
                         f"of {head_dim}")


def _attn_slice(q, k_all, v_all, c: int, n_valid: int, qk_scale: float,
                adt, start: int = 0):
    """One ATTN_SPLIT-column slice c of the cache [H, D, S] against q
    [H, D], the columns below ``start`` masked: (max [H], sum [H], P*V
    [H, D]) with P rounded to ``adt``."""
    h, d = q.shape
    c0, c1 = c * ATTN_SPLIT, min(n_valid, (c + 1) * ATTN_SPLIT)
    if c1 <= c0:
        return (torch.full((h,), NEG, device=q.device),
                torch.zeros((h,), device=q.device),
                torch.zeros((h, d), device=q.device))
    k = k_all[..., c0:c1].to(adt).float()
    v = v_all[..., c0:c1].to(adt).float()
    s = torch.einsum("hd,hds->hs", q.float(), k) * qk_scale
    live = torch.arange(c0, c1, device=q.device) >= start
    s = torch.where(live, s, torch.full_like(s, NEG))
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[:, None]), torch.zeros_like(s))
    pv = torch.einsum("hs,hds->hd", p.to(adt).float(), v)
    return m, p.sum(-1), pv


def _combine(parts):
    """Slices -> (max M [H], sum [H], P*V [H, D]) relative to M; past
    MAX_SPLITS slices the MAX_SPLITS-th and later ones are folded into one
    first, as the kernel's ``fold_slices``."""
    if len(parts) > MAX_SPLITS:
        parts = parts[:MAX_SPLITS - 1] + [_merge(parts[MAX_SPLITS - 1:])]
    return _merge(parts)


def _merge(parts):
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
                              eps: float = 1e-5, start_index=None,
                              act: str = "gelu", norm: str = "layernorm",
                              parallel: bool = False,
                              rope: Optional[Rotary] = None):
    """The plain PyTorch version of :func:`fused_decoder_stack`: the
    kernel's stages, attention slices and rounding points, layer by
    layer.  With an int8 or e4m3 self cache the fresh K/V are quantised
    with ``blobs.kv_oq`` as :func:`..ops.attention.quantize_cache_values`
    does (e4m3: the saturating cast, the stored values kept in fp32 for
    the fresh column, ``pallas_decoder_layer.py:533-539``), and the
    self-attention is scaled by ``blobs.kv_qo`` as the TPU kernel scales
    it (``pallas_decoder_layer.py:554,740-743``).  RoPE rotates q
    and the fresh k (rounded to the activation type) before the
    attention and the int8 cache's quantisation; keys below the start
    index are masked; the gated MLP (from the blobs' layout) multiplies
    act(fc) by the gate; under ``parallel`` the MLP reads the input norm
    and both outputs join the residual.  Grouped (a cache of Hkv < H
    heads): k and v from the blobs' ``kvblob``, query head h reads KV head
    h // rep, the fresh K/V [L, 2, Hkv, D]."""
    adt = x.dtype
    quant = self_cache.dtype in (torch.int8, FP8)
    L, _, _, Hkv, D, S = self_cache.shape
    d = x.shape[-1]
    H = d // D
    dkv = Hkv * D
    kv_of = torch.arange(H, device=x.device) // (H // Hkv)
    with_cross, gated, nf = blob_layout(blobs)
    grouped = blobs.kvblob is not None
    int4 = blob_int4(blobs)
    pan, slots = _panels(nf, with_cross, gated, grouped), _flat_slots(
        nf, with_cross, gated)
    nq = blobs.pair_scale.shape[1]
    n_valid = min(max(int(torch.as_tensor(seq_len).reshape(-1)[0]) - 1, 0),
                  S)
    start = (0 if start_index is None
             else int(torch.as_tensor(start_index).reshape(-1)[0]))
    rot = None
    if rope is not None and rope.rotary_dim:
        pos = torch.full((1,), max(rope.write_index - start, 0),
                         device=x.device)
        rot = rope_angles(pos, rope.rotary_dim, rope.theta)
    mlp_norm = 2 if with_cross else 0 if parallel else 1
    fresh = torch.empty((L, 2, Hkv, D), dtype=self_cache.dtype,
                        device=x.device)

    def affine(acc, s, b):               # fp32 * scale -> adt, + adt bias
        return (acc * s).to(adt) + b.to(adt)

    x = x.reshape(1, d).to(adt)
    for layer in range(L):
        w = blobs.wblob[layer]
        ps = blobs.pair_scale[layer].reshape(nq, d)
        pb = blobs.pair_bias[layer].reshape(nq, d)
        fs, fb = blobs.flat_scale[layer], blobs.flat_bias[layer]
        ln = blobs.ln_par[layer]
        kscale = (1.0 if cross_scale is None
                  else cross_scale.reshape(-1)[layer].float())
        kqo = blobs.kv_qo[layer].float() if quant else 1.0

        def group_weights(panel):
            """int4: each K group's rows [G, d] times its scale, both in
            adt, the product rounded to adt (the TPU kernel's :488)."""
            q = unpack_int4(w[panel]).to(adt)
            if not int4:
                return [q[:d // 2], q[d // 2:]]
            gsz = d // int4
            gs = blobs.gscale[layer, panel].to(adt)
            return [q[i * gsz:(i + 1) * gsz] * gs[i] for i in range(int4)]

        def gemv(v, panel):
            if int4 is None:
                return matmul_fp32(v, w[panel].to(adt))
            # int4: a product a nibble plane (per channel) or a K group,
            # each accumulated in fp32, the partial sums added in order
            parts = group_weights(panel)
            k = parts[0].shape[0]
            acc = None
            for i, wg in enumerate(parts):
                part = matmul_fp32(v[:, i * k:(i + 1) * k], wg)
                acc = part if acc is None else acc + part
            return acc

        def project(v, name):            # dense / cross-dense
            f = slots[name]
            v = v.reshape(1, d).to(adt)
            if int4 is None:
                acc = gemv(v, pan[name])
            else:
                # the out-projection reads the dequantised panel (the TPU
                # kernel's ``_weight``)
                acc = matmul_fp32(v, torch.cat(group_weights(pan[name])))
            return affine(acc, fs[f], fb[f])

        def norm_of(v, m):
            if norm == "rmsnorm":
                # the packed bias rows are zeros: y * w + 0, as the kernels
                return rms_norm(v, ln[2 * m], eps)
            return layer_norm(v, ln[2 * m], ln[2 * m + 1], eps)

        # norm 0 -> q, k, v (q and k rotated); self-attention over the
        # cache, then the fresh token's column in fp32
        h = norm_of(x, 0)
        if grouped:
            q = affine(gemv(h, pan["q"]), ps[0], pb[0]).reshape(H, D)
            kv = matmul_fp32(h, blobs.kvblob[layer].to(adt))
            k_f, v_f = (affine(kv[:, i * dkv:(i + 1) * dkv], ps[1 + i, :dkv],
                               pb[1 + i, :dkv]).reshape(Hkv, D)
                        for i in range(2))
        else:
            q, k_f, v_f = (affine(gemv(h, pan[n]), ps[i], pb[i])
                           .reshape(H, D)
                           for i, n in enumerate(("q", "k", "v")))
        if rot is not None:
            q, k_f = (apply_rope(t[None], *rot, rope.neox)[0]
                      for t in (q, k_f))
        if self_cache.dtype == torch.int8:
            # the integers the cache write would store, kept in fp32
            k_f, v_f = (torch.clamp(round_half_away(
                t.float() * blobs.kv_oq[layer].float()), -128, 127)
                for t in (k_f, v_f))
        elif quant:
            # the e4m3 values the cache write would store, kept in fp32
            k_f, v_f = (quantize_cache_values(
                t, FP8, blobs.kv_oq[layer].float()).float()
                for t in (k_f, v_f))
        fresh[layer, 0], fresh[layer, 1] = k_f, v_f
        kc, vc = self_cache[layer, 0, 0], self_cache[layer, 0, 1]
        if Hkv != H:                     # each query head's KV head
            kc, vc, k_f, v_f = (t[kv_of] for t in (kc, vc, k_f, v_f))
        big, tot, acc = _combine([
            _attn_slice(q, kc, vc, c, n_valid, scale * kqo, adt, start)
            for c in range(max(1, -(-n_valid // ATTN_SPLIT)))])
        sf = (q.float() * k_f.float()).sum(-1) * (scale * kqo)
        m_fin = torch.maximum(big, sf)
        alpha, pf = torch.exp(big - m_fin), torch.exp(sf - m_fin)
        # the TPU kernel's form (:740-743); kqo is 1 over a float cache
        ctx = (acc * alpha[:, None] * kqo
               + v_f.float() * (kqo * pf)[:, None]) \
            / (tot * alpha + pf)[:, None]
        x = x + project(ctx, "dense")
        if with_cross:
            # norm 1 -> cross-q; cross-attention, the context scaled by
            # kscale / denominator at the end
            h = norm_of(x, 1)
            q = affine(gemv(h, pan["crossq"]), ps[3], pb[3]).reshape(H, D)
            kc, vc = cross_cache[layer, 0, 0], cross_cache[layer, 0, 1]
            sc = cross_cache.shape[-1]
            _, tot, acc = _combine([
                _attn_slice(q, kc, vc, c, sc, scale * kscale, adt)
                for c in range(-(-sc // ATTN_SPLIT))])
            x = x + project(acc * (kscale / tot)[:, None], "crossdense")
        # the MLP's norm (under the parallel residual the input norm, h
        # already) -> fc1 and its activation
        # (times the gate), fc2 over its nf panels accumulated in fp32
        if not parallel:
            h = norm_of(x, mlp_norm)
        acc2 = 0.0
        for j in range(nf):
            f = slots["fc1"] + j
            hj = ACT2FN[act](affine(gemv(h, pan["fc1"] + j), fs[f], fb[f]))
            if gated:
                f = slots["gate"] + j
                hj = hj * affine(gemv(h, pan["gate"] + j), fs[f], fb[f])
            acc2 = acc2 + gemv(hj, pan["fc2"] + j)
        x = x + affine(acc2, fs[slots["fc2"]], fb[slots["fc2"]])
    return x, fresh


def library_name(with_cross: bool, self_dtype: torch.dtype) -> str:
    """The library of csrc/decoder_layer.cu that holds the kernel for a
    set (Whisper's, with cross-attention, or the decoder-only one) and a
    self-cache type: the e4m3 instantiations are built apart
    (``-DMEGA_SELF_E4M3``, :data:`._build.DEFINES`), in parallel with the
    others, whose machine code they leave as it was."""
    name = "decoder_layer" if with_cross else "decoder_stack"
    return name + "_fp8" if self_dtype == FP8 else name


class _MegaArgs(ctypes.Structure):
    """The kernel's ``MegaArgs`` (csrc/decoder_layer.cu), field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "tiles", "pair_scale", "pair_bias", "flat_scale", "flat_bias",
        "ln_par", "self_cache", "cross_cache", "cross_scale", "kv_oq",
        "kv_qo", "seq_len", "start", "inv_freq", "hid", "fresh", "act_a",
        "act_b", "att", "ctx", "barrier", "heads")]
        + [("layer_bytes", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "n_layer", "d", "n_head", "n_kv_head", "head_dim", "s_self",
            "s_cross", "nq",
            "nflat", "nf", "n_ln", "f_dense", "f_crossdense", "f_fc1",
            "f_gate", "f_fc2", "with_cross", "cross_int8", "self_kind",
            "weight_bf16", "norm_rms", "act", "gated", "parallel",
            "rope_dim", "rope_neox", "write_index", "ring_bytes")]
        + [(n, ctypes.c_int * len(GEMV_STAGES))
           for n in ("item_c", "items", "item_k", "tile_off", "piece_c")]
        + [("scale", ctypes.c_float), ("eps", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("weight_int4", "n_groups")])


def fused_decoder_stack(x, blobs: MegakernelBlobs, self_cache, seq_len,
                        scale: float, cross_cache=None, cross_scale=None,
                        start_index=None, tail_kv=None,
                        head_dim: int = HEAD_DIM, eps: float = 1e-5,
                        act: str = "gelu", norm: str = "layernorm",
                        gated: bool = False, parallel: bool = False,
                        rope: Optional[Rotary] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer of one decode step in ONE kernel.

    x [1, d] (embedded token, + its learned position); self_cache [L, 1,
    2, Hkv, D, S] seq-minor (Hkv = H, or fewer KV heads in the grouped
    mode, the blobs packed for them), without the fresh token (int8:
    quantised with
    ``blobs.kv_oq``, read with ``blobs.kv_qo``); seq_len [1] int32
    INCLUDING the fresh token; start_index [1] int32 (or None): the first
    key column of the row; cross_cache [L, 1, 2, H, D, Sc] with per-layer
    ``cross_scale`` [L] when int8, or None (the decoder-only modes: the
    blobs packed without cross-attention, ``gated`` as packed); ``rope``:
    the step's :class:`Rotary`.  Returns (hidden [1, d] before the final
    norm, fresh K/V [L, 2, Hkv, D] in the cache dtype, k rotated); the cache
    is not written.  On the card: bf16 x, a bf16, int8 or e4m3 self cache,
    int8 or bf16 panels (or, with cross-attention, int4), head dim 64 (128
    too without cross-attention), and one cooperative launch of
    :func:`library_name`'s library (a refused launch raises; nothing falls
    back)."""
    _check_modes(x, blobs, self_cache, cross_cache, head_dim, tail_kv, act,
                 norm, gated)
    if not x.is_cuda:
        return plain_fused_decoder_stack(
            x, blobs, self_cache, seq_len, scale, cross_cache, cross_scale,
            head_dim, eps, start_index=start_index, act=act, norm=norm,
            parallel=parallel, rope=rope)
    L, _, _, Hkv, D, S = self_cache.shape
    d = x.shape[-1]
    H = d // D
    with_cross = cross_cache is not None
    sc = cross_cache.shape[-1] if with_cross else 0
    dev = x.device
    if D not in (HEAD_DIMS if not with_cross else (HEAD_DIM,)):
        raise NotImplementedError(f"megakernel is built for head dims "
                                  f"{HEAD_DIMS} ({HEAD_DIM} with "
                                  f"cross-attention), got {D}")
    if x.dtype != torch.bfloat16 or self_cache.dtype not in (
            torch.bfloat16, torch.int8, FP8):
        raise TypeError("megakernel takes bf16 activations and a bf16, "
                        "int8 or e4m3 self cache")
    if blobs.wblob.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"megakernel panels of {blobs.wblob.dtype}: int8 "
                        "or bf16")
    self_kind = cache_kind(self_cache.dtype)
    if with_cross and cross_cache.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"megakernel cross cache dtype {cross_cache.dtype}")
    _, gated, nf = blob_layout(blobs)
    int4 = blob_int4(blobs)
    # the kernel reads the caches in 4-byte words: rows of whole words
    word = 4 // cross_cache.element_size() if with_cross else 1
    max_d, max_ffn = ((MAX_D_CROSS, MAX_FFN_CROSS) if with_cross
                      else (MAX_D, MAX_FFN))
    if (d % D or d > max_d or nf * d > max_ffn
            or S % (4 // self_cache.element_size()) or sc % word
            or (with_cross and max(S, sc) > MAX_SPLITS * ATTN_SPLIT)
            or (with_cross and cross_cache.shape[:5] != (L, 1, 2, H, D))):
        cross = tuple(cross_cache.shape) if with_cross else None
        raise ValueError(f"megakernel shapes: d {d}, ffn {nf * d}, heads "
                         f"{H} of {D}, self {S}, cross {cross}")
    rope_dim = rope.rotary_dim if rope is not None else 0
    if rope_dim % 2 or rope_dim > D:
        raise ValueError(f"megakernel rotary dim {rope_dim} of heads of {D}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    itemsize = blobs.wblob.element_size()
    plan = megakernel_plan(d, nf, sms, with_cross, gated, itemsize,
                           blob_kv_width(blobs), int4)
    max_cols = PIECE_MAX_COLS if with_cross else ITEM_MAX_COLS
    if max(plan["item_c"]) > max_cols:
        raise ValueError(f"megakernel: {sms} SMs give items of "
                         f"{max(plan['item_c'])} columns, past {max_cols}")
    tiles = blobs.tiles
    if (tiles is None or blobs.tiles_grid != sms
            or tiles.dtype != blobs.wblob.dtype
            or tuple(tiles.shape) != (L, plan["layer_bytes"] // itemsize)):
        raise ValueError("megakernel blobs need the tiles of this card's "
                         "plan: build them with megakernel_tiles(blobs)")
    kv_scales = (blobs.kv_oq, blobs.kv_qo) if self_kind else ()
    operands = (self_cache, tiles, *blobs[1:6], *kv_scales) + (
        (cross_cache,) if with_cross else ())
    for t in operands:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("megakernel operands must be contiguous on "
                             f"{dev}")
    if (not torch.is_tensor(seq_len) or seq_len.numel() != 1
            or seq_len.device != dev):
        raise TypeError(f"seq_len must be a [1] tensor on {dev}")
    if start_index is not None and (not torch.is_tensor(start_index)
                                    or start_index.device != dev):
        raise TypeError(f"start_index must be a tensor on {dev}")
    # every tensor the kernel reads or writes is held in a local until the
    # launch is enqueued (a freed temporary could be reused and overwritten
    # on the stream first)
    seq_t = seq_len.reshape(1).to(torch.int32).contiguous()
    start_t = (None if start_index is None
               else start_index.reshape(-1)[:1].to(torch.int32).contiguous())
    freq_t = (rope_freqs(rope_dim, float(rope.theta), dev) if rope_dim
              else None)
    xin = x.reshape(d).contiguous()
    cs_t = None
    if (with_cross and cross_scale is not None
            and cross_cache.dtype == torch.int8):
        cs_t = torch.as_tensor(cross_scale, dtype=torch.float32,
                               device=dev).reshape(L).contiguous()
    hid = torch.empty((1, d), dtype=torch.bfloat16, device=dev)
    fresh = torch.empty((L, 2, Hkv, D), dtype=self_cache.dtype, device=dev)
    # finished GEMV outputs: q, k, v / cross-q / act(fc1) and dense /
    # cross-dense / fc2
    act_a = torch.empty((max(3, nf) * d,), dtype=torch.float32, device=dev)
    act_b = torch.empty((d,), dtype=torch.float32, device=dev)
    slices = max(1, -(-max(S, sc) // ATTN_SPLIT))
    att = torch.empty((H * slices * (D + 2),), dtype=torch.float32,
                      device=dev)
    ctx = torch.empty((d,), dtype=torch.float32, device=dev)
    # the grid barrier's arrivals, then each head's finished attention
    # slices (self and cross, every layer): zeros, one call's
    sync = torch.zeros((1 + 2 * L * H,), dtype=torch.int32, device=dev)
    slots = _flat_slots(nf, with_cross, gated)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ints(key):
        return (ctypes.c_int * len(GEMV_STAGES))(*plan[key])

    args = _MegaArgs(
        ptr(xin), ptr(tiles), ptr(blobs.pair_scale),
        ptr(blobs.pair_bias), ptr(blobs.flat_scale), ptr(blobs.flat_bias),
        ptr(blobs.ln_par), ptr(self_cache), ptr(cross_cache), ptr(cs_t),
        *(ptr(t) for t in kv_scales or (None, None)), ptr(seq_t),
        ptr(start_t), ptr(freq_t), ptr(hid), ptr(fresh), ptr(act_a),
        ptr(act_b), ptr(att), ptr(ctx), ptr(sync), ptr(sync) + 4,
        plan["layer_bytes"],
        L, d, H, Hkv, D, S, sc, blobs.pair_scale.shape[1],
        blobs.flat_scale.shape[1], nf, blobs.ln_par.shape[1] // 2,
        slots["dense"], slots["crossdense"], slots["fc1"], slots["gate"],
        slots["fc2"], int(with_cross),
        int(with_cross and cross_cache.dtype == torch.int8), self_kind,
        int(blobs.wblob.dtype == torch.bfloat16), int(norm == "rmsnorm"),
        ACTIVATIONS.index(act), int(gated), int(parallel), rope_dim,
        int(rope.neox) if rope_dim else 0,
        rope.write_index if rope_dim else 0, plan["ring_cap"],
        ints("item_c"), ints("items"), ints("item_k"), ints("tile_off"),
        ints("piece_c"), float(scale), float(eps), int(int4 is not None),
        int4 or 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.load(library_name(with_cross, self_cache.dtype))
    _build.check(lib.decoder_megakernel(ctypes.byref(args), stream),
                 "decoder_megakernel (cooperative launch)")
    launches["decoder_megakernel"] += 1
    return hid, fresh
