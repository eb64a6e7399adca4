"""Tensor-parallel placement of a model and its state (the JAX package's
``parallel/sharding.py`` with the layers' ``pspecs()``).

:func:`parallelize` turns a model built at full width into one rank's
shard of it, in place: each attention block, MLP, embedding and LM head
that shards gets its parameters re-declared at the rank's shape, the head
counts it now runs, and the tensor-parallel group it calls its collectives
on.  :func:`shard_state` then carries a full state dict in the JAX layout
(per-layer tensors stacked ``[n_layer, ...]``, as the converters take it)
into this rank's shard, to be loaded by the converters' ``from_jax_state``.

Which dim each parameter splits on is declared by its layer, as the JAX
``Module.pspecs()`` is: the ``TP_DIMS`` of each linear class, column
(out-features: ``ColumnLinear``, the QKV projection's heads, fc and the gate
of an MLP) or row (in-features: the attention's ``dense``, an MLP's
projection), and the vocab rows of an embedding or LM head.  A stacked
state's layer axis shifts each dim by one (JAX ``module.py:180-186``).

The rules, and how they meet the JAX package's per-parameter placement:

* JAX ``_legalize`` replicates any one parameter whose dim the tp size does
  not divide.  The port decides per block: an attention block shards only
  where the tp size divides its query heads, an MLP only where it divides
  its ffn width; otherwise the whole block stays whole on every rank and
  runs no collective.  Every float parameter the port splits, the JAX
  rule splits too, into the same slice (held bit for bit by the tests),
  but for the exceptions below; a parameter the JAX rule replicates, the
  port keeps whole (but ``kv_weight``, below).  The JAX rule
  may still split one parameter of a block the port keeps whole (the
  out-projection's in-features where the heads do not divide), and XLA
  then reduces inside the block.
* The row-parallel side's bias is replicated and added once, after the
  all-reduce (JAX ``linear.py:60-73``).
* Weight-only int4: a block shards only where each rank's row-parallel K
  is a multiple of 64 (the int4 kernel's chunk) and of its group size, so
  the group scales ``[K/G, N]`` split with K (JAX ``quantization/
  layers.py:47-63``).  The packed rows are re-packed for the rank's K
  (half-split nibbles of its own rows), where the JAX shard of the packed
  array is a plain slice that XLA reads globally.
* MQA/GQA: where the tp size does not divide the KV heads, each rank holds
  the KV heads its query heads read (one, for MQA), so the query heads of
  a KV head stay together; where neither divides the other the block stays
  whole.  JAX replicates ``kv_weight`` (it declares no pspec).
* The weight-only QKV projection's output columns are the rank's heads
  (q, k and v of each), where the JAX shard is a contiguous run of
  columns; the float QKV's ``[3, H, hd, in]`` split on H is the same in
  both.  Whisper's ``mlp2`` is a ``Linear`` (column) in the JAX package,
  split there on its out-features; the port runs it row-parallel.
* SmoothQuant layers stay whole on every rank (their JAX layers declare no
  pspec), and so does the block around them; FP8 linears shard as the
  float ones, their per-tensor scales replicated.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .collectives import Group


def _chunk(n: int, tp: Group) -> np.ndarray:
    if n % tp.size:
        raise ValueError(f"{n} rows do not split over {tp.size} ranks")
    step = n // tp.size
    return np.arange(tp.rank * step, (tp.rank + 1) * step)


def _resize(module: nn.Module, name: str, dim: int, idx: np.ndarray,
            packed: bool = False) -> None:
    """Re-declare ``module.<name>`` with ``len(idx)`` entries on ``dim``
    (half as many packed int4 rows) and record the split for
    :func:`shard_state`."""
    p = getattr(module, name, None)
    if p is None:
        return
    shape = list(p.shape)
    dim = dim % len(shape)
    shape[dim] = len(idx) // 2 if packed else len(idx)
    setattr(module, name, nn.Parameter(
        torch.empty(shape, dtype=p.dtype, device=p.device),
        requires_grad=False))
    module.__dict__.setdefault("_tp_index", {})
    module._tp_index[name] = (dim, idx, packed)


def shard_linear(lin: nn.Module, tp: Group, mode: str,
                 idx: Optional[np.ndarray] = None,
                 gather_output: bool = False) -> None:
    """Split a linear layer (float, weight-only, FP8) as ``mode`` "col"
    (its out-features ``idx``, by default this rank's chunk) or "row" (its
    in-features' chunk); the layer's ``TP_DIMS[mode]`` names the dim of
    each parameter."""
    dims = type(lin).TP_DIMS[mode]
    bits = getattr(lin, "bits", 16)
    if mode == "col":
        idx = _chunk(lin.out_features, tp) if idx is None else idx
        for name, dim in dims.items():
            _resize(lin, name, dim, idx)
        lin.out_features = len(idx)
    else:
        k = lin.in_features
        kidx = _chunk(k, tp)
        for name, dim in dims.items():
            p = getattr(lin, name, None)
            if p is None:
                continue
            if name == "per_channel_scale":
                if p.dim() == 1:
                    continue                 # per channel: replicated
                g = k // p.shape[0]
                _resize(lin, name, 0, _chunk(p.shape[0], tp))
                assert len(kidx) % g == 0
            else:
                _resize(lin, name, dim, kidx, packed=bits == 4
                        and name == "qweight")
        lin.in_features = len(kidx)
    lin.tp, lin.tp_mode, lin.gather_output = tp, mode, gather_output


def _row_ok(lin: nn.Module, tp: Group) -> bool:
    """A row-parallel split the kernels take: weight-only int4 needs the
    rank's K a multiple of 64 and of its group."""
    k = lin.in_features
    if k % tp.size:
        return False
    if getattr(lin, "bits", 16) == 4:
        kl = k // tp.size
        return kl % 64 == 0 and (not lin.group_size
                                 or kl % lin.group_size == 0)
    return True


def _whole(*mods) -> bool:
    """A block with a SmoothQuant layer stays whole."""
    from ..quantization.smoothquant_layers import (SmoothQuantLinear,
                                                   SmoothQuantQKVLinear)
    return any(isinstance(m, (SmoothQuantLinear, SmoothQuantQKVLinear))
               for m in mods if m is not None)


def kv_heads_of_rank(h: int, hkv: int, tp: Group) -> Optional[np.ndarray]:
    """The KV heads this rank's query heads read (query heads of one KV
    head are consecutive), or None where the split would part a KV head's
    query heads unevenly."""
    hl = h // tp.size
    rep = h // hkv
    if hkv % tp.size == 0:
        return _chunk(hkv, tp)
    if rep % hl == 0:
        return np.array([tp.rank * hl // rep])
    return None


def shard_attention(attn: nn.Module, tp: Group) -> bool:
    """Shard one attention block on its heads (the QKV projection or the
    cross q projection column-parallel, ``dense`` row-parallel); False,
    and the block left whole, where the rules say so."""
    h, hkv = attn.num_attention_heads, attn.num_attention_kv_heads
    hd = attn.attention_head_size
    if (h % tp.size or _whole(attn.qkv, attn.q_linear, attn.dense)
            or not _row_ok(attn.dense, tp)):
        return False
    kv_idx = kv_heads_of_rank(h, hkv, tp)
    if kv_idx is None:
        return False
    q_idx = _chunk(h, tp)
    if attn.cross_attention:
        shard_linear(attn.q_linear, tp, "col",
                     (q_idx[:, None] * hd + np.arange(hd)).reshape(-1))
    else:
        _shard_qkv(attn.qkv, tp, q_idx, kv_idx)
    shard_linear(attn.dense, tp, "row")
    attn.head_offset = int(q_idx[0])
    attn.num_attention_heads = len(q_idx)
    attn.num_attention_kv_heads = len(kv_idx)
    attn.tp = tp
    return True


def _shard_qkv(qkv: nn.Module, tp: Group, q_idx, kv_idx) -> None:
    h, hkv, hd = qkv.num_heads, qkv.num_kv_heads, qkv.head_dim
    sep = qkv.separate_kv
    if hasattr(qkv, "qweight"):
        # weight-only: the output columns of the rank's heads
        cols = np.arange(hd)
        if sep:
            idx = np.concatenate([
                (q_idx[:, None] * hd + cols).reshape(-1),
                (h * hd + kv_idx[:, None] * hd + cols).reshape(-1),
                ((h + hkv) * hd + kv_idx[:, None] * hd + cols).reshape(-1)])
        else:
            idx = np.concatenate([((t * h + q_idx[:, None]) * hd
                                   + cols).reshape(-1) for t in range(3)])
        _resize(qkv, "qweight", 1, idx)
        sc = qkv.per_channel_scale
        _resize(qkv, "per_channel_scale", sc.dim() - 1, idx)
    else:
        _resize(qkv, "weight", 0 if sep else 1, q_idx)
        if sep:
            _resize(qkv, "kv_weight", 1, kv_idx)
    _resize(qkv, "bias", 0 if sep else 1, q_idx)
    if sep:
        _resize(qkv, "kv_bias", 1, kv_idx)
    qkv.num_heads, qkv.num_kv_heads = len(q_idx), len(kv_idx)
    qkv.tp = tp


def shard_mlp(fcs, proj: nn.Module, tp: Group) -> bool:
    """fc (and the gate) column-parallel, ``proj`` row-parallel, where the
    tp size divides the ffn width."""
    if _whole(proj, *fcs) or not _row_ok(proj, tp):
        return False
    for fc in fcs:
        shard_linear(fc, tp, "col")
    shard_linear(proj, tp, "row")
    return True


def shard_embedding(emb: nn.Module, tp: Group) -> bool:
    """Vocab-parallel rows, where the tp size divides them."""
    n = emb.num_embeddings
    if n % tp.size:
        return False
    idx = _chunk(n, tp)
    _resize(emb, "weight", 0, idx)
    emb.vocab_start = int(idx[0])
    emb.tp = tp
    return True


def parallelize(model: nn.Module, mapping) -> nn.Module:
    """Make ``model`` (built at full width, before its state is loaded)
    this rank's tensor-parallel shard of it, in place, by the rules above.
    The model keeps ``mapping`` (the Whisper pipeline splits its batch over
    the data-parallel ranks with it).  With tp 1 nothing changes."""
    from ..layers import MLP, Attention, Embedding
    from ..quantization.fp8_layers import FP8MLP
    model.mapping = mapping
    tp = mapping.tp
    if not tp.active:
        return model
    for m in list(model.modules()):
        if isinstance(m, Attention):
            shard_attention(m, tp)
        elif isinstance(m, MLP):
            shard_mlp([m.fc] + ([m.gate] if hasattr(m, "gate") else []),
                      m.proj, tp)
        elif isinstance(m, FP8MLP):
            shard_mlp([m.fc], m.proj, tp)
        elif isinstance(m, Embedding):
            shard_embedding(m, tp)
    hook = getattr(model, "tp_shard", None)
    if hook is not None:
        hook(tp)
    return model


def tp_active(model: nn.Module) -> bool:
    """Whether ``model`` is a tensor-parallel shard."""
    mapping = getattr(model, "mapping", None)
    return mapping is not None and mapping.tp_size > 1


def state_index(model: nn.Module) -> Dict[str, tuple]:
    """{key of the JAX-layout state: (dim, indices, packed int4)} for every
    parameter of ``model`` that :func:`parallelize` split: a per-layer
    module ``blocks.<i>.x`` stands for the stacked ``blocks.x`` (its dim
    shifted by the layer axis), plus the model's own extra keys
    (``tp_state_index``, the cross-KV's stacked projections)."""
    out = {}
    for path, m in model.named_modules():
        idx = m.__dict__.get("_tp_index")
        if not idx:
            continue
        parts = path.split(".")
        stacked = len(parts) > 1 and parts[0] == "blocks"
        if stacked:
            if parts[1] != "0":
                continue
            path = ".".join(["blocks"] + parts[2:])
        for name, (dim, ix, packed) in idx.items():
            key = f"{path}.{name}" if path else name
            out[key] = (dim + (1 if stacked else 0), ix, packed)
    extra = getattr(model, "tp_state_index", None)
    if extra is not None:
        out.update(extra())
    return out


def _repack_rows(packed: np.ndarray, axis: int, rows: np.ndarray
                 ) -> np.ndarray:
    """Half-split int4 rows (byte i: row i low, row i + K/2 high) along
    ``axis`` -> the packed array of the K rows ``rows``, half-split over
    its own rows."""
    p = np.moveaxis(packed, axis, 0).astype(np.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    q = np.concatenate([lo, hi], axis=0)[rows]
    k = q.shape[0]
    out = (q[:k // 2] & 0xF) | ((q[k // 2:] & 0xF) << 4)
    return np.moveaxis(out.astype(np.uint8).view(np.int8), 0, axis)


def shard_state(state: Dict, model: nn.Module, mapping=None) -> Dict:
    """This rank's shard of ``state`` (the JAX layout, numpy arrays or
    tensors, float or quantised), for ``model`` made by
    :func:`parallelize` with ``mapping`` (default: the model's): each split
    parameter is its rank's slice (re-packed int4 rows for a row-parallel
    int4 weight), every other one is kept whole.  numpy in, numpy out."""
    if mapping is not None and getattr(model, "mapping", None) is not None \
            and model.mapping.rank != mapping.rank:
        raise ValueError("the model was parallelized for another rank")
    index = state_index(model)
    out = {}
    for k, v in state.items():
        if k not in index:
            out[k] = v
            continue
        dim, idx, packed = index[k]
        if packed:
            arr = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            r = _repack_rows(arr, dim, idx)
            out[k] = torch.from_numpy(r).to(v.device) if torch.is_tensor(
                v) else r
        elif torch.is_tensor(v):
            out[k] = torch.index_select(
                v, dim, torch.as_tensor(idx, device=v.device)).contiguous()
        else:
            out[k] = np.ascontiguousarray(np.take(np.asarray(v), idx,
                                                  axis=dim))
    return out
