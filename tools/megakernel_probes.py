"""The megakernel design probes on the GPU: the four Pallas kernels of
``benchmarks/megakernel_probe.py`` (``_flat_kernel`` :61, ``_hm_kernel``
:85), ``megakernel_probe2.py`` (``_kernel`` :48) and ``megakernel_probe3.py``
(``_kernel`` :48) as the hand-written kernels of ``megakernel_probes.cu``
beside this file, built by nvcc for ``sm_90a`` at first use into the repo's
``build/kernels/`` (through ``ops/_build.register``) and loaded with ctypes.

Each wrapper checks the shapes (the same on every device: a shape the
kernel does not take raises ``ValueError``), then on a CUDA tensor launches
the kernel on ``torch.cuda.current_stream()`` and counts the launch in
:data:`launches`, raising if the build or the launch fails; on a CPU
tensor it runs the plain PyTorch version beside it (``plain_probe_*``),
which the tests hold against the JAX kernels.  :func:`torch_baseline_flat`
is the counterpart of ``probe_xla`` (:114): a loop over the panels of
cast, ``torch.matmul`` in fp32 and scale, returning every panel where the
JAX baseline returns only the last one.

The kernels cut a panel into items of ``cols`` output columns by a
``ksplit``-th of K, one block per item.  The item is :func:`item_plan`'s:
the widest of 32, 64, 128 or 256 columns that divides N by the whole of K,
with K split only while the grid has fewer than two blocks an SM.  On the
H100 that item streamed the 210 MB blob in 77 µs where the megakernel's
first GEMV item (32 columns by a quarter of K, ``csrc/decoder_layer.cu``
``gemv_tile`` before its whole-K items) took 212 µs, and 629 µs on the
megakernel's grid of one block an SM: :func:`probe_flat` alone takes another item and grid, so
that ``tools/megakernel_probe.py`` can print both.
"""
from __future__ import annotations

import ctypes
import functools
import sys
from pathlib import Path
from typing import Optional, Tuple

import torch

from eddie_wang_hackathon2023_tpu_torch.functional import matmul_fp32
from eddie_wang_hackathon2023_tpu_torch.ops import _build

# the scripts' shapes (benchmarks/megakernel_probe{,2,3}.py)
K = N = 1280
NP = 128                 # panels: 128 x 1.64 MB = 210 MB
H, D = 20, 64            # heads of the relayout
HP, DL = 10, 128         # the pair layout of the context
KV_COLS = 128            # columns of the relayout's KV tile
PAIR_MODES = ("pair_loop", "flat_f32", "flat_bf16", "gemv")
RELAYOUT_MODES = ("none", "reshape")

# the item: output columns by a slice of K
ITEM_COLS = (32, 64, 128, 256)
MEGAKERNEL_ITEM = (32, 4)        # the megakernel's first item (kTile, kKSplit)
MAX_K = 4096             # the kernel's limit on a slice of K and on N

_P, _I = ctypes.c_void_p, ctypes.c_int
_build.register(
    "megakernel_probes", Path(__file__).with_name("megakernel_probes.cu"), {
        "probe_flat": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "probe_hm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "probe_relayout": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P],
        "probe_pair_proj": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    })

# launches of the kernels, counted where a wrapper launches one
launches = {"probe_flat_gemv": 0, "probe_hm_gemv": 0, "probe_relayout": 0,
            "probe_pair_proj": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_item(k: int, n: int, cols: int, ksplit: int) -> None:
    if k % 16 or k < 16:
        raise ValueError(f"K {k}: the kernels take K a multiple of 16")
    if n % 32 or n > MAX_K:
        raise ValueError(f"N {n}: the kernels take N a multiple of 32, at "
                         f"most {MAX_K}")
    if cols not in ITEM_COLS or n % cols:
        raise ValueError(f"items of {cols} columns for N {n}: take one of "
                         f"{ITEM_COLS} that divides N")
    if ksplit < 1 or k % ksplit or k // ksplit > MAX_K:
        raise ValueError(f"K {k} in {ksplit} slices: the slices must split "
                         f"K evenly, each at most {MAX_K} rows")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def item_plan(p: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(cols, ksplit) for ``p`` panels [k, n] on ``sms`` multiprocessors:
    the widest item of ITEM_COLS that divides ``n``, K halved while the
    grid has fewer than two blocks an SM and a slice keeps a multiple of
    16 rows, at least 64."""
    cols = max((c for c in ITEM_COLS if n % c == 0), default=ITEM_COLS[0])
    ksplit = 1
    while (p * (n // cols) * ksplit < 2 * sms and k % (32 * ksplit) == 0
           and k // (2 * ksplit) >= 64):
        ksplit *= 2
    return cols, ksplit


def _plan(t: torch.Tensor, p: int, n: int, k: int) -> Tuple[int, int]:
    """:func:`item_plan` on the card ``t`` lies on (132 SMs for a CPU
    tensor, whose plain version takes no item)."""
    sms = _sm_count(t.device.index or 0) if t.is_cuda else 132
    return item_plan(p, n, k, sms)


def _shape(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} {tuple(t.shape)}, expected {tuple(shape)}")


def _dtype(t: torch.Tensor, dtype, what: str) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{what} is {t.dtype}, expected {dtype}")


_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 counter per group of items, kept per device: the
    kernel leaves every counter it uses at zero again."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 8192), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(entry: str, counter: str, operands, ints, p: int, n: int,
            ksplit: int, groups: int, split: bool) -> None:
    """Launch ``entry`` on the operands' stream.  Every operand, the
    workspace and the counters stay referenced here until the launch is
    enqueued."""
    dev = operands[0].device
    ws = (torch.empty(p * ksplit * n, dtype=torch.float32, device=dev)
          if split else None)
    counters = _counters(dev, groups) if split else None
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fn = getattr(_build.load("megakernel_probes"), entry)
    _build.check(fn(*(_ptr(t) for t in operands), *(int(i) for i in ints),
                    _ptr(ws), _ptr(counters), stream), entry)
    launches[counter] += 1


def _on_card(*tensors) -> bool:
    if not tensors[0].is_cuda:
        return False
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("the operands lie on different devices")
    return True


def _contig(*tensors):
    return [t.contiguous() for t in tensors]


# -- 9a: the flat GEMV (megakernel_probe.py:61 _flat_kernel) ----------------

def plain_probe_flat(blob, x, scales):
    """The plain PyTorch version of :func:`probe_flat`."""
    acc = torch.matmul(x.float(), blob.float())            # [P, 1, N]
    return (acc * scales.float()).to(torch.bfloat16)


def probe_flat(blob, x, scales, *, cols: Optional[int] = None,
               ksplit: Optional[int] = None, blocks: int = 0):
    """blob [P, K, N] int8, x [1, K] bf16, scales [P, 1, N] fp32 ->
    [P, 1, N] bf16: ``bf16((x . bf16(blob[p])) * scales[p])``, the sum in
    fp32.  ``cols`` and ``ksplit`` replace :func:`item_plan`'s item, and
    ``blocks`` > 0 fixes the grid (a grid-stride loop over the items)."""
    p, k, n = blob.shape
    if cols is None or ksplit is None:
        plan = _plan(x, p, n, k)
        cols = plan[0] if cols is None else cols
        ksplit = plan[1] if ksplit is None else ksplit
    _check_item(k, n, cols, ksplit)
    _shape(x, (1, k), "x")
    _shape(scales, (p, 1, n), "scales")
    _dtype(blob, torch.int8, "blob")
    _dtype(x, torch.bfloat16, "x")
    _dtype(scales, torch.float32, "scales")
    if not _on_card(blob, x, scales):
        return plain_probe_flat(blob, x, scales)
    blob, x, scales = _contig(blob, x, scales)
    out = torch.empty((p, 1, n), dtype=torch.bfloat16, device=x.device)
    _launch("probe_flat", "probe_flat_gemv", (x, blob, scales, out),
            (p, k, n, cols, ksplit, blocks), p, n, ksplit, p * (n // cols),
            ksplit > 1)
    return out


def baseline_flat_panel(blob, x, scales, i: int):
    """Panel ``i`` of :func:`torch_baseline_flat`: the int8 cast to x's
    dtype, ``x @ W`` accumulated in fp32, the scale, bf16 ([1, N])."""
    return (matmul_fp32(x, blob[i].to(x.dtype)) * scales[i]).to(
        torch.bfloat16)


def torch_baseline_flat(blob, x, scales):
    """``probe_xla``'s counterpart: the loop of :func:`baseline_flat_panel`
    over the panels, every panel stacked ([P, 1, N]; the JAX baseline
    returns only the last panel's [1, N])."""
    return torch.stack([baseline_flat_panel(blob, x, scales, i)
                        for i in range(blob.shape[0])])


# -- 9b: head-major panels (megakernel_probe.py:85 _hm_kernel) --------------

def plain_probe_hm(blob_hm, xb, scales_hm):
    """The plain PyTorch version of :func:`probe_hm`."""
    acc = torch.matmul(xb.float()[None], blob_hm.float())  # [np, rows, 1, D]
    return (acc[:, :, 0, :] * scales_hm.float()).to(torch.bfloat16)


def probe_hm(blob_hm, xb, scales_hm):
    """blob_hm [np, rows, K, 64] int8, xb [rows, 1, K] bf16, scales_hm [np,
    rows, 64] fp32 -> [np, rows, 64] bf16: for every panel i and row r,
    ``bf16((xb[r] . bf16(blob_hm[i, r])) * scales_hm[i, r])``."""
    if blob_hm.dim() != 4 or blob_hm.shape[3] != D:
        raise ValueError(f"head-major blob {tuple(blob_hm.shape)}: expected "
                         f"[np, rows, K, {D}]")
    np_, rows, k, d = blob_hm.shape
    cols, ksplit = _plan(xb, np_ * rows, d, k)
    _check_item(k, d, cols, ksplit)
    _shape(xb, (rows, 1, k), "xb")
    _shape(scales_hm, (np_, rows, d), "scales")
    _dtype(blob_hm, torch.int8, "blob")
    _dtype(xb, torch.bfloat16, "xb")
    _dtype(scales_hm, torch.float32, "scales")
    if not _on_card(blob_hm, xb, scales_hm):
        return plain_probe_hm(blob_hm, xb, scales_hm)
    blob_hm, xb, scales_hm = _contig(blob_hm, xb, scales_hm)
    out = torch.empty((np_, rows, d), dtype=torch.bfloat16, device=xb.device)
    p = np_ * rows
    _launch("probe_hm", "probe_hm_gemv", (xb, blob_hm, scales_hm, out),
            (np_, rows, k, d, cols, ksplit), p, d, ksplit, p * (d // cols),
            ksplit > 1)
    return out


def hm_panels(rows: int, np_total: int = NP, k: int = K, n: int = N) -> int:
    """Head-major panels of ``rows`` rows that hold the flat blob's bytes
    (the JAX script's ``np_``)."""
    return np_total * k * n // (rows * k * D)


# -- 9c: the relayout (megakernel_probe2.py:48 _kernel) ---------------------

def plain_probe_relayout(blob, x, kv, mode: str):
    """The plain PyTorch version of :func:`probe_relayout`."""
    acc = torch.matmul(x.float(), blob.float())            # [P, 1, N]
    if mode == "none":
        return acc.to(torch.bfloat16)
    h, d, c = kv.shape[1:]
    q = acc.reshape(-1, h, 1, d)
    s = torch.matmul(q, kv[0].float())                     # [P, H, 1, C]
    total = s.sum(-1).sum((1, 2))                          # [P]
    return (acc * 0.0 + total[:, None, None]).to(torch.bfloat16)


def probe_relayout(blob, x, kv, mode: str):
    """blob [P, K, N] int8, x [1, K] bf16, kv [1, H, D, C] bf16 (H D = N) ->
    [P, 1, N] bf16.  ``none``: ``bf16(x . bf16(blob[p]))``.  ``reshape``:
    that fp32 sum seen as q [H, 1, D], the fp32 scores q[h] . kv[0, h] [H,
    1, C], and ``bf16(0 * sum + the total of the scores)`` in every
    column."""
    if mode not in RELAYOUT_MODES:
        raise ValueError(f"mode {mode!r}: one of {RELAYOUT_MODES}")
    p, k, n = blob.shape
    cols, ksplit = _plan(x, p, n, k)
    _check_item(k, n, cols, ksplit)
    _shape(x, (1, k), "x")
    if kv.dim() != 4 or kv.shape[0] != 1 or kv.shape[1] * kv.shape[2] != n:
        raise ValueError(f"kv {tuple(kv.shape)}: expected [1, H, D, C] with "
                         f"H D = N = {n}")
    _dtype(blob, torch.int8, "blob")
    _dtype(x, torch.bfloat16, "x")
    _dtype(kv, torch.bfloat16, "kv")
    if not _on_card(blob, x, kv):
        return plain_probe_relayout(blob, x, kv, mode)
    blob, x, kv = _contig(blob, x, kv)
    out = torch.empty((p, 1, n), dtype=torch.bfloat16, device=x.device)
    reshape = mode == "reshape"
    h, d, c = kv.shape[1:]
    _launch("probe_relayout", "probe_relayout", (x, blob, kv, out),
            (p, k, n, h, d, c, int(reshape), cols, ksplit), p, n, ksplit,
            p if reshape else p * (n // cols), reshape or ksplit > 1)
    return out


# -- 9d: the out-projection from the pair layout (megakernel_probe3.py:48) --

def plain_probe_pair_proj(blob, ctx, mode: str):
    """The plain PyTorch version of :func:`probe_pair_proj`."""
    hp, dl = ctx.shape
    if mode == "gemv":
        lhs = ctx.float().sum(0, keepdim=True)             # [1, DL]
        acc = torch.matmul(lhs, blob[:, :dl].to(torch.bfloat16).float())
    elif mode == "pair_loop":
        cb = ctx.to(torch.bfloat16).float()
        acc = None
        for j in range(hp):
            part = torch.matmul(cb[j:j + 1],
                                blob[:, j * dl:(j + 1) * dl].float())
            acc = part if acc is None else acc + part
    else:       # flat_f32 and flat_bf16: the same values, cast and reshape
        flat = ctx.float().reshape(1, hp * dl).to(torch.bfloat16).float()
        acc = torch.matmul(flat, blob.float())
    return acc.to(torch.bfloat16)


def probe_pair_proj(blob, ctx, mode: str):
    """blob [P, d, d] int8 with d = HP DL, ctx [HP, DL] fp32 -> [P, 1, d]
    bf16 of an fp32 sum.  ``pair_loop``: the HP partials bf16(ctx[p]) .
    blob[:, DL p : DL (p + 1)] added in order of p; ``flat_f32`` and
    ``flat_bf16``: bf16(ctx flattened) . blob; ``gemv``: (the fp32 sum of
    ctx's rows) . blob[:, :DL], in fp32.  ``pair_loop`` takes one slice of
    K per pair (``ksplit`` HP), the others :func:`item_plan`'s item."""
    if mode not in PAIR_MODES:
        raise ValueError(f"mode {mode!r}: one of {PAIR_MODES}")
    if ctx.dim() != 2:
        raise ValueError(f"ctx {tuple(ctx.shape)}: expected [HP, DL]")
    hp, dl = ctx.shape
    d = hp * dl
    _shape(blob, (blob.shape[0], d, d), "blob")
    k = dl if mode == "gemv" else d
    cols, ksplit = _plan(ctx, blob.shape[0], d, k)
    if mode == "pair_loop":
        ksplit = hp
    _check_item(k, d, cols, ksplit)
    _dtype(blob, torch.int8, "blob")
    _dtype(ctx, torch.float32, "ctx")
    if not _on_card(blob, ctx):
        return plain_probe_pair_proj(blob, ctx, mode)
    blob, ctx = _contig(blob, ctx)
    p = blob.shape[0]
    out = torch.empty((p, 1, d), dtype=torch.bfloat16, device=ctx.device)
    _launch("probe_pair_proj", "probe_pair_proj", (ctx, blob, out),
            (p, hp, dl, PAIR_MODES.index(mode), cols, ksplit), p, d, ksplit,
            p * (d // cols), ksplit > 1)
    return out


# -- shared by the scripts ---------------------------------------------------

def within(out, ref, rtol: float = 2 ** -7) -> bool:
    """|out - ref| <= rtol |ref| + 1e-5 max|ref| everywhere.  The default
    is one bf16 step: sums in another order round to the neighbouring bf16
    value at most."""
    ref = ref.float()
    atol = 1e-5 * float(ref.abs().max())
    return bool(((out.float() - ref).abs() <= rtol * ref.abs() + atol).all())


def rel_err(out, ref) -> float:
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


def chip_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path, for its timing
    helpers (``time_ms``: CUDA events around calls queued behind a spin)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def variant_runner(device: str, int8_bytes: int, name: str, smoke=None):
    """``run(tag, fn, panels, n_bytes, ref=None, rtol=2**-7, iters=30)`` for
    a script's variants: calls ``fn`` once and holds its output against
    ``ref`` (:func:`within`); on the card then times ``fn`` and prints ms,
    GB/s over ``int8_bytes`` (the JAX scripts' ``total_mb``), µs a panel
    and the bound of ``n_bytes`` at 3.35 TB/s (the 2 flops a weight byte
    are far below it); on the CPU it prints the output's shape and times
    nothing.  ``run.failed`` lists the tags whose output was not within
    tolerance; ``run.finish()`` reports them and returns the exit code.
    ``smoke`` gives the timing helpers (``time_ms``, ``bound``,
    ``PEAK_FP32_CUDA_CORES``): ``chip_smoke.py`` passes itself, a script run
    alone loads it by path (:func:`chip_smoke`)."""
    on_card = device == "cuda"
    if on_card and smoke is None:
        smoke = chip_smoke()
    mb = int8_bytes / 1e6

    def run(tag, fn, panels, n_bytes, ref=None, rtol=2 ** -7, iters=30):
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        if ref is not None and not within(out, ref, rtol):
            run.failed.append(tag)
        err = ("" if ref is None
               else f", max rel err {rel_err(out, ref):.2e} (gate {rtol:.2e})")
        if not on_card:
            print(f"{tag:10s}: {tuple(out.shape)} on the CPU (plain "
                  f"version), not timed{err}")
            return out
        ms, _ = smoke.time_ms(torch, lambda i: fn(), iters=iters,
                              warmup=min(iters, 5))
        b_ms, _ = smoke.bound(n_bytes, 2 * int8_bytes,
                              smoke.PEAK_FP32_CUDA_CORES)
        print(f"{tag:10s}: {ms:7.3f} ms  {mb / ms:7.1f} GB/s  "
              f"({ms / panels * 1e3:6.2f} us/panel, {panels} panels)  "
              f"bound {b_ms * 1e3:6.2f} us{err}")
        return out

    def finish() -> int:
        if run.failed:
            print(f"{name}: not within tolerance of the reference: "
                  f"{run.failed}", file=sys.stderr)
            return 1
        print(f"{name} OK")
        return 0

    run.failed, run.finish = [], finish
    return run
