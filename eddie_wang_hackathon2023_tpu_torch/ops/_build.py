"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``) and loaded with ``ctypes``.  A
library may be another's source built with macros of its own
(:data:`DEFINES`: the megakernel's decoder-only set, and each set's e4m3
self-cache instantiations).  The library name
carries a hash of the source and the flags, so an edited source is
rebuilt.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together.  A source elsewhere (a user's kernel, as in
``examples/custom_kernel_torch/``) joins them by :func:`register`, with
its own signature table.  Nothing here is compiled at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of the C entry points, per library
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "decode_attention": {
        "decode_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                             _F, _P, _P, _P, _P],
        # x, w, layer, scale, bias, out, B, K, N, then the wrapper's
        # gemv_plan: cluster, rows, batch; stream
        "out_proj_gemv": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
        # ..., S, then the wrapper's beam_plan: splits, width, cols, rounds,
        # rs, rows
        "beam_decode_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P, _P, _P, _F, _P, _P,
                                  _P, _I, _P, _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P, _F, _P],
        "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P, _F, _P],
        "flash_attention_hopper_config": [_P],
    },
    "decoder_layer": {
        # (const MegaArgs*, stream)
        "decoder_megakernel": [_P, _P],
    },
    # the megakernel's decoder-only set, built from decoder_layer.cu
    "decoder_stack": {
        "decoder_megakernel": [_P, _P],
    },
    "gqa_decode_attention": {
        "gqa_decode_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _F, _P, _P, _P, _P],
    },
    "paged_decode_attention": {
        # ..., scale, then the wrapper's paged_plan: splits, width, warps,
        # rounds, heads
        "paged_decode_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                                   _P, _P],
        # the window entry: ..., B, MB, W, table, seq_len, offset, kscale,
        # scale, out, stream
        "paged_window_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P, _P, _P, _P, _F, _P, _P],
        # the beam entry: ..., B, MB, table, seq_len, ind, bw, S_ind,
        # kscale, scale, then paged_plan's splits, width, warps, rounds;
        # out, stream
        "paged_beam_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                 _P, _P, _I, _I, _P, _F, _I, _I, _I, _I, _P,
                                 _P],
    },
    "int4_quant_matmul": {
        # x, qw, scale, M, N, K, groups, then the wrapper's prefill_plan:
        # rows, stages; out, stream
        "int4_quant_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
        "int4_quant_matmul_decode": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _P, _P],
    },
}

# the source of each library: csrc/<name>.cu unless registered elsewhere
# or built from another library's source with macros of its own
SOURCES: Dict[str, Path] = {name: CSRC / f"{name}.cu" for name in SIGNATURES}
SOURCES["decoder_stack"] = CSRC / "decoder_layer.cu"
# each set's e4m3 self-cache instantiations, a library apart
for _name in ("decoder_layer_fp8", "decoder_stack_fp8"):
    SIGNATURES[_name] = dict(SIGNATURES["decoder_layer"])
    SOURCES[_name] = CSRC / "decoder_layer.cu"
DEFINES: Dict[str, list] = {
    "decoder_stack": ["-DMEGA_DECODER_ONLY"],
    "decoder_layer_fp8": ["-DMEGA_SELF_E4M3"],
    "decoder_stack_fp8": ["-DMEGA_DECODER_ONLY", "-DMEGA_SELF_E4M3"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def register(name: str, source, signatures) -> None:
    """Make the source at path ``source``, whose C entry points have the
    ctypes argument types ``signatures`` ({function: [argtypes]}), known to
    :func:`build` and :func:`load` as library ``name``."""
    source = Path(source).resolve()
    if SOURCES.get(name, source) != source:
        raise ValueError(f"library {name!r} is already {SOURCES[name]}")
    SOURCES[name] = source
    SIGNATURES[name] = dict(signatures)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(name: str) -> list:
    return NVCC_FLAGS + DEFINES.get(name, [])


def _lib_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    # the headers beside the source (csrc/e4m3.cuh) are part of it
    for header in sorted(SOURCES[name].parent.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process each, all started together.  Returns {name: nvcc output}."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: BUILD_LOGS.get(n, "") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
