"""FLAC input through the port's native decoder (``native/flac_decoder.cc``,
bound with ctypes), the contract of the JAX package's ``audio/flac.py``:
mono float32 in [-1, 1] at 16 kHz.

The library is compiled with ``g++`` at first use into ``build/native/``
(:func:`..native.build_library`).  A failed build or decode raises;
nothing falls back to another reader.  Nothing is compiled at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from functools import lru_cache
from pathlib import Path
from typing import Tuple

import numpy as np

from .. import native

SOURCE = native.SOURCE_DIR / "flac_decoder.cc"
BUILD_DIR = native.BUILD_DIR
SAMPLE_RATE = 16000


def library_path() -> Path:
    """The decoder library in BUILD_DIR, built first if it is missing."""
    return native.build_library("ewtflac", SOURCE, BUILD_DIR)


@lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ewt_flac_decode.restype = ctypes.c_int
    lib.ewt_flac_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ewt_flac_free.restype = None
    lib.ewt_flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    return lib


def _streaminfo_md5(path: str) -> bytes:
    """STREAMINFO's MD5 of the samples (the format puts STREAMINFO first:
    4 bytes of marker, 4 of block header, the MD5 at bytes 18-33)."""
    with open(path, "rb") as f:
        head = f.read(42)
    if len(head) < 42 or head[:4] != b"fLaC" or head[4] & 0x7F != 0:
        raise RuntimeError(f"{path}: no STREAMINFO block first")
    return head[26:42]


def decode_pcm(path: str) -> Tuple[np.ndarray, int, int]:
    """-> (samples int32 [n, channels] at the stream's bit depth, sample
    rate, bits per sample).  Raises on a decode error (a frame's CRC among
    them) and when the samples' MD5 is not STREAMINFO's (unless the
    encoder left it zero, as the format allows)."""
    lib = _load(str(library_path()))
    samples = ctypes.POINTER(ctypes.c_int32)()
    n, sr, ch, bps = (ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(),
                      ctypes.c_int())
    rc = lib.ewt_flac_decode(os.fsencode(path), ctypes.byref(samples),
                             ctypes.byref(n), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(bps))
    if rc != 0:
        raise RuntimeError(f"FLAC decode failed ({rc}) for {path}")
    try:
        total = n.value * ch.value
        pcm = (np.ctypeslib.as_array(samples, shape=(total,)).copy()
               if total else np.zeros((0,), np.int32))
    finally:
        lib.ewt_flac_free(samples)
    md5 = _streaminfo_md5(path)
    if any(md5):
        width = (bps.value + 7) // 8
        raw = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :width]
        if hashlib.md5(raw.tobytes()).digest() != md5:
            raise RuntimeError(f"{path}: the samples' MD5 is not "
                               "STREAMINFO's")
    return pcm.reshape(-1, ch.value), sr.value, bps.value


def decode_file(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Mono float32 in [-1, 1] (the channels' mean over 2 ** (bits - 1)),
    as the JAX package's ``native.flac.decode_file``.  A sample rate other
    than ``target_sr`` raises: there is no resampler."""
    pcm, sr, bps = decode_pcm(path)
    if sr != target_sr:
        raise RuntimeError(f"{path}: sample rate {sr} != {target_sr} "
                           "(no resampler)")
    arr = pcm.reshape(-1)
    if pcm.shape[1] > 1:
        arr = pcm.mean(axis=1)
    return arr.astype(np.float32) / float(1 << (bps - 1))


def read_flac(path: str) -> np.ndarray:
    """A 16 kHz FLAC file -> mono float32 samples in [-1, 1]."""
    return decode_file(path)
