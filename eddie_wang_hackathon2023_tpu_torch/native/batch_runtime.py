"""ctypes bindings of the port's native batching runtime
(``batch_runtime.cc``): the paged-KV block bookkeeping and the
continuous-batching slot scheduler, with the API and the semantics of the
Python ``runtime/kv_cache_manager.KVCacheManager`` and
``runtime/batch_manager._PyScheduler`` (the JAX package's
``native/batch_runtime.py``, bound to the port's own copy of the source).

The library is built by ``g++`` at first use into ``build/native/``
(:func:`..native.build_library`); :func:`available` says whether it
builds and loads here."""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from . import SOURCE_DIR, build_library

SOURCE = SOURCE_DIR / "batch_runtime.cc"

c_u8p = ctypes.POINTER(ctypes.c_uint8)
c_i32p = ctypes.POINTER(ctypes.c_int32)
c_i64p = ctypes.POINTER(ctypes.c_int64)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("ewtruntime", SOURCE)))
    sigs = {
        "ewt_kv_create": (ctypes.c_void_p, [ctypes.c_int] * 4),
        "ewt_kv_destroy": (None, [ctypes.c_void_p]),
        "ewt_kv_add_sequence": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]),
        "ewt_kv_step": (ctypes.c_int, [ctypes.c_void_p, c_u8p]),
        "ewt_kv_stop": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
        "ewt_kv_num_sequences": (ctypes.c_int, [ctypes.c_void_p]),
        "ewt_kv_free_blocks": (ctypes.c_int, [ctypes.c_void_p]),
        "ewt_kv_block_table": (None, [ctypes.c_void_p, c_i32p]),
        "ewt_sched_create": (ctypes.c_void_p, [ctypes.c_int] * 3),
        "ewt_sched_destroy": (None, [ctypes.c_void_p]),
        "ewt_sched_add_request": (None, [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint8]),
        "ewt_sched_next_admission": (ctypes.c_int, [ctypes.c_void_p,
                                                    c_i64p]),
        "ewt_sched_on_admitted": (None, [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]),
        "ewt_sched_push_token": (ctypes.c_int, [ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_int]),
        "ewt_sched_num_pending": (ctypes.c_int, [ctypes.c_void_p]),
        "ewt_sched_num_active": (ctypes.c_int, [ctypes.c_void_p]),
        "ewt_sched_state": (None, [ctypes.c_void_p, c_u8p, c_i32p, c_i32p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


class NativeKVCacheManager:
    """The API and semantics of ``runtime.kv_cache_manager.KVCacheManager``
    with the bookkeeping in C++; sequences are named by integer ids."""

    def __init__(self, num_layers: int, num_blocks: int,
                 tokens_per_block: int, max_blocks_per_seq: int,
                 beam_width: int = 1):
        self._lib = _lib()
        self.num_layers = num_layers
        self.tokens_per_block = tokens_per_block
        self.max_blocks_per_seq = max_blocks_per_seq
        self.beam_width = beam_width
        self._h = ctypes.c_void_p(self._lib.ewt_kv_create(
            num_blocks, tokens_per_block, max_blocks_per_seq, beam_width))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ewt_kv_destroy(h)
            self._h = None

    def add_sequence(self, seq_id: int, context_len: int) -> None:
        if self._lib.ewt_kv_add_sequence(self._h, seq_id, context_len) != 0:
            raise RuntimeError("KV cache block pool exhausted")

    def step(self, finished: List[bool]) -> None:
        arr = np.ascontiguousarray(finished, np.uint8)
        if self._lib.ewt_kv_step(self._h, arr.ctypes.data_as(c_u8p)) != 0:
            raise RuntimeError("KV cache block pool exhausted")

    def stop(self, seq_id: int) -> None:
        if self._lib.ewt_kv_stop(self._h, seq_id) != 0:
            raise KeyError(f"unknown sequence {seq_id}")

    @property
    def num_sequences(self) -> int:
        return self._lib.ewt_kv_num_sequences(self._h)

    @property
    def free_block_count(self) -> int:
        return self._lib.ewt_kv_free_blocks(self._h)

    def get_block_index_arrays(self) -> np.ndarray:
        """[sequences, beam, max_blocks] int32, -1 padded."""
        n = self.num_sequences
        out = np.empty((n, self.beam_width, self.max_blocks_per_seq),
                       np.int32)
        self._lib.ewt_kv_block_table(self._h, out.ctypes.data_as(c_i32p))
        return out


class NativeScheduler:
    """Slot lifecycle and stop decisions of continuous batching, the API of
    ``runtime.batch_manager._PyScheduler``.  ``push_token``'s flag bits:
    1 finished, 2 stream."""

    FINISHED = 1
    STREAM = 2

    def __init__(self, max_slots: int, max_seq_len: int, end_id: int):
        self._lib = _lib()
        self.max_slots = max_slots
        self._h = ctypes.c_void_p(
            self._lib.ewt_sched_create(max_slots, max_seq_len, end_id))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ewt_sched_destroy(h)
            self._h = None

    def add_request(self, request_id: int, max_new_tokens: int,
                    end_id: int = -1, streaming: bool = False) -> None:
        self._lib.ewt_sched_add_request(self._h, request_id, max_new_tokens,
                                        end_id, int(streaming))

    def next_admission(self) -> Tuple[int, int]:
        """(slot, request id), or (-1, -1) when there is nothing to
        admit or no free slot."""
        rid = ctypes.c_int64(-1)
        slot = self._lib.ewt_sched_next_admission(self._h, ctypes.byref(rid))
        return slot, int(rid.value)

    def on_admitted(self, slot: int, prompt_len: int) -> None:
        self._lib.ewt_sched_on_admitted(self._h, slot, prompt_len)

    def push_token(self, slot: int, tok: int) -> int:
        return self._lib.ewt_sched_push_token(self._h, slot, tok)

    @property
    def num_pending(self) -> int:
        return self._lib.ewt_sched_num_pending(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.ewt_sched_num_active(self._h)

    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(active [slots] bool, lengths [slots] int32, last tokens
        [slots] int32)."""
        active = np.empty((self.max_slots,), np.uint8)
        lengths = np.empty((self.max_slots,), np.int32)
        last = np.empty((self.max_slots,), np.int32)
        self._lib.ewt_sched_state(self._h, active.ctypes.data_as(c_u8p),
                                  lengths.ctypes.data_as(c_i32p),
                                  last.ctypes.data_as(c_i32p))
        return active.astype(bool), lengths, last
