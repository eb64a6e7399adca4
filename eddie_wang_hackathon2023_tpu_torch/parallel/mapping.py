"""Device-topology mapping (the JAX package's ``parallel/mapping.py``).

The JAX package's ``Mapping`` owns a ``Mesh`` of the devices reshaped
``(dp, tp, pp)`` and lets XLA emit the collectives.  Here each rank is one
process: :class:`Mapping` gives it the same layout (its ``dp_rank`` and
``tp_rank`` are its place in that reshape) and makes, once, this rank's
tensor-parallel and data-parallel process groups with ``dist.new_group``;
the layers call :mod:`.collectives` on them.

:func:`init_distributed` replaces ``initialize_multihost``; it never
changes the backend or the device it is given or defaults to.
:func:`spawn_ranks` runs a function on N local ranks (tests, the card's
smoke script and :mod:`.dryrun`).  The module imports neither jax nor the
JAX package: a spawned rank imports the module that holds its target.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .collectives import Group

DP_AXIS = "dp"
TP_AXIS = "tp"
PP_AXIS = "pp"


class Mapping:
    """``world_size`` and ``rank`` default to the initialised process
    group's (1 and 0 without one); ``tp_size`` defaults to ``world //
    (dp * pp)``.  Rank r sits at ``(dp_rank, tp_rank, pp_rank)`` of
    ``range(world).reshape(dp, tp, pp)``, the JAX mesh's device order.
    ``tp_group`` is the JAX attribute, the whole world (kept for parity);
    :attr:`tp` and :attr:`dp` are this rank's real groups."""

    def __init__(self, world_size: Optional[int] = None,
                 rank: Optional[int] = None, gpus_per_node: int = 0,
                 tp_size: Optional[int] = None, dp_size: int = 1,
                 pp_size: int = 1):
        up = dist.is_available() and dist.is_initialized()
        if world_size is None:
            world_size = dist.get_world_size() if up else 1
        if rank is None:
            rank = dist.get_rank() if up else 0
        if tp_size is None:
            tp_size = world_size // (dp_size * pp_size)
        if dp_size * tp_size * pp_size != world_size:
            raise ValueError(f"dp({dp_size}) * tp({tp_size}) * pp({pp_size})"
                             f" != world({world_size})")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.gpus_per_node = gpus_per_node
        self.tp_size, self.dp_size, self.pp_size = tp_size, dp_size, pp_size
        self.tp_group = list(range(world_size))  # the JAX attribute
        self.dp_rank, rem = divmod(rank, tp_size * pp_size)
        self.tp_rank, self.pp_rank = divmod(rem, pp_size)
        self.tp, self.dp = self._make_groups(up and world_size > 1)

    def rank_of(self, dp_rank: int, tp_rank: int, pp_rank: int = 0) -> int:
        return (dp_rank * self.tp_size + tp_rank) * self.pp_size + pp_rank

    def _make_groups(self, real: bool):
        """This rank's tp and dp groups.  ``real``: every rank creates every
        group, in the same order (as ``dist.new_group`` requires), and
        keeps its own; otherwise (no process group initialised) the groups
        are the layout alone, enough to shard a model and its state for
        any rank (a collective on them raises)."""
        tp = dp = None
        for d in range(self.dp_size):
            for p in range(self.pp_size):
                ranks = [self.rank_of(d, t, p) for t in range(self.tp_size)]
                g = dist.new_group(ranks) if real and len(ranks) > 1 else None
                if self.rank in ranks:
                    tp = Group(len(ranks), ranks.index(self.rank), g,
                               tuple(ranks))
        for t in range(self.tp_size):
            for p in range(self.pp_size):
                ranks = [self.rank_of(d, t, p) for d in range(self.dp_size)]
                g = dist.new_group(ranks) if real and len(ranks) > 1 else None
                if self.rank in ranks:
                    dp = Group(len(ranks), ranks.index(self.rank), g,
                               tuple(ranks))
        return tp, dp

    def __repr__(self):
        return (f"Mapping(world={self.world_size}, dp={self.dp_size}, "
                f"tp={self.tp_size}, pp={self.pp_size}, rank={self.rank})")


def init_distributed(backend: Optional[str] = None, device=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None, store=None
                     ) -> torch.device:
    """Initialise ``torch.distributed`` for this rank and return its
    device.  ``rank`` / ``world_size`` default to ``RANK`` /
    ``WORLD_SIZE`` (and ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) of the
    environment; ``device`` to ``cuda:{local_rank % device_count}``;
    ``backend`` to ``nccl``.  NCCL takes one card a rank: with more local
    ranks than cards it raises (it never falls back to another backend or
    device; ask for ``gloo`` to put several ranks on one card or on the
    CPU)."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or "nccl"
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (and "
                               "backend='gloo') to run ranks on the CPU")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > cards:
            raise RuntimeError(
                f"nccl takes one card a rank: {local_world} local ranks over "
                f"{cards} card(s); ask for backend='gloo' to share a card")
        if device.type != "cuda":
            raise RuntimeError("nccl runs on CUDA devices only")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return device


def _rank_entry(rank, world_size, store_path, backend, device, out_dir):
    """A spawned rank: one intra-op thread, the process group over the
    shared FileStore, ``fn(rank, world_size, device, *args)`` (read from
    ``out_dir``: a large argument sent through the spawn pipe would hold
    the parent until each child had imported its modules, one child after
    another), its result (or its traceback) pickled into ``out_dir``."""
    torch.set_num_threads(1)
    res, err = None, None
    try:
        with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        store = dist.FileStore(store_path, world_size)
        dev = init_distributed(backend, None if device == "cuda" else device,
                               rank, world_size, store=store)
        res = fn(rank, world_size, dev, *args)
    except BaseException:                          # reported by the parent
        err = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, err), f)
    if dist.is_initialized() and err is None:
        dist.destroy_process_group()
    if err is not None:
        raise SystemExit(1)                 # the parent stops the others


class Spawned:
    """Ranks started by :func:`start_ranks`; :meth:`result` waits for them
    (once) and returns their results."""

    def __init__(self, procs, tmp, timeout):
        self._procs, self._tmp = procs, tmp
        self._deadline = time.monotonic() + timeout
        self._out = None

    def result(self) -> List:
        if self._out is None:
            try:
                self._out = self._collect()
            finally:
                shutil.rmtree(self._tmp, ignore_errors=True)
        if isinstance(self._out, Exception):
            raise self._out
        return self._out

    def _collect(self):
        procs = self._procs
        try:
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < self._deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(self._tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.exitcode})")
                continue
            with open(path, "rb") as f:
                res, err = pickle.load(f)
            if err is not None:
                errors.append(f"rank {r}:\n{err}")
            results.append(res)
        if errors:
            return RuntimeError("spawned ranks failed:\n"
                                + "\n".join(errors))
        return results


def start_ranks(fn: Callable, world_size: int, *args, backend: str = "nccl",
                device="cuda", timeout: float = 600.0) -> Spawned:
    """Start ``fn(rank, world_size, device, *args)`` on ``world_size``
    spawned local ranks with ``torch.distributed`` initialised
    (``backend``, a ``FileStore`` in a fresh temporary directory: no TCP
    port, so several callers can run side by side) and return at once;
    ``result()`` of the returned :class:`Spawned` gives each rank's
    result, in rank order.  ``device`` "cuda" (``cuda:{rank %
    device_count}``, the default, with ``nccl``: one card a rank, as
    :func:`init_distributed` takes them), "cpu" (ask for ``gloo``) or one
    device for every rank.  ``fn`` must be a
    module-level function of a module that imports no jax.  ``result()``
    raises with a rank's traceback if any rank failed, and stops every
    rank that was started."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ewt_ranks_")
    store = os.path.join(tmp, "store")
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world_size, store, backend, str(device),
                               tmp))
             for r in range(world_size)]
    for p in procs:
        p.start()
    return Spawned(procs, tmp, timeout)


def spawn_ranks(fn: Callable, world_size: int, *args, backend: str = "nccl",
                device="cuda", timeout: float = 600.0) -> List:
    """:func:`start_ranks`, then its result: each rank's
    ``fn(rank, world_size, device, *args)``."""
    return start_ranks(fn, world_size, *args, backend=backend, device=device,
                       timeout=timeout).result()
