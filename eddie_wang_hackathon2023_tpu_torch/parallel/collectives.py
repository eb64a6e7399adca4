"""The collectives the sharded layers call, over one process group.

The JAX package has no such layer: XLA inserts its collectives from the
parameters' ``PartitionSpec``s.  Here each rank is a process that holds
only its shard, and the layers call these helpers on the group that the
:class:`~.mapping.Mapping` gives them.  A group of size 1 (or ``None``)
makes every helper the identity, so an unsharded model runs no collective.

Every call is counted in :data:`calls` and its host wall time added to
:data:`seconds`, so a caller can say what share of a step went to
collectives.  ``gloo`` with CUDA tensors
(several ranks on one card, where NCCL refuses) takes them in
``all_reduce`` and ``all_gather``, but not in its point-to-point calls
(the send hands the device pointer to the socket, which refuses it, and
gloo aborts the process): :func:`send_recv` then copies the tensors to
the host, exchanges them there and copies the received ones back.
``tools/gloo_cuda_probe.py`` finds which calls take CUDA tensors on the
installed torch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch
import torch.distributed as dist

calls = {"all_reduce": 0, "all_gather": 0, "send_recv": 0}
seconds = dict.fromkeys(calls, 0.0)


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of a process group: its size, this rank's index in
    it, the ``torch.distributed`` group (None for size 1) and the global
    ranks in it, in order."""
    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    ranks: tuple = (0,)

    @property
    def active(self) -> bool:
        return self.size > 1


def reset() -> None:
    """Zero every count and time."""
    for k in calls:
        calls[k], seconds[k] = 0, 0.0


def total_seconds() -> float:
    return sum(seconds.values())


def _count(op: str, t0: float) -> None:
    calls[op] += 1
    seconds[op] += time.perf_counter() - t0


def all_reduce(x: torch.Tensor, grp: Optional[Group]) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor on every rank; every
    rank gets the same bits)."""
    if grp is None or not grp.active:
        return x
    t0 = time.perf_counter()
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=grp.group)
    _count("all_reduce", t0)
    return y


def all_gather(x: torch.Tensor, grp: Optional[Group],
               dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order."""
    if grp is None or not grp.active:
        return x
    t0 = time.perf_counter()
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(grp.size)]
    dist.all_gather(parts, src, group=grp.group)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", t0)
    return out


def send_recv(send: List[torch.Tensor], to: int, recv_from: int,
              grp: Group) -> List[torch.Tensor]:
    """Send ``send`` to group rank ``to`` and receive tensors of the same
    shapes from group rank ``recv_from``, in one
    ``batch_isend_irecv`` (through the host for CUDA tensors under
    gloo)."""
    t0 = time.perf_counter()
    staged = (bool(send) and send[0].is_cuda
              and dist.get_backend(grp.group) == "gloo")
    dev = send[0].device
    outs = [s.detach().contiguous().cpu() if staged
            else s.detach().contiguous() for s in send]
    ins = [torch.empty_like(s) for s in outs]
    ops = ([dist.P2POp(dist.isend, s, grp.ranks[to], grp.group)
            for s in outs]
           + [dist.P2POp(dist.irecv, r, grp.ranks[recv_from], grp.group)
              for r in ins])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        ins = [r.to(dev) for r in ins]
    _count("send_recv", t0)
    return ins
