"""Ring attention: exact attention with the sequence split over a process
group (the JAX package's ``ops/ring_attention.py``).

Each rank holds its own ``[B, H, S/N, D]`` shard of q, k and v.  q stays
put; the K/V shards go round the ring N times (rank i sends to i + 1 and
receives from i - 1, one ``batch_isend_irecv`` a step,
:func:`..parallel.collectives.send_recv`), and each step's block is folded
into an online softmax in fp32.  At step t rank i holds the shard that
started on rank (i - t) mod N, so the causal mask compares absolute
positions, as the JAX body's ``:37-45`` does.  The JAX version is XLA (no
Pallas kernel), so the per-step block here is plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives
from ..parallel.collectives import Group


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Group, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: this rank's ``[B, H, S/N, D]`` shard of the sequence (rank
    ``group.rank`` holds rows ``[rank * S/N, (rank + 1) * S/N)``) -> this
    rank's rows of softmax(q k^T scale) v over the whole sequence, in q's
    dtype.  Every rank of ``group`` must call it."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n, idx = group.size, group.rank
    b, h, sq, d = q.shape
    qf = q.float() * scale
    m = torch.full((b, h, sq, 1), float("-inf"), device=q.device)
    num = torch.zeros((b, h, sq, d), device=q.device)
    den = torch.zeros((b, h, sq), device=q.device)
    rows = idx * sq + torch.arange(sq, device=q.device)[:, None]
    k_t, v_t = k, v
    for t in range(n):
        src = (idx - t) % n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_t.float())
        if causal:
            cols = src * k_t.shape[2] + torch.arange(k_t.shape[2],
                                                     device=q.device)[None]
            s = torch.where(cols <= rows, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        num = num * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_t.float())
        den = den * corr[..., 0] + p.sum(dim=-1)
        m = m_new
        if t + 1 < n and n > 1:
            k_t, v_t = collectives.send_recv([k_t, v_t], (idx + 1) % n,
                                             (idx - 1) % n, group)
    return (num / den[..., None]).to(q.dtype)
