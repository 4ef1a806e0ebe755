"""Banded-M halo exchange across the time axis (port of
tmgcn_tpu.parallel.halo).

TM-GCN's M-transform mixes each slice with its ``band-1`` predecessors
(banded lower-triangular M). When the time axis is sharded, a shard
therefore needs only its predecessors' last ``band-1`` slices: here one
all-gather of each shard's tail (at most T_loc slices) over the time group,
of which every shard keeps its predecessors' parts — the JAX package's
hops of one ``ppermute`` each. The gather's backward sums every receiver's
gradient of a tail back into its sender's: the transpose of the hops, which
the m2/m3 mixings inside a training step need.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tmgcn_torch.parallel import collectives


def halo_exchange_backward(x_loc: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The previous ``halo`` time slices from predecessor shards.

    Returns (halo, ...) slices ordered oldest-first. When the halo spans
    more than one shard window (band-1 > T_loc), hop j brings the tail of
    shard i-j to shard i, as the JAX package's j-th ``ppermute`` does.
    Shards with fewer than j predecessors receive zeros (banded causal M
    has no wraparound — nothing precedes t=0); on a time group of one the
    halo is all zeros, with no communication.
    """
    if halo <= 0:
        return x_loc[:0]  # diagonal M: no neighbour slices needed
    T_loc = x_loc.shape[0]
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x_loc.new_zeros((halo,) + tuple(x_loc.shape[1:]))
    n_hops = -(-halo // T_loc)  # ceil
    tails = collectives.all_gather(x_loc[-min(T_loc, halo):], group)
    parts = []
    for j in range(n_hops, 0, -1):
        # Hop j supplies the slice range [t0 - j*T_loc, t0 - (j-1)*T_loc)
        # clipped to the halo: the sender's tail of width w.
        w = min(T_loc, halo - (j - 1) * T_loc)
        part = tails[max(idx - j, 0), tails.shape[1] - w:]
        if idx < j:
            # Zeros, still read from the gather: every rank's backward must
            # reach the gather, whose backward is a collective.
            part = part.masked_fill(torch.ones((), dtype=torch.bool, device=part.device), 0)
        parts.append(part)
    return torch.cat(parts, dim=0)


def local_banded_m(M: np.ndarray, n_time: int, halo: int) -> np.ndarray:
    """Precompute per-shard banded M blocks: (n_time, T_loc, T_loc + halo).

    Shard i's block maps its extended input window [t0 - halo, t0 + T_loc)
    to its local output slices [t0, t0 + T_loc); columns reaching before
    t=0 are zero (matching the causal band).
    """
    M = np.asarray(M)
    T = M.shape[0]
    if T % n_time:
        raise ValueError(f"T={T} not divisible by n_time={n_time}")
    T_loc = T // n_time
    # halo > T_loc is fine: halo_exchange_backward brings one tail per
    # predecessor shard window the band reaches into.
    M_pad = np.concatenate([np.zeros((T, halo)), M], axis=1)  # (T, halo + T)
    blocks = np.zeros((n_time, T_loc, T_loc + halo))
    for i in range(n_time):
        t0 = i * T_loc
        blocks[i] = M_pad[t0 : t0 + T_loc, t0 : t0 + T_loc + halo]
    return blocks


def banded_m_transform_local(x_loc: torch.Tensor, m_block: torch.Tensor, halo: int,
                             group) -> torch.Tensor:
    """Sharded M ×₁ X: halo exchange + local banded block matmul.

    Args:
        x_loc: (T_loc, N, F) this shard's feature slices.
        m_block: (T_loc, T_loc + halo) this shard's rows of M over its
            extended input window (see local_banded_m).
    Returns:
        (T_loc, N, F) this shard's slices of M ×₁ X.
    """
    h = halo_exchange_backward(x_loc, halo, group)
    ext = torch.cat([h, x_loc], dim=0)  # (T_loc + halo, N, F)
    out = torch.matmul(m_block.to(ext.dtype), ext.reshape(ext.shape[0], -1))
    return out.reshape(x_loc.shape)
