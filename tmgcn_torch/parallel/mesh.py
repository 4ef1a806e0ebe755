"""The (graph, time) process mesh (port of tmgcn_tpu.parallel.mesh).

The parallelism model of the JAX package, one process per device: a 2-D
logical mesh with axes

  * ``graph`` — node/row partitioning of every slice's adjacency; SpMM
    row blocks are local, boundary features arrive by all-gather;
  * ``time``  — temporal slices are embarrassingly parallel in TM-GCN
    (no recurrence); the banded M-transform needs only band-width halo
    slices from time-neighbours.

Rank r holds mesh position (g, t) with r = g * n_time + t, the order
``mesh_utils.create_device_mesh((G, T))`` gives a flat device list. The
``graph_group`` of a rank is the ranks that share its time index (the
collectives of JAX's ``graph`` axis), its ``time_group`` the ranks that
share its graph index. One card allows the 1 x 1 mesh only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tmgcn_torch.parallel.distributed import TIMEOUT

GRAPH_AXIS = "graph"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the groups it belongs to and its
    position. ``shape`` maps each axis name to its size, as JAX's does."""

    shape: dict[str, int]
    g: int
    t: int
    device: torch.device
    world: dist.ProcessGroup
    graph_group: dist.ProcessGroup
    time_group: dist.ProcessGroup

    @property
    def n_graph(self) -> int:
        return self.shape[GRAPH_AXIS]

    @property
    def n_time(self) -> int:
        return self.shape[TIME_AXIS]


def factorize(n: int, n_graph: int | None = None, n_time: int | None = None) -> tuple[int, int]:
    """(n_graph, n_time) for n devices, as the JAX package factorizes:
    more devices on the graph axis (node counts dwarf slice counts), a 2-D
    mesh where the count allows one."""
    if n_graph is None and n_time is None:
        n_time, n_graph = 1, n
        for t in (2, 4):
            if n % t == 0 and n // t >= t:
                n_time, n_graph = t, n // t
    elif n_graph is None:
        n_graph = n // n_time
    elif n_time is None:
        n_time = n // n_graph
    if n_graph * n_time != n:
        raise ValueError(f"mesh {n_graph}x{n_time} != {n} devices (the world size)")
    return n_graph, n_time


def make_mesh(n_graph: int | None = None, n_time: int | None = None,
              device: str | torch.device = "cpu", n_ranks: int | None = None) -> Mesh | None:
    """Build the (graph, time) mesh over the world (``distributed.initialize``
    first): G * T must be the world size. Every rank makes every group, in
    the same order, and runs one collective on each of its own, so that
    NCCL's communicators exist before a CUDA graph captures a step.

    ``n_ranks``: the mesh over the world's first ``n_ranks`` ranks alone
    (``utils/scaling_bench``'s 1, 2 and 4 of 4); every rank of the world
    calls this, and the others get None."""
    device = torch.device(device)
    if device.type == "cuda" and n_graph is not None and n_time is not None:
        n_cards = torch.cuda.device_count()
        if n_graph * n_time > n_cards:
            raise ValueError(f"mesh {n_graph}x{n_time} needs {n_graph * n_time} GPUs, one "
                             f"per process; {n_cards} visible")
    size = dist.get_world_size() if n_ranks is None else n_ranks
    G, T = factorize(size, n_graph, n_time)
    rank = dist.get_rank()
    g, t = divmod(rank, T)
    world = dist.group.WORLD
    if n_ranks is not None:
        world = dist.new_group(list(range(n_ranks)), timeout=TIMEOUT)
    graph_group = time_group = None
    for ti in range(T):
        group = dist.new_group([gi * T + ti for gi in range(G)], timeout=TIMEOUT)
        if ti == t:
            graph_group = group
    for gi in range(G):
        group = dist.new_group([gi * T + ti for ti in range(T)], timeout=TIMEOUT)
        if gi == g:
            time_group = group
    if rank >= size:
        return None
    mesh = Mesh({GRAPH_AXIS: G, TIME_AXIS: T}, g, t, device, world, graph_group, time_group)
    for group in (mesh.world, graph_group, time_group):
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    return mesh
