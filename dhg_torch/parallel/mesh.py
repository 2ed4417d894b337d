"""The (data, model) grid of ranks and its process groups (port of
dhg/parallel/mesh.py).

dhg lays its devices out as Mesh(('data', 'model')); here each rank is one
process with one device, laid out row-major as dhg reshapes its device
list: rank = d * model_parallel + m. Each model index has a data group (the
ranks that hold the same weight shards and average their gradients); each
data index has a model group (the ranks that split one forward's heads and
FFN hiddens, see parallel/sharding.py). A group of one rank is None, so a
one-process run, whose mesh is (1, 1), adds no operation.

A model group must lie on one host: the tensor-parallel seam sends
activations through every attention and FFN (dhg's limit was cross-host
checkpoint gathers; the port gathers through the group, so its limit is
the link).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_layout(world_size: int, model_parallel: int = 1, data_parallel: int | None = None
                ) -> np.ndarray:
    """[data_parallel, model_parallel] ranks: row d is data index d's model
    group, column m is model index m's data group."""
    if model_parallel < 1 or world_size % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the {world_size} ranks")
    if data_parallel is None:
        data_parallel = world_size // model_parallel
    if data_parallel * model_parallel != world_size:
        raise ValueError(f"mesh ({data_parallel}, {model_parallel}) does not cover the "
                         f"{world_size} ranks")
    return np.arange(world_size).reshape(data_parallel, model_parallel)


@dataclass
class Mesh:
    """This rank's place in the grid and the process groups it belongs to."""

    layout: np.ndarray  # [data, model] ranks
    rank: int = 0
    data_group: object = None  # None when the data axis has one rank
    model_group: object = None  # None when the model axis has one rank

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.layout.shape)

    @property
    def data_size(self) -> int:
        return self.layout.shape[0]

    @property
    def model_size(self) -> int:
        return self.layout.shape[1]

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.layout == self.rank)[0][0])

    @property
    def model_index(self) -> int:
        return int(np.argwhere(self.layout == self.rank)[0][1])


def make_mesh(model_parallel: int = 1, data_parallel: int | None = None) -> Mesh:
    """The mesh over every rank of the process group (one rank without one).
    Every rank creates every group, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel > world:
        raise ValueError(f"model_parallel={model_parallel} needs as many processes "
                         f"(this run has {world})")
    layout = mesh_layout(world, model_parallel, data_parallel)
    if world == 1:
        return Mesh(layout)
    rank = dist.get_rank()
    dp, mp = layout.shape
    if mp > 1:
        hosts = [None] * world
        dist.all_gather_object(hosts, socket.gethostname())
        for row in layout:
            if len({hosts[r] for r in row}) > 1:
                raise NotImplementedError(
                    f"model group {row.tolist()} spans hosts {sorted({hosts[r] for r in row})}: "
                    "a model group must lie on one host; put data_parallel across hosts")
    data_group = model_group = None
    for m in range(mp):
        g = dist.new_group(layout[:, m].tolist()) if dp > 1 else None
        if rank in layout[:, m]:
            data_group = g
    for d in range(dp):
        g = dist.new_group(layout[d].tolist()) if mp > 1 else None
        if rank in layout[d]:
            model_group = g
    return Mesh(layout, rank, data_group, model_group)
