"""The (dp, sp) render mesh over the ranks of a torch.distributed group.

Counterpart of ptsharp_tpu/parallel/mesh.py. The JAX package lays a
jax.sharding.Mesh over its devices; the port runs one process per device
(a rank) and lays the mesh over the ranks of the default process group:
image rows shard over "dp", samples per pixel over "sp", the scene is
replicated on every rank, and the film and the gradients are summed by
collectives (parallel/shard.py). Ranks are laid out row-major, as
np.asarray(devices).reshape(dp, sp) lays out devices:
rank = dp_index * sp + sp_index.

`Mesh` is a small class of its own, not torch.distributed's DeviceMesh:
every collective runs over the default group (each rank joins each
all_reduce, so no subgroup is made), and gloo ranks may share one card,
which a "cuda" DeviceMesh, one card a rank, does not allow.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ptsharp_tpu_torch.core import device as devices


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x sp mesh. `device` holds its tensors."""

    dp: int
    sp: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def rank_device(device=None) -> torch.device:
    """`device`, or this rank's own: the card torch.cuda.set_device chose
    under NCCL, the CPU under gloo, the card without a process group."""
    if device is not None:
        return devices.resolve(device)
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    devices.resolve(devices.DEFAULT)
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(dp: int | None = None, sp: int = 1, device=None) -> Mesh:
    """A (dp, sp) mesh over the ranks of the default process group (one
    rank without one). Defaults: every rank on the dp (image-row) axis."""
    if dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = 1, 0
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise AssertionError(f"mesh {dp}x{sp} != {n} ranks")
    return Mesh(dp, sp, rank, rank_device(device))


def single_device_mesh(device=None) -> Mesh:
    """A 1 x 1 mesh of this process alone; it needs no process group."""
    return Mesh(1, 1, 0, rank_device(device))
