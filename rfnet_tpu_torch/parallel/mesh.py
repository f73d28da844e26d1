"""Data parallelism over ``torch.distributed``: one process (rank) a card.

Port of ``rfnet_tpu/parallel/mesh.py``. The JAX package runs one process
over a ``Mesh`` of all local devices and lets XLA insert the collectives;
PyTorch's idiom is one process a card, launched by ``torchrun``, with the
collectives written out. So a "mesh" here is the record of one rank:
its process group, its rank, the world size and its device.

    torchrun --nproc_per_node 4 -m rfnet_tpu_torch.train --mesh ...

Every collective is an ``all_reduce`` (SUM, MIN or MAX) or a
``broadcast``: gloo supports no others on CUDA tensors, and with these the
same code runs with NCCL a rank a card, with gloo on the CPU, and with gloo
for several ranks sharing one card.

``data_sharding`` and ``replicated`` have no counterpart: they are
``NamedSharding`` annotations that tell XLA how a global array lies over
the devices. A rank here holds plain tensors: its own rows of a batch
(:func:`shard_batch`) and a full copy of the parameters.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from rfnet_tpu_torch import kernels

# the variables torchrun sets for each rank it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def torchrun_world() -> int | None:
    """The world size torchrun set for this process, or None outside
    torchrun (any of its variables missing)."""
    if any(k not in os.environ for k in TORCHRUN_ENV):
        return None
    return int(os.environ["WORLD_SIZE"])


def _rank_device(device: torch.device | str, rank: int, world: int) -> torch.device:
    """This rank's device: ``device`` as given where it names a card (or
    the CPU); for a bare "cuda" the card ``LOCAL_RANK`` (0 in a world of 1).
    Fails with a message where that card does not exist."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"device {device}: only cuda and cpu are supported")
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise SystemExit(f"device {device}: no CUDA device is available (pass --device cpu)")
    index = device.index
    if index is None:
        if "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        elif world == 1:
            index = 0
        else:
            raise SystemExit(f"rank {rank} of {world}: pass the rank's card (cuda:<i>); "
                             "LOCAL_RANK is not set")
    if index >= torch.cuda.device_count():
        raise SystemExit(
            f"rank {rank}: card cuda:{index} does not exist ({torch.cuda.device_count()} "
            "visible); NCCL needs a card a rank (two ranks on one card: a gloo group)")
    return torch.device("cuda", index)


def maybe_initialize_distributed(device: torch.device | str = "cuda") -> bool:
    """Form the default process group from torchrun's environment: NCCL for
    a CUDA ``device``, gloo for the CPU. Returns True iff it formed it; a
    no-op (False) outside torchrun or where a group already exists, as the
    JAX package's bootstrap is a no-op without its coordinator variables."""
    if dist.is_initialized() or torchrun_world() is None:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = _rank_device(device, rank, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                                device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel world: ``group`` None is a
    world of 1 with no process group, where every collective is the
    identity."""

    group: dist.ProcessGroup | None
    rank: int
    size: int
    device: torch.device

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's rows ``[r·B/W, (r+1)·B/W)`` of a global batch of B."""
        if batch % self.size:
            raise ValueError(f"batch {batch} does not split over {self.size} ranks")
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all_reduce of ``t`` (op "sum", "min" or "max")."""
        if self.group is not None:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of ``t`` (a new tensor): SUM, then divide."""
        return self.all_reduce_(t.detach().clone()) / self.size

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, src), group=self.group)
        return t

    def barrier(self) -> None:
        """Every rank waits here for the others (one all_reduce of a zero,
        which both backends take on any device)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def build_kernels(self) -> None:
        """On a card, the first rank of each machine (LOCAL_RANK 0) builds the
        CUDA kernels' library while the others wait at a barrier, so that
        the ranks do not each run nvcc; a no-op on the CPU."""
        if self.device.type != "cuda":
            return
        if int(os.environ.get("LOCAL_RANK", self.rank)) == 0:
            kernels.build()
        self.barrier()


def make_mesh(n_devices: int | None = None, device: torch.device | str = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over the default process group (formed by
    :func:`maybe_initialize_distributed` or by the caller), or a world of 1
    where there is none. ``n_devices`` must be the world's size: a larger
    request is refused as the JAX package refuses more devices than exist,
    a smaller one because the ranks beyond it would have no rows."""
    group = dist.group.WORLD if dist.is_initialized() else None
    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    if n_devices is not None and n_devices != world:
        if n_devices > world:
            raise ValueError(f"requested {n_devices}-device mesh but only {world} present")
        raise ValueError(f"requested {n_devices}-device mesh in a world of {world} ranks: "
                         f"launch {n_devices} ranks (torchrun --nproc_per_node {n_devices})")
    return Mesh(group, rank, world, _rank_device(device, rank, world))


def shard_batch(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global host batch (numpy array or tensor), on
    its device."""
    x = torch.from_numpy(batch) if isinstance(batch, np.ndarray) else batch
    return x[mesh.rows(x.shape[0])].to(mesh.device)
