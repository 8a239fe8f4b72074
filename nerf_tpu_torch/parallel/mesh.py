"""The ranks of a process group as a 1-D data mesh, and the collectives the
data-parallel paths use (port of ``nerf_tpu/parallel/mesh.py``).

The JAX package shards ray batches over a device mesh's ``data`` axis and
replicates the parameters; its ``shard_map`` bodies reduce with
``lax.pmean``. Here each device is a rank (``parallel/distributed.py``), a
:class:`Mesh` names this rank's place in the group, and:

  - :func:`shard_rows` is a rank's contiguous slice of a host-replicated
    array: the rows ``shard_batch`` / ``process_local_rows`` give its device;
  - :func:`replicate_params` broadcasts rank 0's weights, so every rank
    starts from the same ones;
  - :func:`all_reduce_mean` is ``lax.pmean``: every tensor into one flat
    bucket, one ``all_reduce(SUM)``, then ``/ world``;
  - :func:`gather_rows` assembles equal-size per-rank slices on rank 0, where
    the JAX out-spec sharding reassembles a global array.

A gloo group runs its collectives on CPU copies (gloo's own staging for
device tensors, made explicit); an NCCL group on the rank's card. The
``all_reduce_mean`` calls are timed by the host clock around the
synchronized collective (``Mesh.allreduce_seconds``, ``allreduce_calls``,
``bucket_bytes``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .distributed import _local_world_size, check_backend, rank_device

DATA_AXIS = "data"


@dataclasses.dataclass
class Mesh:
    """This rank's place in a 1-D data mesh: ``world_size`` ranks, this one
    ``rank``, its ``device`` and the process ``group`` (None for one rank
    without a group, where every collective is the identity)."""

    world_size: int
    rank: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None
    allreduce_seconds: float = 0.0     # host seconds in all_reduce_mean
    allreduce_calls: int = 0
    bucket_bytes: int = 0              # the last flat bucket's bytes

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Every rank waits here (after rank 0's file writes)."""
        if self.group is None:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _comm_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    # The collectives as methods, for the engine's factories, which take an
    # optional mesh without importing this package.
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return all_reduce_mean(self, tensors)

    def gather_rows(self, tensor: torch.Tensor) -> Optional[torch.Tensor]:
        return gather_rows(self, tensor)


def make_mesh(num_devices: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh of the live process group (``num_devices``, when given, must
    equal its size), on ``rank_device(device)``; with no group, a one-rank
    mesh on ``device``. NCCL is refused for ranks on the CPU or ranks that
    share a card (``distributed.check_backend``), before any collective."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"{num_devices} devices need a process group: spawn the ranks "
                             "(parallel.distributed.run_ranks) or start under torchrun")
        return Mesh(1, 0, torch.device(device))
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"--num-devices {num_devices} != the process group's {world} ranks "
                         "(under torchrun, pass --num-devices WORLD_SIZE)")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"--dist-backend {backend} but the process group runs {actual}")
    dev = rank_device(device)
    check_backend(actual, dev, _local_world_size())
    return Mesh(world, dist.get_rank(), dev, dist.group.WORLD, actual)


def pad_to_devices(n: int, num_devices: int, multiple: int = 1) -> int:
    """Smallest size >= n divisible by num_devices * multiple."""
    quantum = num_devices * multiple
    return (n + quantum - 1) // quantum * quantum


def shard_rows(mesh: Mesh, *arrays, axis: int = 0):
    """This rank's contiguous slice along ``axis`` of each host-replicated
    array (numpy or torch): rank r of W takes rows [r n / W, (r + 1) n / W),
    the rows the JAX ``shard_batch`` places on device r. ``n`` must divide
    by W (``pad_to_devices``)."""
    out = []
    for a in arrays:
        n = a.shape[axis]
        if n % mesh.world_size:
            raise ValueError(f"{n} rows on axis {axis} do not divide over {mesh.world_size} "
                             "ranks (pad with pad_to_devices)")
        local = n // mesh.world_size
        index = (slice(None),) * axis + (slice(mesh.rank * local, (mesh.rank + 1) * local),)
        out.append(a[index])
    return tuple(out) if len(out) > 1 else out[0]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"one bucket holds one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.pmean`` over the mesh, in place: the tensors (one dtype) go into
    one flat bucket, one ``all_reduce(SUM)``, ``/ world_size``, and back.
    Every rank ends with the same bytes. Returns the tensors."""
    tensors = list(tensors)
    if mesh.group is None:
        return tensors
    flat = _flat(tensors)
    mesh.bucket_bytes = flat.numel() * flat.element_size()
    mesh._sync()
    t0 = time.perf_counter()
    bucket = flat.to(mesh._comm_device())
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=mesh.group)
    bucket.div_(mesh.world_size)
    flat = bucket.to(flat.device)
    mesh._sync()
    mesh.allreduce_seconds += time.perf_counter() - t0
    mesh.allreduce_calls += 1
    _unflat(flat, tensors)
    return tensors


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite the tensors (one dtype) with rank ``src``'s, in one bucket."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return
    flat = _flat(tensors).to(mesh._comm_device())
    dist.broadcast(flat, src=src, group=mesh.group)
    _unflat(flat.to(tensors[0].device), tensors)


def replicate_params(mesh: Mesh, *modules) -> None:
    """Rank 0's parameters and buffers to every rank, one bucket per dtype,
    so all ranks start from the same weights (``None`` modules skipped)."""
    tensors = [t for m in modules if m is not None
               for t in list(m.parameters()) + list(m.buffers())]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        broadcast_(mesh, [t.data for t in tensors if t.dtype == dtype])


def gather_rows(mesh: Mesh, tensor: torch.Tensor) -> Optional[torch.Tensor]:
    """Every rank's equal-shape ``tensor``, concatenated on axis 0 in rank
    order, on rank 0 (on this rank's device); None on the other ranks."""
    if mesh.group is None:
        return tensor
    src = tensor.contiguous().to(mesh._comm_device())
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)] if mesh.rank == 0 else None
    dist.gather(src, gather_list=parts, dst=0, group=mesh.group)
    if mesh.rank != 0:
        return None
    return torch.cat(parts).to(tensor.device)
