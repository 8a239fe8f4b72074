"""Process groups: joining ``torchrun``'s, spawning local ranks, and which
rank writes files (port of ``nerf_tpu/parallel/distributed.py``).

The JAX package runs one program per host over a mesh of its devices and
joins hosts with ``jax.distributed``. PyTorch's idiom is one process per
device, so here every device is a rank of a ``torch.distributed`` process
group:

  - under ``torchrun`` the environment names the group (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``), and
    :func:`maybe_initialize_distributed` joins it, as the JAX function
    joins the cluster that ``JAX_COORDINATOR_ADDRESS`` names;
  - otherwise a CLI asked for N > 1 devices spawns N local ranks with
    :func:`run_ranks` (``torch.multiprocessing``'s spawn start method, which
    CUDA needs; a ``file://`` rendezvous, so there is no port to collide),
    and each rank runs the same function.

Rank ``r`` runs on ``cuda:{local_rank % device_count}`` (``rank_device``).
The backend follows the device: NCCL when each rank has a card of its own,
gloo on the CPU, and gloo when ranks share a card, which the caller must
ask for; NCCL for ranks that share a card is refused before it can hang
(``check_backend``). Only rank 0 writes files (:func:`is_primary`).
"""

from __future__ import annotations

import atexit
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing

def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def _local_world_size() -> int:
    default = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", default))


def rank_device(device, local_rank: Optional[int] = None) -> torch.device:
    """The device of a rank: ``cuda`` without an index is the card
    ``local_rank % device_count``; any other device is taken as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
    rank = _local_rank() if local_rank is None else local_rank
    return torch.device("cuda", rank % count)


def default_backend(device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_world_size: int) -> None:
    """Refuse what NCCL cannot do, before it hangs or errors: ranks on the
    CPU, and more local ranks than cards (ranks that share a card)."""
    if backend != "nccl":
        return
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device a rank, not {device.type!r}: "
                         "pass --dist-backend gloo for ranks on the CPU")
    count = torch.cuda.device_count()
    if local_world_size > count:
        raise ValueError(
            f"the NCCL backend needs a card a rank: {local_world_size} ranks on this host share "
            f"{count} card(s); ranks that share a card take --dist-backend gloo")


def _timeout(timeout_s: Optional[float]) -> Optional[datetime.timedelta]:
    """A group's collective timeout: ``timeout_s`` seconds, or torch's
    default for the backend when None. Rank 0 alone renders validation
    frames and writes checkpoints while the others wait in a collective,
    so a CLI's group keeps the default unless its ``--dist-timeout`` asks
    for less (tests do, to fail fast)."""
    return None if timeout_s is None else datetime.timedelta(seconds=timeout_s)


def maybe_initialize_distributed(backend: Optional[str] = None, device="cuda",
                                 timeout_s: Optional[float] = None) -> bool:
    """Join the process group ``torchrun``'s environment names (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``), on ``rank_device(device)``, with
    ``timeout_s`` as its collectives' limit (None: torch's default).

    Returns True when a group is (or already was) live; without that
    environment it does nothing and returns False. A group joined here is
    destroyed at exit: a gloo group left to the interpreter's teardown can
    abort the process.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    dev = rank_device(device)
    backend = backend or default_backend(dev)
    check_backend(backend, dev, _local_world_size())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]), timeout=_timeout(timeout_s))
    atexit.register(_destroy_group)
    return True


def _destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the rank that owns file writes (checkpoints, metrics, PLY,
    PNG): rank 0, or the one process when there is no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank: int, world_size: int, fn: Callable, args: tuple, kwargs: dict,
               backend: str, device: str, init_file: str, timeout_s: Optional[float],
               num_threads: int,
               results) -> None:
    """One spawned rank: join the group, run ``fn``, report its result (or
    its traceback) to the launcher."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    torch.set_num_threads(num_threads)
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size, timeout=_timeout(timeout_s))
        try:
            out = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the launcher, then the rank fails
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
              device="cpu", init_file: Optional[str] = None, timeout_s: Optional[float] = None,
              deadline_s: Optional[float] = None, **kwargs) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``world_size`` spawned local ranks of
    one process group; return each rank's result, in rank order.

    Each rank joins through the ``file://`` rendezvous ``init_file`` (a new
    file in a temporary directory by default) with ``backend`` (NCCL for
    cards, gloo on the CPU by default), on ``rank_device(device, rank)``,
    with ``timeout_s`` as its collectives' limit (None: torch's default for
    the backend), and ``torch`` threads
    split evenly from the launcher's. A rank that raises fails the run: the
    others are killed and the rank's traceback is raised here as a
    ``RuntimeError``, as it is when ``deadline_s`` passes first. Results
    travel pickled after the rank's group is gone: return numpy arrays and
    Python values, not tensors (a tensor's shared memory dies with its rank).
    """
    backend = backend or default_backend(device)
    check_backend(backend, device, world_size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // world_size)
    with tempfile.TemporaryDirectory(prefix="nerf_ranks_") as tmp:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, fn, args, kwargs, backend, str(device),
                                   init_file, timeout_s, threads, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, deadline_s)
        except KeyboardInterrupt:
            # Ctrl-C reaches every rank of the terminal's process group: give
            # them a moment to stop (a server's rank 0 sends its stop).
            for p in procs:
                p.join(timeout=5)
            raise
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)


def _collect(procs, results, deadline_s: Optional[float]) -> List[Any]:
    """Drain the ranks' results (before joining them) until every rank has
    reported, one failed, one died silently or the deadline passed."""
    end = None if deadline_s is None else time.monotonic() + deadline_s
    outs: dict = {}
    while len(outs) < len(procs):
        try:
            rank, ok, value = results.get(timeout=0.2)
        except queue_mod.Empty:
            dead = [r for r, p in enumerate(procs) if r not in outs and not p.is_alive()
                    and p.exitcode is not None]
            # A rank that exited reports first; give its queue a moment to land.
            if dead and results.empty():
                time.sleep(0.5)
                if results.empty():
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and reported nothing")
            if end is not None and time.monotonic() > end:
                raise RuntimeError(f"ranks {sorted(set(range(len(procs))) - set(outs))} "
                                   f"missed the {deadline_s:.0f} s deadline")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        outs[rank] = value
    for p in procs:
        p.join(timeout=30)
    return [outs[r] for r in range(len(procs))]


def spawn_or_join(num_devices: int, backend: Optional[str], device,
                  timeout_s: Optional[float] = None) -> bool:
    """A CLI's start: True when it must spawn its ``num_devices`` ranks with
    :func:`run_ranks` (N > 1 and no group to join); False when this process
    runs the body (one device, a live group, or ``torchrun``'s, which it
    joins here)."""
    if maybe_initialize_distributed(backend, device, timeout_s):
        return False
    return num_devices > 1


def add_mesh_args(parser, num_devices_help: str) -> None:
    """A CLI's three multi-device flags: ``--num-devices``, ``--dist-backend``
    and ``--dist-timeout``."""
    parser.add_argument("--num-devices", type=int, default=1,
                        help=num_devices_help + " One rank a device: under torchrun its "
                             "WORLD_SIZE, else spawned here.")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                        help="Process-group backend: nccl for a card a rank (the default on "
                             "cuda), gloo on the CPU or for ranks that share a card.")
    parser.add_argument("--dist-timeout", type=float, default=None, metavar="SECONDS",
                        help="The process group's collective timeout (default: torch's for "
                             "the backend).")


def run_cli(body: Callable, args) -> Any:
    """Run a CLI's ``body(args)`` on its ranks (the flags of
    :func:`add_mesh_args`): spawned here, or in this process (one device, or
    ``torchrun``'s group); returns rank 0's result."""
    if spawn_or_join(args.num_devices, args.dist_backend, args.device, args.dist_timeout):
        return run_ranks(body, args.num_devices, args, backend=args.dist_backend,
                         device=args.device, timeout_s=args.dist_timeout)[0]
    return body(args)
