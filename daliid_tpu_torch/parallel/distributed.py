"""Multi-process initialization over ``torch.distributed``.

Port of ``daliid_tpu/parallel/distributed.py`` (``:20-67``). Every rank runs
the same command; :func:`initialize_multihost` joins them into one process
group and the rest of the package reads :mod:`daliid_tpu_torch.parallel.mesh`
to split work by rank.

Bootstrap: rank 0 serves a ``TCPStore`` at ``--coordinator_address``
(``host:port``; ``tcp://`` optional). Each rank posts its host name and its
host's CUDA device count there, so every rank sees the whole layout:

- a rank's device is ``cuda:<its index among the ranks of its host> %
  <device count>`` (or the CPU for ``device='cpu'``);
- the backend is ``nccl`` when every host has a card for each of its ranks,
  and ``gloo`` otherwise (NCCL refuses two ranks on one GPU) or on the CPU.

The backend is a transport choice, not a fallback: a gloo gang on a card
still computes on the card, and only its collectives travel through host
memory. Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``; the
other collectives (:func:`~daliid_tpu_torch.parallel.mesh.gather_rows`)
stage them through the host explicitly.
"""

from __future__ import annotations

import datetime
import socket
from collections import Counter

import torch
import torch.distributed as dist

from daliid_tpu_torch.device import resolve_device

# how long a rank waits for the others at the bootstrap and in a collective
TIMEOUT = datetime.timedelta(seconds=600)


def _host_port(address: str) -> tuple[str, int]:
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {address!r}")
    return host, int(port)


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         device: str | torch.device = "cuda") -> dict:
    """Join the gang and return its layout: ``process_index``,
    ``process_count``, ``local_devices`` (1: a rank drives one device),
    ``global_devices``, ``backend`` and this rank's ``device``. A CUDA
    ``device`` needs a GPU: no rank drops to the CPU."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    dev_type = resolve_device(device).type
    host, port = _host_port(coordinator_address)
    store = dist.TCPStore(host, port, world, is_master=rank == 0, timeout=TIMEOUT)
    n_dev = torch.cuda.device_count() if dev_type == "cuda" else 0
    store.set(f"daliid/host/{rank}", f"{socket.gethostname()}\t{n_dev}")
    layout = [store.get(f"daliid/host/{r}").decode().split("\t") for r in range(world)]
    hosts = [name for name, _ in layout]
    ranks_on = Counter(hosts)
    local_index = hosts[:rank].count(hosts[rank])
    if dev_type == "cuda":
        dev = torch.device("cuda", local_index % n_dev)
        torch.cuda.set_device(dev)
        fits = all(ranks_on[name] <= int(count) for name, count in layout)
        backend = "nccl" if fits else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world, "backend": backend, "device": str(dev)}


def add_multihost_flags(parser) -> None:
    """The shared multi-process flags (run the same command on every rank)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed gang before any device use")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0's store")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def maybe_initialize_from_args(args) -> dict | None:
    """Join the gang from parsed CLI flags (a no-op unless ``--multihost``)
    and point ``args.device`` at this rank's device."""
    if not getattr(args, "multihost", False):
        return None
    for flag in ("coordinator_address", "num_processes", "process_id"):
        if getattr(args, flag) is None:
            raise SystemExit(f"--multihost needs --{flag}")
    info = initialize_multihost(args.coordinator_address, args.num_processes,
                                args.process_id, device=getattr(args, "device", "cuda"))
    print(f"multihost: {info}", flush=True)
    args.device = info["device"]
    return info


def shutdown_multihost() -> None:
    """Leave the gang, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
