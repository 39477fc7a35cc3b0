"""In-container runtime bootstrap: the consumer side of the operator's env
contracts, on torch.distributed.

The port of tf_operator_tpu/runtime/bootstrap.py.  `SliceInfo`,
`slice_info_from_env` and `global_rendezvous` are host-side and copied as
they are (the TPUJob contract: COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID / TPU_* / MEGASCALE_*).  `initialize` joins the job's process
group with `torch.distributed.init_process_group` where the JAX package
calls jax.distributed.initialize.  It reads either contract:

  - the PyTorchJob's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    (tf_operator_tpu/controllers/pytorch.py), and LOCAL_RANK where a
    launcher sets it;
  - the TPUJob's, through `global_rendezvous` (one coordinator for every
    slice, global ranks slice-major).

`default_mesh` and `multislice_mesh` lay the job's ranks out as the
JAX package's do (parallel/mesh).  A job of one process initializes
nothing.  A job of several with a variable missing raises, naming it;
the group it joins is destroyed at the process's exit.  The backend is
NCCL on the card and gloo on the CPU unless the caller names one; a
rank's card is cuda:LOCAL_RANK (cuda:0 without it).  Nothing falls back
on its own.
"""
from __future__ import annotations

import argparse
import atexit
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.device import resolve_device


@dataclass
class SliceInfo:
    """Parsed topology env for this host."""

    coordinator_address: Optional[str] = None
    megascale_coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    worker_id: int = 0
    worker_hostnames: tuple = ()
    accelerator_type: str = ""
    slice_id: int = 0
    num_slices: int = 1
    hosts_per_slice: int = 1
    total_hosts: int = 1
    topology: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1 or self.num_slices > 1


def slice_info_from_env(env: Optional[Dict[str, str]] = None) -> SliceInfo:
    e = env if env is not None else os.environ
    hostnames = tuple(h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h)
    return SliceInfo(
        coordinator_address=e.get("COORDINATOR_ADDRESS") or None,
        megascale_coordinator_address=e.get("MEGASCALE_COORDINATOR_ADDRESS") or None,
        num_processes=int(e.get("NUM_PROCESSES", "1")),
        process_id=int(e.get("PROCESS_ID", "0")),
        worker_id=int(e.get("TPU_WORKER_ID", "0")),
        worker_hostnames=hostnames,
        accelerator_type=e.get("TPU_ACCELERATOR_TYPE", ""),
        slice_id=int(e.get("TPU_SLICE_ID", "0")),
        num_slices=int(e.get("TPU_NUM_SLICES", e.get("MEGASCALE_NUM_SLICES", "1"))),
        hosts_per_slice=int(e.get("TPU_HOSTS_PER_SLICE", "1")),
        total_hosts=int(e.get("TPU_TOTAL_HOSTS", "1")),
        topology=e.get("TPU_TOPOLOGY", ""),
    )


def global_rendezvous(info: SliceInfo):
    """(coordinator, num_processes, process_id) of the whole job.

    Multislice: one coordinator (slice 0, host 0 = the MEGASCALE
    address), global process count/id, slice-major."""
    if info.num_slices > 1:
        return (
            info.megascale_coordinator_address,
            info.total_hosts,
            info.slice_id * info.hosts_per_slice + info.process_id,
        )
    return info.coordinator_address, info.num_processes, info.process_id


BACKENDS = ("nccl", "gloo")


def add_backend_flag(ap: argparse.ArgumentParser) -> None:
    """A training CLI's --backend: `initialize`'s override."""
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="process group backend of a job of several "
                         "processes (default nccl on the card, gloo on "
                         "the CPU)")


@dataclass
class Job:
    """This process's place in the job: its rank of `world`, its device,
    the backend of its process group (None for a job of one process) and
    the TPUJob topology env as parsed."""

    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    slice: SliceInfo = field(default_factory=SliceInfo)


def _need(e, name: str) -> str:
    value = e.get(name)
    if not value:
        raise ValueError(f"a job of several processes needs {name} in its "
                         f"environment; it is not set")
    return value


def rendezvous(env: Optional[Dict[str, str]] = None):
    """(init_method, world, rank) from the env: the PyTorchJob contract
    when WORLD_SIZE is set, else the TPUJob one; init_method is None for
    a job of one process."""
    e = env if env is not None else os.environ
    if "WORLD_SIZE" in e:
        world = int(e["WORLD_SIZE"])
        if world <= 1:
            return None, 1, 0
        addr, port = _need(e, "MASTER_ADDR"), _need(e, "MASTER_PORT")
        return f"tcp://{addr}:{port}", world, int(_need(e, "RANK"))
    info = slice_info_from_env(e)
    if not info.is_distributed:
        return None, 1, 0
    coordinator, world, rank = global_rendezvous(info)
    if not coordinator:
        _need(e, "MEGASCALE_COORDINATOR_ADDRESS" if info.num_slices > 1
              else "COORDINATOR_ADDRESS")
    return f"tcp://{coordinator}", world, rank


def initialize(env: Optional[Dict[str, str]] = None,
               device: Union[str, torch.device, None] = None,
               backend: Optional[str] = None) -> Job:
    """Join the job's process group from the injected env (idempotent: a
    group already initialized is used as it is).  `device` is the
    entry point's (default "cuda"; a bare "cuda" becomes
    cuda:LOCAL_RANK); `backend` defaults to "nccl" on the card and
    "gloo" on the CPU.  A job of one process initializes nothing."""
    e = env if env is not None else os.environ
    info = slice_info_from_env(e)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(e.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return Job(dist.get_rank(), dist.get_world_size(), dev,
                   dist.get_backend(), info)
    init_method, world, rank = rendezvous(e)
    if world == 1:
        return Job(0, 1, dev, None, info)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    # a process group left up at exit aborts the process (gloo's threads
    # are torn down unjoined) once its peer's store is gone
    atexit.register(_shutdown)
    return Job(rank, world, dev, backend, info)


def default_mesh(axes: Optional[Dict[str, int]] = None,
                 world: Optional[int] = None):
    """The mesh over every rank of the job (parallel/mesh.make_mesh; call
    after initialize).  Without `axes`, everything lands on the dp
    axis."""
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes if axes is not None else {"dp": -1}, world=world)


def multislice_mesh(info: SliceInfo,
                    ici_axes: Optional[Dict[str, int]] = None,
                    world: Optional[int] = None):
    """The dcn x ici mesh of a (possibly) multislice job: one dcn row per
    slice, `ici_axes` (tp/fsdp/dp/ep/pp) laid out inside each slice.
    global_rendezvous numbers the ranks slice-major, so make_mesh's
    dcn-outermost grid puts each slice's ranks in one dcn row, and only
    what the caller maps to dcn (the batch and its gradients, by
    DEFAULT_RULES) crosses slices.  A single-slice job gets dcn=1, which
    is default_mesh."""
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    axes = dict(ici_axes if ici_axes is not None else {"dp": -1})
    if "dcn" in axes and axes["dcn"] not in (1, info.num_slices):
        raise ValueError(
            f"dcn axis {axes['dcn']} conflicts with numSlices "
            f"{info.num_slices}")
    axes["dcn"] = info.num_slices
    return make_mesh(axes, world=world)


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
