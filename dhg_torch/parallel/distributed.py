"""Process-group start-up (port of dhg/parallel/distributed.py).

dhg calls jax.distributed.initialize so that every process sees the global
device set; here every process drives one device and joins one
torch.distributed process group. Configuration, either source (the config
wins):

  * config: training_args.distributed:
        coordinator_address: "10.0.0.1:1234"   # process 0's host:port
        num_processes: 2
        process_id: 0                          # per process
        backend: gloo                          # optional; nccl on CUDA, gloo on the CPU
    or `training_args.distributed: auto`, which reads torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): the port's counterpart of
    the TPU metadata detection behind dhg's "auto";
  * environment: DHG_COORDINATOR, DHG_NUM_PROCESSES, DHG_PROCESS_ID.

A CUDA process drives cuda:<LOCAL_RANK> (torchrun's variable; else its
process id modulo the visible devices). Two processes that share one card
need the gloo backend: NCCL refuses two ranks on one device, and nothing
here switches backend by itself. A group that fails to form raises.
Call it before the Trainer builds anything (dhg_torch.train.main does).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def _from_env(dist_cfg):
    if dist_cfg is None and os.environ.get("DHG_COORDINATOR"):
        return {
            "coordinator_address": os.environ["DHG_COORDINATOR"],
            "num_processes": int(os.environ["DHG_NUM_PROCESSES"]),
            "process_id": int(os.environ["DHG_PROCESS_ID"]),
        }
    return dist_cfg


def initialize_from_config(cfg, device="cuda") -> bool:
    """Join the process group `cfg` (or the environment) describes; returns
    True if this run is multi-process. `device` is the run's device type:
    "cuda" picks NCCL and this process's card, "cpu" gloo."""
    dist_cfg = _from_env(cfg.training_args.distributed if cfg is not None else None)
    if dist_cfg is None:
        return False
    dev = torch.device(device)
    if dist_cfg == "auto":
        dist_cfg = {
            "coordinator_address": f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            "num_processes": int(os.environ["WORLD_SIZE"]),
            "process_id": int(os.environ["RANK"]),
        }
    if not isinstance(dist_cfg, dict):
        raise ValueError(
            "training_args.distributed must be 'auto' or a mapping with "
            f"coordinator_address/num_processes/process_id, got {dist_cfg!r}"
        )
    rank, world = int(dist_cfg["process_id"]), int(dist_cfg["num_processes"])
    backend = dist_cfg.get("backend") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dhg_torch: CUDA is not available; pass device='cpu' to run "
                               "the plain PyTorch path explicitly")
        torch.cuda.set_device(local_device_index(rank))
    dist.init_process_group(backend, init_method=f"tcp://{dist_cfg['coordinator_address']}",
                            world_size=world, rank=rank)
    log.info("torch.distributed initialized: process %d/%d, backend %s", rank, world, backend)
    return True


def local_device_index(rank: int | None = None) -> int:
    """The card this process drives: LOCAL_RANK, else its rank modulo the
    visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def run_device(device="cuda") -> torch.device:
    """`device` with this process's card index on CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_multiprocess():
        return torch.device("cuda", local_device_index())
    return dev


def is_main() -> bool:
    """True on the process that owns run-dir artifacts (always True with
    one process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    """Whether this process is in a process group (of any size)."""
    return dist.is_initialized()
