"""Multi-process start-up: the launcher side of a ``torch.distributed``
run, one worker a process.

Counterpart of ``dgc_tpu/parallel/multihost.py``. :func:`resolve_launch`
reads the coordinator's address, the process count and this process's
rank from the environment, in this order:

* ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
  the triple the repository's launch scripts export;
* ``torchrun``'s ``MASTER_ADDR`` + ``MASTER_PORT`` / ``WORLD_SIZE`` /
  ``RANK``;
* Slurm's ``SLURM_NTASKS`` / ``SLURM_PROCID`` (the count and the rank
  only: the address comes from one of the above).

Where only the triple and Slurm are set it resolves what the JAX package
resolves. A partial set raises with the names that are missing: half
configured, a run would either wait for processes that never dial in or
come up alone and train on a fraction of the data.
:func:`initialize_multihost` then starts the default process group (NCCL
on the card, gloo when the CPU was asked for), retrying a failed start
with exponential backoff: the processes of a job start skewed.
"""

import os
import time
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dgc_tpu_torch.resilience import faults as _faults

__all__ = ["resolve_launch", "initialize_multihost", "is_coordinator",
           "local_batch_slice"]


def _int(env: Mapping[str, str], *names) -> Optional[int]:
    for n in names:
        if n in env:
            return int(env[n])
    return None


def resolve_launch() -> Optional[Tuple[str, int, int]]:
    """``(address "host:port", process count, rank)``, or None for a
    single-process run; raises on a partial configuration."""
    env = os.environ
    address = env.get("JAX_COORDINATOR_ADDRESS")
    if address is None and ("MASTER_ADDR" in env or "MASTER_PORT" in env):
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            missing = [n for n in ("MASTER_ADDR", "MASTER_PORT")
                       if n not in env]
            raise RuntimeError(f"partial multi-process configuration: "
                               f"{missing} missing beside torchrun's other "
                               "variables")
    num_processes = _int(env, "JAX_NUM_PROCESSES", "WORLD_SIZE",
                         "SLURM_NTASKS")
    process_id = _int(env, "JAX_PROCESS_ID", "RANK", "SLURM_PROCID")
    resolved = {
        "the coordinator address (JAX_COORDINATOR_ADDRESS, or MASTER_ADDR "
        "and MASTER_PORT)": address,
        "the process count (JAX_NUM_PROCESSES, WORLD_SIZE or "
        "SLURM_NTASKS)": num_processes,
        "the rank (JAX_PROCESS_ID, RANK or SLURM_PROCID)": process_id}
    missing = [k for k, v in resolved.items() if v is None]
    if missing and len(missing) < len(resolved):
        raise RuntimeError(
            "partial multi-process configuration: "
            f"{[k for k in resolved if k not in missing]} resolved but "
            f"{missing} missing: export the whole set, or none of it for "
            "a single-process run")
    if missing:
        return None
    return address, num_processes, process_id


def _local_rank(rank: int) -> int:
    """The card of this process: torchrun's ``LOCAL_RANK``, Slurm's
    ``SLURM_LOCALID``, else the rank modulo the host's card count."""
    local = _int(os.environ, "LOCAL_RANK", "SLURM_LOCALID")
    return rank % torch.cuda.device_count() if local is None else local


def initialize_multihost(device="cuda", init_retries: int = 3,
                         init_backoff: float = 1.0) -> bool:
    """Start the default process group when the launch is multi-process
    (:func:`resolve_launch`); on a CUDA ``device`` first select this
    process's card. Returns True when a group was started, False for a
    single-process run. ``init_retries`` bounds the attempts, the first
    retry after ``init_backoff`` seconds, doubling; the last attempt's
    error propagates."""
    launch = resolve_launch()
    if launch is None:
        return False
    address, world, rank = launch
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank(rank))
    attempts = max(1, int(init_retries))
    for attempt in range(attempts):
        try:
            if _faults.should_fail_init(attempt):
                raise RuntimeError(f"injected init failure (attempt "
                                   f"{attempt + 1}, {_faults.ENV})")
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{address}", world_size=world, rank=rank)
            break
        except RuntimeError as e:
            if attempt + 1 >= attempts:
                raise
            delay = init_backoff * (2 ** attempt)
            print(f"[multihost] initialize attempt {attempt + 1} failed "
                  f"({type(e).__name__}: {e}); retrying in {delay:.1f}s")
            time.sleep(delay)
    return True


def is_coordinator() -> bool:
    """Rank 0 of the process group (every process without one): the one
    that logs and keeps the checkpoint directory."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int, num_processes: int = None,
                      process_id: int = None) -> slice:
    """The slice of a ``[global_batch, ...]`` host array this process
    feeds (the process count and rank default to the group's). Raises on
    a batch that does not split evenly: flooring it would shrink the
    global batch with no error anywhere downstream."""
    on = dist.is_initialized()
    n = (dist.get_world_size() if on else 1) if num_processes is None \
        else int(num_processes)
    i = (dist.get_rank() if on else 0) if process_id is None \
        else int(process_id)
    per, rem = divmod(int(global_batch), n)
    if rem:
        raise ValueError(
            f"global batch {global_batch} does not split evenly over {n} "
            f"processes (remainder {rem}): each would feed {per} samples "
            f"and the global batch would shrink to {per * n}; use one "
            f"divisible by {n}")
    return slice(i * per, (i + 1) * per)
