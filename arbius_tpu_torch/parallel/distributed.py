"""Multi-host initialisation for the port: a thin wrapper over
`torch.distributed`.

Twin of arbius_tpu/parallel/distributed.py. A mesh's lanes live in one
process (parallel/mesh.py), so a single host needs nothing here; several
hosts would join one process group, each host's lanes a slice of the
global mesh. Arguments default from the environment (ARBIUS_COORDINATOR
as ``host:port``, ARBIUS_NUM_PROCESSES, ARBIUS_PROCESS_ID); with no
coordinator and at most one process it is a no-op that returns False.
Nothing on the solve path uses a process group yet.
"""
from __future__ import annotations

import os

_initialized = False


def distributed_env(coordinator_address: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None
                    ) -> tuple[str | None, int | None, int | None]:
    """The (coordinator, process count, process id) to use: the
    arguments, else the environment's."""
    coordinator_address = coordinator_address or os.environ.get(
        "ARBIUS_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("ARBIUS_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("ARBIUS_PROCESS_ID")
        process_id = int(env) if env else None
    return coordinator_address, num_processes, process_id


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Idempotent `torch.distributed.init_process_group` over TCP (NCCL
    with CUDA, else gloo); a no-op in a single process. Returns True
    once a multi-process group is up."""
    global _initialized
    if _initialized:
        return True
    addr, n, rank = distributed_env(coordinator_address, num_processes,
                                    process_id)
    if addr is None and n in (None, 1):
        return False   # one process: the mesh's lanes are all local
    if addr is None or n is None or rank is None:
        raise ValueError(
            "multi-process init needs the coordinator address, the "
            f"process count and this process's id (got {addr!r}, {n!r}, "
            f"{rank!r})")
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{addr}", world_size=n, rank=rank)
    _initialized = True
    return True
