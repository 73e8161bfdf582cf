"""Multi-process rendering: each process renders its own bands.

The counterpart of ``simple_raytracer_tpu.parallel.distributed``.  Each
process drives its own card (``process_device``), ``torch.distributed``
links the processes, and the renderer under ``all_devices`` gives every
process's bands their place in one image of ``sum(local bands)`` bands.
Rendering is communication-free; the only collective is one gather of a
host array each time an image or a checkpoint is fetched
(``fetch_canvas``), so the process group uses the gloo backend: it runs
the same code on the CPU and admits several processes on one card, which
NCCL refuses.

A launch, one command per process:

    srt-render-torch --config 2 --all-devices --distributed \\
        --coordinator host0:29500 --num-processes 4 --process-id $i ...

or under ``torchrun``, which sets ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  Only process 0 writes files;
every process runs the gathers.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group over TCP (``host:port`` of process 0);
    idempotent.  Arguments left out come from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Call it
    before the first device is used."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, v in (("coordinator", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"distributed.initialize: no {', '.join(missing)} "
                         "given, nor torchrun's MASTER_ADDR, WORLD_SIZE, "
                         "RANK")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0.."
                         f"{num_processes - 1}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Wait for every process, then leave the process group (process 0
    serves the group's store, so it must not exit first)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def should_write_output() -> bool:
    """Only process 0 writes files in a multi-process render."""
    return process_index() == 0


def process_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % device_count}``, with the
    process index for ``LOCAL_RANK`` where it is not set (so processes on
    one machine with one card share it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass the band devices "
                           "(e.g. ['cpu']) to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def all_counts(n: int) -> List[int]:
    """Every process's ``n``, in process order (a collective)."""
    if not is_multiprocess():
        return [n]
    mine = torch.tensor([n], dtype=torch.int64)
    counts = [torch.zeros_like(mine) for _ in range(process_count())]
    dist.all_gather(counts, mine)
    return [int(c) for c in counts]


def fetch_canvas(rows) -> np.ndarray:
    """This process's rows of an image (a tensor on any device, or an
    array) as the whole row-major image in numpy, on every process: a
    host copy in one process; across processes every process's rows,
    gathered in process order.  It is a collective there, so every
    process must call it."""
    local = (rows.detach().cpu() if torch.is_tensor(rows)
             else torch.from_numpy(np.ascontiguousarray(rows)))
    if not is_multiprocess():
        return local.numpy()
    counts = all_counts(local.shape[0])
    # all_gather takes equal shapes: pad every process's rows to the most
    padded = local.new_zeros((max(counts),) + tuple(local.shape[1:]))
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(parts, padded)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).numpy()
