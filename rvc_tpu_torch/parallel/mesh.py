"""Data parallelism over the cards of one machine (port of
``rvc_tpu/parallel/mesh.py``).

JAX runs one process over a ``dp`` mesh: parameters replicated, the batch
sharded, and the compiler inserts the gradient ``psum``. The port runs one
process per card with ``torch.distributed`` (NCCL between cards, gloo on the
CPU): ``launch`` spawns the ranks, each rank holds a replica of the models
and its rows of the global batch, and the train step sums its gradients
over the ranks with ``all_reduce_sum``. Outside ``launch`` (no process
group) every function here is the one-process identity: rank 0 of 1.
"""

from __future__ import annotations

import multiprocessing
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# How often ``launch`` looks at its ranks' exit codes, in seconds.
_POLL_S = 0.2


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def barrier() -> None:
    if _initialized():
        dist.barrier()


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise sum of each tensor over the ranks, through one
    all-reduce of a flattened bucket (returns new tensors; the inputs
    themselves without a process group). The tensors share one dtype."""
    tensors = list(tensors)
    if not _initialized() or not tensors:
        return tensors
    assert len({t.dtype for t in tensors}) == 1, "all_reduce_sum: mixed dtypes"
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM)
    parts = torch.split(bucket, [t.numel() for t in tensors])
    return [part.view(t.shape) for part, t in zip(parts, tensors)]


def shard_rows(batch: Dict[str, Any], rank_index: int, world: int) -> Dict[str, Any]:
    """Rank ``rank_index``'s rows of a batch dict: each array's leading axis
    cut into ``world`` equal parts (the axis must divide evenly)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"shard_rows: {k} has {n} rows, not a multiple of {world}")
        b = n // world
        out[k] = v[rank_index * b:(rank_index + 1) * b]
    return out


def make_world_for_batch(batch_size: int, devices: Sequence[Any]) -> List[Any]:
    """The largest prefix of ``devices`` whose count divides the global
    batch (``make_mesh_for_batch`` on one machine): every rank takes the
    same number of rows."""
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return list(devices[:n])


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank_index: int, devices: Sequence[str],
               backend: str, port: int, args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=len(devices), rank=rank_index)
    try:
        device = torch.device(devices[rank_index])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        fn(rank_index, str(device), *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence[str], backend: Optional[str] = None,
           args: tuple = ()) -> int:
    """Run ``fn(rank, device, *args)`` in one spawned process per entry of
    ``devices`` (``"cuda:0"``, ``"cpu"``, ...), each rank in a process
    group over localhost (``backend``: NCCL for cards, gloo for the CPU, by
    default). ``fn`` and ``args`` must pickle. Returns 0 when every rank
    ends well; when a rank fails, the launcher stops the other ranks and
    returns that rank's exit code (1 for an exception)."""
    devices = [str(d) for d in devices]
    if backend is None:
        backend = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, devices, backend, port, args))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    code = 0
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            time.sleep(_POLL_S)
        else:
            code = next((p.exitcode for p in procs if p.exitcode != 0), 0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    return code
