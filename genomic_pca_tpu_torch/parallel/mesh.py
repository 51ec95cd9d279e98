"""The process group: one rank per device over the variant axis.

Counterpart of `genomic_pca_tpu/parallel/mesh.py` and of the
`multihost_utils.process_allgather` calls of the JAX package.  The JAX
package shards the variant axis over a 1-D device mesh ("v") and merges
each shard's small (n_pad x L) or (L x L) contribution with `psum`;
samples stay replicated.  Here the mesh axis is a `torch.distributed`
process group with one rank per device: every rank holds a contiguous
range of variant rows on its own device, runs the kernels over it, and
`all_reduce_sum` takes the place of `psum`.

The backend is a rule, logged once on rank 0:

- NCCL when every rank has a CUDA device of its own;
- gloo on the CPU, and for ranks that share a CUDA device (NCCL refuses
  two ranks on one device).  On gloo a CUDA tensor is staged through a
  pinned host buffer and copied back: the compute stays on the device,
  only the merge goes through the host.

No collective gives way to another path after a failure: an error of
the process group propagates.  At world size 1 with no process group
every function here is the identity, and the container runs as on one
device.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# Seconds a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 1800

# Calls and bytes of the collectives since the last reset (per rank), as
# `ops.kernels.LAUNCHES` counts kernel launches.
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
               "all_gather_bytes": 0}


def reset_collective_counts() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else default


def choose_backend(device_type: str, local_world_size: int) -> str:
    """"nccl" when each of the `local_world_size` ranks of this host has a
    CUDA device of its own, else "gloo" (the CPU, or ranks sharing a
    device)."""
    if device_type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    device: str = "cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; returns whether one is in use.

    Reads torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `LOCAL_WORLD_SIZE`, `MASTER_ADDR` / `MASTER_PORT` through "env://")
    unless `rank`, `world_size` and `init_method` are given.  Does
    nothing at world size 1, unless `backend` asks for a group of one
    rank (to drive the collective paths on one device).  `device` is the
    device type the ranks compute on ("cuda" or "cpu"), which the backend
    rule reads; `timeout_s` bounds every collective."""
    if dist.is_initialized():
        return True
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if world_size <= 1 and backend is None:
        return False
    device_type = torch.device(device).type
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    if backend is None:
        backend = choose_backend(device_type, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
    )
    if rank == 0:
        why = ("each rank has a CUDA device of its own" if backend == "nccl"
               else "CPU ranks" if device_type == "cpu"
               else f"{local_world} ranks share {torch.cuda.device_count()} "
                    "CUDA device(s); tensors are staged through pinned host "
                    "memory")
        log.info("Process group: %d ranks over %s (%s).", world_size, backend, why)
    return True


def shutdown() -> None:
    """Leave the process group, if one is in use."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """Ranks on this host: torchrun's `LOCAL_WORLD_SIZE`, else the world
    size."""
    return _env_int("LOCAL_WORLD_SIZE", process_count())


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank: `cuda:{LOCAL_RANK % device_count}` for
    "cuda" (ranks beyond the device count share devices), or the CPU
    when the caller passes "cpu"."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("rank_device('cuda'): no CUDA device is available")
    return torch.device("cuda", _env_int("LOCAL_RANK", process_index()) % n)


def _staged() -> bool:
    return dist.get_backend() == "gloo"


def comm_device() -> torch.device:
    """Where host data travels: the CPU on gloo, this rank's CUDA device
    on NCCL."""
    if _staged():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over every rank (in place where `t` is contiguous), or
    `t` itself without a process group."""
    if not dist.is_initialized():
        return t
    t = t.contiguous()
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += t.numel() * t.element_size()
    if t.is_cuda and _staged():
        host = _to_host(t)
        dist.all_reduce(host, op=op)
        t.copy_(host)
        return t
    dist.all_reduce(t, op=op)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every rank: the JAX package's `psum` over "v"."""
    return all_reduce(t, dist.ReduceOp.SUM)


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """(R * rows, ...) of every rank's (rows, ...) block in rank order
    (a tiled gather: every rank passes the same shape)."""
    if not dist.is_initialized():
        return local
    local = local.contiguous()
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += local.numel() * local.element_size()
    src = _to_host(local) if local.is_cuda and _staged() else local
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(local.device)


def all_gather_numpy(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's numpy arrays, key by key, stacked (R, ...) in rank
    order (JAX's `process_allgather`).  Every rank passes the same keys,
    shapes and dtypes; bool arrays travel as uint8."""
    if not dist.is_initialized():
        return {k: np.asarray(v)[None] for k, v in tree.items()}
    dev = comm_device()
    out = {}
    for key in sorted(tree):
        arr = np.ascontiguousarray(tree[key])
        is_bool = arr.dtype == np.bool_
        t = torch.from_numpy(arr.astype(np.uint8) if is_bool else arr).to(dev)
        parts = [torch.empty_like(t) for _ in range(process_count())]
        COLLECTIVES["all_gather"] += 1
        COLLECTIVES["all_gather_bytes"] += t.numel() * t.element_size()
        dist.all_gather(parts, t)
        got = np.stack([p.cpu().numpy() for p in parts])
        out[key] = got.astype(np.bool_) if is_bool else got
    return out


def all_gather_object(obj) -> list:
    """Every rank's picklable `obj`, in rank order (small host data of
    shapes that differ between ranks)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * process_count()
    COLLECTIVES["all_gather"] += 1
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
