"""Process meshes for multi-GPU runs (counterpart of d3ga_tpu/dist/mesh.py).

A ("data", "model") mesh over the ranks of one `torch.distributed` world,
laid out as the JAX package's device array: rank = data_index * model +
model_index.

  * "data"  — frames/cameras (batch) parallelism; gradients all-reduce
              over this axis,
  * "model" — Gaussian-parallel geometry + tile-parallel raster inside
              each replica (`dist/raster_shard.py`).

Each axis is a process group: the ranks that share this rank's other
coordinate. The backend follows the device the caller asks for: NCCL for
CUDA tensors, Gloo for CPU tensors (the CPU tests).
"""

import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    data: int                  # size of the "data" axis
    model: int                 # size of the "model" axis
    data_group: object         # ranks with this rank's model index
    model_group: object        # ranks with this rank's data index
    data_index: int            # this rank's coordinates
    model_index: int


def _groups(rank_lists):
    """This rank's group among `rank_lists` (every rank creates every
    group, in the same order, as torch.distributed requires); the world
    group where one list holds every rank."""
    if len(rank_lists) == 1:
        return dist.group.WORLD
    mine, _ = dist.new_subgroups_by_enumeration(rank_lists)
    return mine


def make_mesh(data: int = 1, model: int = -1) -> Mesh:
    """Build the ("data", "model") mesh over the initialized world.
    model=-1 uses all remaining ranks; data * model must be the world
    size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    n = dist.get_world_size()
    if model == -1:
        if n % data:
            raise ValueError(f"make_mesh: world size {n} not divisible by data={data}")
        model = n // data
    if data * model != n:
        raise ValueError(f"make_mesh: data={data} x model={model} != world size {n}")
    rank = dist.get_rank()
    model_group = _groups([[d * model + j for j in range(model)] for d in range(data)])
    data_group = _groups([[d * model + j for d in range(data)] for j in range(model)])
    return Mesh(data, model, data_group, model_group, rank // model, rank % model)


def local_mesh() -> Mesh:
    """The 1 x 1 mesh of a world of one process (degenerate but keeps one
    code path)."""
    return make_mesh(1, 1)


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device="cuda", timeout_s=300):
    """Join the world (`torch.distributed.init_process_group`): NCCL when
    `device` is a CUDA device, Gloo when it is the CPU. coordinator_address
    is an init method URL ("tcp://host:port", "file:///path") or a bare
    "host:port"; None reads the MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    RANK environment. A CUDA device is made this process's current one."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None else 0)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: unsupported device {device}")
    kwargs = {}
    if coordinator_address is not None:
        url = coordinator_address
        kwargs = dict(
            init_method=url if "://" in url else f"tcp://{url}",
            world_size=num_processes,
            rank=process_id,
        )
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
