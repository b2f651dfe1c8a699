"""Data and model parallelism over processes (counterpart of
saspa_tpu/parallel/mesh.py).

The JAX package lays one `jax.sharding.Mesh` over the devices a process
sees and lets pjit insert the collectives.  The port runs one process a
card under `torch.distributed` (as `torchrun --nproc_per_node=N` starts
them) and writes its few collectives itself, from three: `all_reduce`,
`broadcast` and `barrier`.  PyTorch's backend table lists only those for
gloo on CUDA tensors, so the same code runs under NCCL on a node of several
cards and under gloo with several ranks on one card (NCCL refuses two ranks
on one device).  A gather is an all_reduce of a zeroed buffer into which each
rank writes its rows: x + 0 is exact, so the gather is bit-exact.

`Mesh` records the grid's shape, this rank and its device, and from them
the rank's coordinates: as JAX's make_mesh reshapes its devices row-major,
rank r sits at data index r // model and model index r % model.  The model
ranks of one data index hold the same rows (P("data") replicates them over
"model"), so every helper here that reduces or gathers rows, statistics,
gradients or metrics works over the rank's data group, the ranks of its
model index, and divides by the data size.  The model group (the ranks of
its data index) is used only by the column-parallel head
(parallel/head.py).  On an (n, 1) mesh the data group is the default group;
on a grid with both axes above 1, make_mesh creates one group a data row
and one a model column (every rank creates all of them, in one order, as
`new_group` asks) and keeps them in module state.  Without a group the mesh
has one rank, on which every helper is a no-op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from saspa_tpu_torch import resolve_device, to_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_DEVICE: Optional[torch.device] = None  # the device init_distributed gave this rank
# mesh shape -> (data groups by model index, model groups by data index), made by make_mesh
_GROUPS: dict = {}


def local_device_count() -> int:
    """Devices this process drives: one, in the port's one-process-a-card layout."""
    return 1


def _group() -> Tuple[int, int]:
    """(rank, world size) of the initialised default group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: Optional[str] = None, device=None) -> int:
    """Joins the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and returns the
    world size.  Without WORLD_SIZE, or at 1, it does nothing; with a group
    already up it only reports its size.

    device None: this rank's card is LOCAL_RANK, made the current device
    (so `resolve_device()` picks it); a missing card raises.  The backend is
    NCCL on a card and gloo on the CPU unless `backend` names one."""
    global _DEVICE
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"LOCAL_RANK {local} has no CUDA device ({n} visible); pass device= to run "
                               "elsewhere")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    device = torch.device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://",
                            rank=rank, world_size=world)
    _DEVICE = device
    _GROUPS.clear()
    return world


@dataclass(frozen=True)
class Mesh:
    """The group as a (data, model) grid: shape[0] data indices, the rest
    of the shape the model axis."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: Optional[torch.device] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def data_size(self) -> int:
        return int(self.shape[0])

    @property
    def model_size(self) -> int:
        return self.size // self.data_size

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a leading dim of n: its data
        index's share; raises unless the data axis divides n."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} rows does not divide over {self.data_size} data ranks")
        k = n // self.data_size
        return slice(self.data_index * k, (self.data_index + 1) * k)


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """The mesh of the initialised group (a one-rank mesh without one): all
    ranks on the data axis by default, or `shape`, e.g. (2, 2) for dp 2 x
    tp 2, whose product must be the world size.  Where both axes exceed 1,
    every rank creates the data and model groups here, collectively, once
    a shape.  shard_batch puts rows on init_distributed's device, else on
    the current card."""
    rank, world = _group()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if not shape or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} ranks, the group {world} ranks")
    mesh = Mesh(shape, tuple(axis_names[:len(shape)]), rank, _DEVICE)
    d, m = mesh.data_size, mesh.model_size
    if d > 1 and m > 1 and shape not in _GROUPS:
        data = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
        model = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
        _GROUPS[shape] = (data, model)
    return mesh


def _axis_group(mesh: Mesh, axis: int):
    """The rank's group along axis 0 (data) or 1 (model); None where that
    axis spans every rank (the default group)."""
    if (mesh.data_size if axis == 0 else mesh.model_size) == mesh.size:
        return None
    if mesh.shape not in _GROUPS:
        raise RuntimeError(f"no process groups for mesh {mesh.shape}: build the mesh with make_mesh")
    return _GROUPS[mesh.shape][axis][mesh.model_index if axis == 0 else mesh.data_index]


def data_group(mesh: Mesh):
    """The ranks of this rank's model index, one a data index (None: all)."""
    return _axis_group(mesh, 0)


def model_group(mesh: Mesh):
    """The ranks of this rank's data index, one a model index (None: all)."""
    return _axis_group(mesh, 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows (its data index's, mesh.rows) of every
    leaf (numpy array or tensor) of a pytree of dicts, lists and tuples, on
    the rank's device; raises when a leading dim does not divide over the
    data axis."""
    def cut(x):
        sl = mesh.rows(x.shape[0])
        if isinstance(x, torch.Tensor):
            return x[sl].to(mesh.device or x.device, non_blocking=True)
        return to_device(np.asarray(x)[sl], mesh.device or resolve_device(None))

    return _tree_map(cut, batch)


def _tensors(obj) -> list:
    if isinstance(obj, torch.nn.Module):
        if any(getattr(m, "model_sharded", False) for m in obj.modules()):
            # every shard has one shape: a broadcast would give each model index rank 0's classes
            raise ValueError("replicated: the module holds a model-sharded head; replicate before shard_head")
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    raise TypeError(f"replicated takes modules, tensors and dicts or lists of them, not {type(obj).__name__}")


@torch.no_grad()
def _flat_collective(tensors: list, collective) -> None:
    """Runs `collective` on one flat buffer a dtype and device, copied back in place."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, chunk in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(chunk.view_as(t))


def replicated(mesh: Mesh, obj):
    """Broadcasts rank 0's values into `obj` (a module's parameters and
    buffers, a tensor, or dicts and lists of them) on every rank; returns
    `obj`.  Refuses a module with a model-sharded head (parallel/head.py)."""
    if mesh.size > 1:
        _flat_collective(_tensors(obj), lambda flat: dist.broadcast(flat, 0))
    return obj


def all_reduce_mean_(mesh: Mesh, tensors: list, replicated: bool = False) -> None:
    """tensors <- their mean over the data axis, in place: one flat
    all_reduce (sum) a dtype over the data group, divided by the data size
    (a model-sharded parameter's data group holds its own shard only).
    replicated=True, for tensors every model rank holds whole: the mean over
    every rank, which is the data mean (the model ranks of a data index
    compute the same values) and leaves them bit-equal on every rank where
    the card's kernels are not deterministic (cuDNN's weight gradients)."""
    n = mesh.size if replicated else mesh.data_size
    if n > 1:
        group = None if replicated else data_group(mesh)
        _flat_collective(tensors, lambda flat: (dist.all_reduce(flat, group=group), flat.div_(n)))


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data axis (a new tensor; `t` itself on one
    data index)."""
    if mesh.data_size == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, group=data_group(mesh))
    return out


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every data index's rows, in data order: each rank writes its rows
    into a zeroed buffer of the whole and the data group sums the buffers,
    which is exact."""
    if mesh.data_size == 1:
        return local
    n = local.shape[0]
    out = torch.zeros((n * mesh.data_size, *local.shape[1:]), dtype=local.dtype, device=local.device)
    out[mesh.data_index * n:(mesh.data_index + 1) * n] = local
    dist.all_reduce(out, group=data_group(mesh))
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier()


def broadcast_str(mesh: Mesh, s: Optional[str], device=None) -> str:
    """Rank 0's string on every rank (a path only rank 0 can make)."""
    if mesh.size == 1:
        return s
    dev = device or mesh.device or torch.device("cpu")
    data = (s or "").encode()
    n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(n, 0)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if mesh.rank == 0:
        buf.copy_(torch.tensor(list(data), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return bytes(buf.cpu().tolist()).decode()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
