"""The column-parallel classifier head: WSDAN-CAL's `fc` split over the
mesh's model axis (counterpart of __graft_entry__.py's dry run, which puts
`fc/kernel` on P(None, "model") and replicates everything else).

The port's Dense kernel is (out, in), so model index j holds classes
[j * c, (j + 1) * c) of c = classes / model size: rows of the kernel, still
named `fc.kernel`, so that sgd_update, the momentum dict and the data
group's gradient mean find it.  The forward is JAX's sharded product:

  x -> copy_to_model(x)    identity forward; backward, the input gradient
                           summed over the model group (each model rank's
                           product sees only its classes' share of it);
    -> F.linear(x, shard)  the local (B, c) logits at the model dtype;
    -> gather_from_model   every model rank's columns, by an all_reduce of
                           a zeroed (B, classes) buffer (exact); backward,
                           this rank's columns of the output gradient, with
                           no communication.

Each model rank of a data index holds the same rows and computes the whole
loss from the gathered logits, so its output gradient is already the whole
gradient: summing it over the model group (torch.distributed.nn's
all_reduce as the gather's backward) would scale it by the model size.  The
reduction sits on the head's input only, so a gradient that reaches the
features by another way (the center loss on feature_matrix) is not summed.

Sharding order: replicate the model first (parallel/mesh.py::replicated
refuses a sharded one: every shard has one shape, and a broadcast would
give each model index rank 0's classes), then shard; average a shard's
gradient over its data group only (all_reduce_mean_), never over all ranks,
which would average different classes' columns (fgvc/train.py keeps the
sharded parameters apart).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.parallel.mesh import Mesh, model_group


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group, index: int, size: int):
        c = local.shape[-1]
        ctx.cols = slice(index * c, (index + 1) * c)
        out = local.new_zeros((*local.shape[:-1], c * size))
        out[..., ctx.cols] = local
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols].contiguous(), None, None, None


class ColumnParallelDense(nn.Module):
    """A bias-free Dense's model shard, `kernel` (classes / model size,
    in); forward(x) returns the whole (..., classes) output on every model
    rank."""

    model_sharded = True  # parallel/mesh.py::replicated refuses a module holding one

    def __init__(self, dense: nn.Module, mesh: Mesh):
        super().__init__()
        if dense.bias is not None:
            raise ValueError("ColumnParallelDense takes a head without a bias (WSDAN-CAL's fc)")
        out_features = dense.kernel.shape[0]
        self.mesh, self.dtype, self.out_features = mesh, dense.dtype, out_features
        self.rows = slice(mesh.model_index * (out_features // mesh.model_size),
                          (mesh.model_index + 1) * (out_features // mesh.model_size))
        self.kernel = nn.Parameter(dense.kernel.detach()[self.rows].clone(), requires_grad=dense.kernel.requires_grad)

    def forward(self, x):
        group, dt = model_group(self.mesh), self.dtype
        x = _CopyToModel.apply(x, group)
        local = F.linear(x.to(dt), self.kernel.to(dt))
        return _GatherFromModel.apply(local, group, self.mesh.model_index, self.mesh.model_size)

    @torch.no_grad()
    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole (classes, ...) tensor of a shard-shaped one (the kernel,
        its gradient or momentum), on every model rank."""
        out = shard.new_zeros((self.out_features, *shard.shape[1:]))
        out[self.rows] = shard
        dist.all_reduce(out, group=model_group(self.mesh))
        return out


def shard_head(model: nn.Module, mesh: Mesh, momentum: Optional[dict] = None) -> nn.Module:
    """Replaces model.fc with its ColumnParallelDense over mesh's model axis
    where JAX shards it: a model axis above 1 and a class count that it
    divides; otherwise the head stays whole and replicated (dtd's 47 classes
    on 2 model ranks, say).  `momentum` (a TrainState's, by parameter name)
    gets fc.kernel's entry cut to the shard.  Returns the model."""
    fc = model.fc
    m = mesh.model_size
    if m == 1 or fc.kernel.shape[0] % m:
        return model
    model.fc = ColumnParallelDense(fc, mesh)
    if momentum is not None:
        momentum["fc.kernel"] = momentum["fc.kernel"][model.fc.rows].clone()
    return model
