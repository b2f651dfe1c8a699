"""Parameter-holding building blocks shared by the port's models.

Parameter names follow the flax modules of saspa_tpu (`kernel`, `bias`,
`scale`, `embedding`), so a flax path maps to a torch state_dict key by
replacing "/" with "."; layouts are torch's (dense (out, in), conv OIHW).

Dense/Conv/Embed hold their weights in the compute dtype (flax casts its f32
masters to the module dtype at every call; casting once is the same value).
Training passes `param_dtype=torch.float32`: Dense and Conv then keep f32
masters and cast them to the compute dtype at every call, as flax does, so
the gradient reaches the masters.  Norm parameters stay f32, as the JAX
package reads them, and so does the bias of an attention's to_out, which the
block kernel K5 reads as f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def acc_dtype(x: torch.Tensor) -> torch.Tensor:
    """x in at least f32: low precision upcast, f64 kept (jnp.promote_types(x, f32))."""
    return x if x.dtype == torch.float64 else x.float()


def _empty(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """bias_dtype: keep the bias in another dtype (an f32 master, cast to
    the compute dtype per call); param_dtype: the same for the kernel."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32, device=None, bias_dtype=None,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _empty((out_features, in_features), param_dtype or dtype, device)
        self.bias = _empty((out_features,), bias_dtype or param_dtype or dtype, device) if bias else None

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt), None if self.bias is None else self.bias.to(dt))


class Conv(nn.Module):
    """NCHW conv with symmetric padding; kernel_size and padding an int or
    an (h, w) pair; param_dtype as Dense's."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dtype=torch.float32, device=None, bias=True,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.kernel = _empty((out_ch, in_ch, kh, kw), param_dtype or dtype, device)
        self.bias = _empty((out_ch,), param_dtype or dtype, device) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.kernel.to(dt), None if self.bias is None else self.bias.to(dt),
                        self.stride, self.padding)


class Embed(nn.Module):
    def __init__(self, num, features, dtype=torch.float32, device=None):
        super().__init__()
        self.embedding = _empty((num, features), dtype, device)

    def forward(self, ids):
        return self.embedding[ids]


class NormParams(nn.Module):
    """f32 {scale, bias} of a LayerNorm or GroupNorm."""

    def __init__(self, features, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9) on NCHW: f32 {scale, bias} parameters
    and {mean, var} buffers (flax's batch_stats collection);
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, cast back to x's
    dtype.  Starts at mean 0, var 1.

    forward(x) normalizes with the running statistics (use_running_average).
    forward(x, train=True) normalizes with the batch's: f32 mean and fast
    variance E[x^2] - E[x]^2 clipped at 0 (biased), over every axis but the
    channels, differentiable; and folds them into the running statistics
    under no_grad as ra = 0.9 * ra + 0.1 * batch, var as mean.

    `mesh` (set by `sync_batch_norms`): with more than one data index, the
    batch is the global one.  Each rank's mean and mean of x^2 are summed
    over its data group (parallel/mesh.py: the model ranks of a data index
    hold the same rows) by the autograd-aware all_reduce and divided by the
    data size (the shards are equal), so every rank normalizes by, and
    folds in, the same statistics, as flax over a sharded batch."""

    momentum = 0.9
    mesh = None

    def __init__(self, features, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = acc_dtype(x)
        if train:
            dims = [0] + list(range(2, x.ndim))
            mean, sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
            if self.mesh is not None and self.mesh.data_size > 1:
                from torch.distributed.nn.functional import all_reduce

                from saspa_tpu_torch.parallel.mesh import data_group

                mean, sq = all_reduce(torch.stack([mean, sq]), group=data_group(self.mesh)) / self.mesh.data_size
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(x.dtype)


def sync_batch_norms(module: nn.Module, mesh) -> nn.Module:
    """Every BatchNorm of `module` takes its train-mode statistics over
    `mesh`'s global batch (None: its own batch again)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    return module


def flax_layer_norm(x, scale, bias, eps: float = 1e-5):
    """flax nn.LayerNorm(dtype=float32): f32 stats with the clamped fast
    variance, the normalize in f32; returns f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * scale) + bias


def nearest_resize(x, out_h: int, out_w: int):
    """jax.image.resize(method="nearest") on NHWC: source index
    floor((i + 0.5) * in / out), computed in f32 as JAX does."""
    def idx(n_in, n_out):
        o = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(o).to(torch.long).to(x.device)

    if x.shape[1] != out_h:
        x = x.index_select(1, idx(x.shape[1], out_h))
    if x.shape[2] != out_w:
        x = x.index_select(2, idx(x.shape[2], out_w))
    return x


@torch.no_grad()
def init_weights(module: nn.Module, seed: int, zero_prefixes=()) -> None:
    """Seeded random init in the spirit of flax's defaults (the bits differ):
    dense/conv kernels N(0, 1/fan_in), embeddings, the ViT's class token and
    the Q-Former's queries and position embeddings N(0, 0.02), positional
    embeddings N(0, 0.01), biases 0, norm scales 1, CLIP's logit_scale
    ln(100) (flax's constant 4.6052).  Parameters whose name
    starts with one of `zero_prefixes` stay zero (ControlNet's zero convs)."""
    gen = None
    for name, p in sorted(module.named_parameters(), key=lambda kv: kv[0]):
        if gen is None:
            gen = torch.Generator(device=p.device).manual_seed(seed)
        leaf = name.rsplit(".", 1)[-1]
        if any(name.startswith(z) for z in zero_prefixes):
            p.zero_()
            continue
        if leaf == "kernel":
            fan_in = p[0].numel()
            std = fan_in ** -0.5
        elif leaf in ("embedding", "class_embedding", "query_tokens", "position_embeddings"):
            std = 0.02
        elif leaf == "positional_embedding":
            std = 0.01
        elif leaf == "scale":
            p.fill_(1.0)
            continue
        elif leaf == "logit_scale":
            p.fill_(4.6052)
            continue
        else:
            p.zero_()
            continue
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32) * std)
