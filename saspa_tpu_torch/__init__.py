"""PyTorch/CUDA port of saspa_tpu's generation path, for NVIDIA Hopper (H100).

The JAX package `saspa_tpu` is the reference; this package imports nothing
of it (nor jax) and keeps its own copies of what it needs.

Device policy: entry points take `device=None`, which means the CUDA card;
with no CUDA device they raise instead of running on the CPU.  Pass
`device="cpu"` explicitly (the parity tests do).  A kernel wrapper given a
CPU tensor runs its plain PyTorch version; given a CUDA tensor it launches
its hand-written kernel or raises.

Dtype policy: bf16 on the card, f32 on the CPU (parity tests).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "default_dtype", "to_device"]


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: saspa_tpu_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def default_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`.  To the card it goes through
    pinned memory without waiting: an upload from pageable memory
    synchronizes the stream, so the host could not queue work ahead of the
    card."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
