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

import torch

__all__ = ["resolve_device", "default_dtype"]


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
