"""Scoring image files in padded batches on the card, shared by the CLIP
and the confidence filters.

The host reads and preprocesses a batch's files in a thread pool (the numpy
decode and resample release the interpreter lock for most of their time),
pads the batch to a full one so every forward has one shape, and the model
runs on the device; the scores come back as float32 numpy.  Host and device
seconds are kept apart in a caller's `timings` dict.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

HOST_THREADS = 16  # the JAX filters' pool size (clip_filters.py:38, confidence.py:33)


def new_timings() -> dict:
    """preprocess_s: host read + resample; device_s: upload, forward and
    fetch; images: files scored; batches: forwards run; verify_s: the aug-JSON
    builder's corrupt-file sweep."""
    return {"preprocess_s": 0.0, "device_s": 0.0, "images": 0, "batches": 0, "verify_s": 0.0}


@torch.no_grad()
def score_in_batches(paths: Sequence[str], preprocess: Callable[[str], np.ndarray],
                     forward: Callable[[torch.Tensor], torch.Tensor], batch_size: int, width: int,
                     device: torch.device, timings: Optional[dict] = None) -> np.ndarray:
    """(N, width) float32 scores of `forward` on NCHW batches of
    `preprocess(path)` (an (H, W, 3) float32 array each)."""
    out = []
    with ThreadPoolExecutor(max_workers=HOST_THREADS) as pool:
        for lo in range(0, len(paths), batch_size):
            chunk = paths[lo:lo + batch_size]
            t0 = time.perf_counter()
            x = np.stack(list(pool.map(preprocess, chunk)))
            if len(chunk) < batch_size:  # pad: one shape for every forward
                x = np.concatenate([x, np.zeros((batch_size - len(chunk), *x.shape[1:]), x.dtype)])
            t1 = time.perf_counter()
            xt = torch.from_numpy(x).to(device).permute(0, 3, 1, 2)
            if device.type == "cuda":
                xt = xt.contiguous(memory_format=torch.channels_last)
            out.append(forward(xt)[:len(chunk)].float().cpu().numpy())
            t2 = time.perf_counter()
            if timings is not None:
                timings["preprocess_s"] += t1 - t0
                timings["device_s"] += t2 - t1
                timings["images"] += len(chunk)
                timings["batches"] += 1
    return np.concatenate(out) if out else np.zeros((0, width), np.float32)
