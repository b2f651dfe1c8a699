"""Scoring image files in padded batches on the card, shared by the CLIP
and the confidence filters.

The host reads and preprocesses a batch's files in a thread pool (the numpy
decode and resample release the interpreter lock for most of their time),
pads the batch to a full one so every forward has one shape, and the model
runs on the device; the scores come back as float32 numpy.  Host and device
seconds are kept apart in a caller's `timings` dict.

With a mesh of more than one data index (parallel/mesh.py; JAX's scorers
shard each batch over the mesh's data axis, filters/confidence.py:86-118),
each batch is padded to a multiple of the data size and split into the data
indices' contiguous rows: a rank reads and preprocesses only its rows, on
its own host threads, runs them on its card, and one all_reduce of a zeroed
buffer over its data group gathers the scores, so every rank returns the
whole (N, width) array after the same collectives.  The model ranks of a
data index score the same rows (a model-sharded head gathers its own
logits, parallel/head.py).  Sharding is asked for by passing the mesh, never taken up
because a group exists: a rank that scores alone while a group is up enters
no collective.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from saspa_tpu_torch.parallel.mesh import Mesh, gather_rows, pad_to_multiple

HOST_THREADS = 16  # the JAX filters' pool size (clip_filters.py:38, confidence.py:33)


def new_timings() -> dict:
    """preprocess_s: host read + resample; device_s: upload, forward,
    gather and fetch; images: files scored (by this rank, under a mesh);
    batches: forwards run; verify_s: the aug-JSON builder's corrupt-file
    sweep."""
    return {"preprocess_s": 0.0, "device_s": 0.0, "images": 0, "batches": 0, "verify_s": 0.0}


@torch.no_grad()
def score_in_batches(paths: Sequence[str], preprocess: Callable[[str], np.ndarray],
                     forward: Callable[[torch.Tensor], torch.Tensor], batch_size: int, width: int,
                     device: torch.device, timings: Optional[dict] = None, mesh: Optional[Mesh] = None) -> np.ndarray:
    """(N, width) float32 scores of `forward` on NCHW batches of
    `preprocess(path)` (an (H, W, 3) float32 array each); under a mesh,
    every rank's the whole array."""
    mesh = mesh if mesh is not None and mesh.data_size > 1 else None
    full = batch_size if mesh is None else pad_to_multiple(batch_size, mesh.data_size)
    own = slice(0, full) if mesh is None else mesh.rows(full)
    out = []
    with ThreadPoolExecutor(max_workers=HOST_THREADS) as pool:
        for lo in range(0, len(paths), batch_size):
            chunk = paths[lo:lo + batch_size]
            mine = chunk[own]
            t0 = time.perf_counter()
            x = np.stack(list(pool.map(preprocess, mine))) if mine else None
            rows = own.stop - own.start
            if len(mine) < rows:  # pad: one shape for every forward
                if x is None:
                    x = np.zeros((rows, *preprocess(chunk[0]).shape), np.float32)
                else:
                    x = np.concatenate([x, np.zeros((rows - len(mine), *x.shape[1:]), x.dtype)])
            t1 = time.perf_counter()
            xt = torch.from_numpy(x).to(device).permute(0, 3, 1, 2)
            if device.type == "cuda":
                xt = xt.contiguous(memory_format=torch.channels_last)
            y = forward(xt).float()
            if mesh is not None:
                y = gather_rows(mesh, y)
            out.append(y[:len(chunk)].cpu().numpy())
            t2 = time.perf_counter()
            if timings is not None:
                timings["preprocess_s"] += t1 - t0
                timings["device_s"] += t2 - t1
                timings["images"] += len(mine)
                timings["batches"] += 1
    return np.concatenate(out) if out else np.zeros((0, width), np.float32)
