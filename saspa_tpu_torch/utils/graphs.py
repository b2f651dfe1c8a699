"""CUDA graphs for the prompt tools' decode loops.

A greedy or sampled decode recomputes the whole prefix at each of its <= 40
positions: about 900 small kernels a step for BLIP's 12-layer decoder.
Launched one by one from Python, the host sets the pace (17.4 ms a caption
step on an H100, PERF.md cell (r)).  `replay(owner, key, fn,
*tensors)` records fn's kernels once per key and input shapes in a
torch.cuda.CUDAGraph and replays them on new inputs copied into the graph's
static buffers; the card then runs the same kernels on the same values
without the host between them.

fn must be a function of its tensors and of owner's weights (which stay in
place), and must neither synchronise with the host nor upload from it while
it runs (tensors it builds on the device, such as masks, are fine).  It
returns a tensor or a tuple of tensors and Nones; replay returns copies.
On the CPU, or with ENABLED False, replay calls fn.
"""

from __future__ import annotations

import weakref

import torch

ENABLED = True
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _copy(out):
    if isinstance(out, tuple):
        return tuple(_copy(o) for o in out)
    return None if out is None else out.clone()


def replay(owner, key, fn, *tensors):
    if not (ENABLED and tensors[0].is_cuda):
        return fn(*tensors)
    graphs = _GRAPHS.setdefault(owner, {})
    full_key = (key,) + tuple((tuple(t.shape), t.dtype) for t in tensors)
    entry = graphs.get(full_key)
    if entry is None:
        static = [t.clone() for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad(), torch.cuda.stream(side):  # one eager run first: cuBLAS handles, lazy buffers
            fn(*[t.clone() for t in static])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            out = fn(*static)
        entry = graphs[full_key] = (graph, static, out)
    graph, static, out = entry
    for buf, t in zip(static, tensors):
        buf.copy_(t)
    graph.replay()
    return _copy(out)
