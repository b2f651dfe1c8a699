"""Host input pipeline of the train stage (counterpart of
saspa_tpu/data/pipeline.py): threaded decode and resize on the host, the
batch uploaded as uint8, the transforms on the device.

The host decodes each file (`gen/image_io.read_rgb`: PNG in numpy, JPEG
with the host decoder of `gen/jpeg.py`, PIL's pixels without PIL) and resizes it to the
pre-crop size (size / 0.875) with the JAX package's native resize
(`ops/host_resize.py`), in a thread pool; a producer thread keeps 2
batches ahead and re-raises its errors in the consumer.  The epoch's order
is `RandomState(seed * 100003 + epoch)`'s shuffle and each train batch's
transform key `item_key(seed, "augment", epoch, i)`, as in the JAX package,
so the batches equal its batches; with CutMix, each batch's mixing key is
`item_key(seed, "cutmix", epoch, i)`.  `timings` adds up the host seconds the
consumer waited for batches (`host_wait_s`) and the seconds the producer
spent loading them (`load_s`).

Under a mesh of more than one data index (parallel/mesh.py), `batch_size`
stays the global batch and each rank yields its data index's contiguous rows
of every global batch (the rows shard_batch would cut): it loads and transforms only those,
draws for the whole batch and keeps its rows' draws (`utils/rng.py::Rows`),
and still asks the dataset for every path of the batch in order, since the
AugSampler's substitutions are one sequential stream.  With CutMix it also
loads the rows its rows mix from (`ops/augment.py::cutmix_sources`).  So a
rank's rows equal the one-process batch's.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from saspa_tpu_torch import resolve_device, to_device
from saspa_tpu_torch.data.datasets import FGVCDataset
from saspa_tpu_torch.gen.image_io import read_rgb
from saspa_tpu_torch.ops.augment import cutmix_batch, cutmix_sources, train_transform_batch, val_transform_batch
from saspa_tpu_torch.ops.host_resize import resize_bilinear_u8
from saspa_tpu_torch.parallel.mesh import Mesh
from saspa_tpu_torch.utils import rng as rngs


PREFETCH = 2  # batches the producer keeps ahead


def decode_resize(path: str, pre_h: int, pre_w: int) -> np.ndarray:
    return resize_bilinear_u8(read_rgb(path), pre_h, pre_w)


class InputPipeline:
    """Yields device-ready batches of an FGVCDataset on `device` (None: the
    card)."""

    def __init__(self, dataset: FGVCDataset, batch_size: int, resize: Tuple[int, int] = (224, 224),
                 train_transform: Optional[str] = "classic", use_cutmix: bool = False, seed: int = 1,
                 num_threads: int = 8, device=None, drop_last: bool = True, mesh: Optional[Mesh] = None):
        self.ds = dataset
        self.own: Optional[rngs.Rows] = None  # this rank's rows of each batch, under a mesh
        if mesh is not None and mesh.data_size > 1:
            if not drop_last:
                raise ValueError("a mesh takes full batches only (drop_last=True)")
            sl = mesh.rows(batch_size)  # raises unless the ranks divide the batch
            self.own = rngs.Rows(np.arange(sl.start, sl.stop), batch_size)
        self.drop_last = drop_last
        self.batch_size = batch_size
        self.resize = resize
        self.pre_size = (int(resize[0] / 0.875), int(resize[1] / 0.875))
        self.train_transform = train_transform
        self.use_cutmix = use_cutmix
        self.seed = seed
        self.device = resolve_device(device)
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self.timings = {"host_wait_s": 0.0, "load_s": 0.0, "batches": 0}

    def __len__(self):
        """Full batches only: a partial last batch is dropped, at eval too,
        as the reference's DataLoaders (fgvc/train.py:316-319); with
        drop_last=False the partial last batch is one more."""
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_order(self, epoch: int, shuffle: bool) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if shuffle:
            np.random.RandomState(self.seed * 100003 + epoch).shuffle(idx)
        return idx

    def _load_batch(self, indices, keep=None) -> Tuple[np.ndarray, np.ndarray]:
        """The batch's rows `keep` (all by default), decoded and resized."""
        pre_h, pre_w = self.pre_size
        items = [self.ds.item_path(int(i)) for i in indices]  # the AugSampler draws in index order
        if keep is not None:
            items = [items[k] for k in keep]
        arrays = list(self._pool.map(lambda it: decode_resize(it[0], pre_h, pre_w), items))
        return np.stack(arrays), np.asarray([it[1] for it in items], np.int32)

    def _sources(self, epoch: int, i: int, mix: bool) -> Optional[np.ndarray]:
        """The rows of global batch i this rank loads (None: all): its own,
        and with CutMix (`mix`) those they mix from."""
        if self.own is None:
            return None
        if mix and self.use_cutmix:
            return cutmix_sources(rngs.item_key(self.seed, "cutmix", epoch, i), self.own, *self.resize)
        return self.own.index

    def host_batches(self, epoch: int, shuffle: bool) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """uint8 (B, pre_h, pre_w, 3) and int32 (B,) labels, prefetched;
        under a mesh the rows `_sources` names (a shuffled epoch is a train
        epoch, which mixes)."""
        idx = self._index_order(epoch, shuffle)
        bounds = [(lo, min(lo + self.batch_size, len(idx))) for lo in range(0, len(self) * self.batch_size,
                                                                          self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:  # a bounded put that gives up once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i, (lo, hi) in enumerate(bounds):
                    if stop.is_set():
                        return
                    t = time.perf_counter()
                    batch = self._load_batch(idx[lo:hi], self._sources(epoch, i, shuffle))
                    self.timings["load_s"] += time.perf_counter() - t
                    if not put(("batch", batch)):
                        return
                put(("done", None))
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put(("error", e))

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                t = time.perf_counter()
                kind, item = q.get()
                self.timings["host_wait_s"] += time.perf_counter() - t
                if kind == "error":
                    raise RuntimeError("input pipeline producer failed") from item
                if kind == "done":
                    break
                self.timings["batches"] += 1
                yield item
        finally:
            stop.set()

    def _upload(self, x_u8: np.ndarray) -> torch.Tensor:
        return to_device(x_u8, self.device)

    def iter_train(self, epoch: int):
        """Yields (X normalized float32 (B, 3, h, w), y int64 (B,), y_soft
        float32 (B, classes) or None) on the device; y_soft is CutMix's.
        Under a mesh, this rank's rows of each."""
        th, tw = self.resize
        for i, (x_u8, y) in enumerate(self.host_batches(epoch, shuffle=True)):
            key = rngs.item_key(self.seed, "augment", epoch, i)
            src = self._sources(epoch, i, True)
            src = None if src is None else rngs.Rows(src, self.batch_size)
            X = train_transform_batch(self._upload(x_u8), key, self.train_transform, th, tw, src)
            y = to_device(y.astype(np.int64), self.device)
            y_soft = None
            if self.use_cutmix:
                X, y, y_soft = cutmix_batch(X, y, rngs.item_key(self.seed, "cutmix", epoch, i), self.ds.num_classes,
                                            self.own)
            yield X, y, y_soft

    def iter_eval(self):
        """(X, y) of each eval batch; under a mesh, this rank's rows."""
        th, tw = self.resize
        for x_u8, y in self.host_batches(0, shuffle=False):
            yield val_transform_batch(self._upload(x_u8), th, tw), to_device(y.astype(np.int64), self.device)
