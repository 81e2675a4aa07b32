"""The input pipeline (counterpart of
``keras_object_detection_tpu/data/pipeline.py`` ``YoloDataset`` and
``DeviceCachedDataset``).

Batches are raw: ``(images (B, S, S, 3) uint8, boxes (B, M, 5) float32,
valid (B, M) bool)``; augmentation and grid encoding run on the device
inside the train step. A thread pool decodes the files of a batch;
``prefetched(device)`` keeps two batches in flight to the device from pinned
host buffers, so the copy of the next batch overlaps the step on this one.
``DeviceCachedDataset`` holds the whole set on the device and gathers each
batch by index, with no per-step image copy at all.

Under data parallelism every rank reads the same file list and shuffle
stream and loads only its row block of each global batch (``block``), so
the batches are those of one process; ``DeviceCachedDataset(layout=
"sharded")`` splits the rows of the set over the ranks.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from keras_object_detection_torch.data import disk_cache
from keras_object_detection_torch.data.reader import (list_examples,
                                                      load_example)
from keras_object_detection_torch.parallel import distributed
from keras_object_detection_torch.parallel.mesh import shard_rows

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]
Device = Union[str, torch.device]


class YoloDataset:
    """Epoch-based batched loader over a YOLO-format directory.

    ``len()`` is ``ceil(n / batch)``, or ``floor`` with ``drop_remainder``;
    the last partial batch is padded with zero images that have no valid
    box. With ``shuffle`` each epoch draws a new order from one
    ``np.random.RandomState(seed)`` stream, the JAX package's. Files are
    sorted, so both packages see the same order.

    ``cache_in_memory`` keeps each decoded example in host RAM after its
    first read; ``cache_dir`` decodes every file once into a memmapped disk
    cache (``data/disk_cache.py``, built on construction when absent or
    stale); ``letterbox`` keeps the aspect with gray padding.

    ``shard_index`` / ``shard_count``: JAX's multi-host input split, each
    host reading the strided slice ``paths[shard_index::shard_count]`` of
    the file list. The data-parallel ``Trainer`` does not use it: there
    every rank reads the whole list and loads its row block of each global
    batch (``epoch(block=...)``), so batches match one process's.
    """

    def __init__(self, data_dir: str, image_size: int, batch_size: int,
                 max_boxes: int = 64, shuffle: bool = False,
                 drop_remainder: bool = False, num_workers: int = 8,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 cache_in_memory: bool = False,
                 cache_dir: Optional[str] = None, letterbox: bool = False):
        paths = np.array(list_examples(data_dir))
        if shard_count > 1:
            paths = paths[shard_index::shard_count]
        self.paths = paths
        if len(self.paths) == 0:
            raise FileNotFoundError(f"no *.jpg files under {data_dir!r}")
        self.image_size = image_size
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.letterbox = letterbox
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        self._pool = concurrent.futures.ThreadPoolExecutor(num_workers)
        self._cache: Optional[dict] = {} if cache_in_memory else None
        self._disk = None
        if cache_dir:
            self._disk = disk_cache.open_or_build(
                list(self.paths), image_size, max_boxes, cache_dir,
                letterbox=letterbox)
            self._disk_index = {p: i for i, p in enumerate(self.paths)}

    def __len__(self) -> int:
        n, b = len(self.paths), self.batch_size
        return n // b if self.drop_remainder else -(-n // b)

    @property
    def num_examples(self) -> int:
        return len(self.paths)

    def _load_one(self, path: str):
        if self._cache is not None:
            hit = self._cache.get(path)
            if hit is not None:
                return hit
        if self._disk is not None:
            ex = self._disk.load(self._disk_index[path])
        else:
            ex = load_example(path, self.image_size, self.max_boxes,
                              letterbox=self.letterbox)
        if self._cache is not None:
            self._cache[path] = ex
        return ex

    def _load_batch(self, paths, pin: bool = False,
                    rows: Optional[int] = None):
        """One batch, zero-padded to ``rows`` (default ``batch_size``):
        numpy arrays, or with ``pin`` torch tensors in pinned (page-locked)
        host memory."""
        s, m = self.image_size, self.max_boxes
        b = self.batch_size if rows is None else rows
        results = list(self._pool.map(self._load_one, paths))
        shapes = ((b, s, s, 3), (b, m, 5), (b, m))
        if pin:
            out = tuple(torch.zeros(shape, dtype=dt, pin_memory=True)
                        for shape, dt in zip(shapes, (torch.uint8,
                                                      torch.float32,
                                                      torch.bool)))
            views = [t.numpy() for t in out]
        else:
            out = views = tuple(np.zeros(shape, dt) for shape, dt in
                                zip(shapes, (np.uint8, np.float32, bool)))
        for i, (img, bx, vl) in enumerate(results):
            views[0][i], views[1][i], views[2][i] = img, bx, vl
        return out

    def epoch_indices(self) -> Iterator[np.ndarray]:
        """Each batch's indices into ``paths`` for one epoch (the last may
        be short): the one source of the epoch order, shared by the host
        loader and ``DeviceCachedDataset``."""
        order = np.arange(len(self.paths))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def _block(self, block: Optional[slice]):
        """``(rows, selector)``: the rows of a batch the caller loads and
        the function picking their indices out of a batch's."""
        if block is None:
            return self.batch_size, lambda sel: sel
        return block.stop - block.start, lambda sel: sel[block]

    def epoch(self, block: Optional[slice] = None) -> Iterator[Batch]:
        """Host (numpy) batches for one epoch; with ``block`` only those
        rows of each (padded) batch."""
        rows, pick = self._block(block)
        for sel in self.epoch_indices():
            yield self._load_batch(self.paths[pick(sel)], rows=rows)

    def prefetched(self, device: Device, prefetch: int = 2,
                   block: Optional[slice] = None
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """One epoch as tensors on ``device``, ``prefetch`` batches ahead,
        with ``block`` only those rows of each (padded) batch. On a CUDA
        device each batch is loaded into pinned host memory and copied with
        ``non_blocking=True`` (PyTorch's pinned-memory allocator reuses a
        buffer only after its copy has ended)."""
        dev = torch.device(device)
        pin = dev.type == "cuda"
        rows, pick = self._block(block)

        def put(sel):
            host = self._load_batch(self.paths[pick(sel)], pin=pin, rows=rows)
            if pin:
                return tuple(t.to(dev, non_blocking=True) for t in host)
            return tuple(torch.from_numpy(a).to(dev) for a in host)

        queue: collections.deque = collections.deque()
        it = self.epoch_indices()
        for sel in it:
            queue.append(put(sel))
            if len(queue) >= prefetch:
                break
        while queue:
            sel = next(it, None)
            if sel is not None:
                queue.append(put(sel))
            yield queue.popleft()


HEADROOM_BYTES = 4 << 30  # params, optimizer state and activations
DEFAULT_BUDGET_BYTES = 12 << 30  # where the device reports no memory


def device_budget_bytes(device: torch.device) -> int:
    """Bytes the cache may take on ``device``: the card's free memory (from
    ``torch.cuda.mem_get_info``) less ``HEADROOM_BYTES``, or
    ``DEFAULT_BUDGET_BYTES`` on a device that reports none."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(free - HEADROOM_BYTES, 0)
    return DEFAULT_BUDGET_BYTES


class DeviceCachedDataset:
    """The whole dataset resident on ``device``; each batch is a gather by
    a ``(batch,)`` index vector, with no per-step image copy.

    Row ``num_examples`` is an all-zero sentinel that pads the final partial
    batch, as the host loader pads with zeros. The order comes from the
    wrapped ``YoloDataset``'s shuffle stream, so batches are bit-equal to the
    host loader's.

    ``mesh``: a process mesh of data parallelism, each rank gathering its
    row block of each global batch. ``layout="replicated"``: every rank
    holds the whole set. ``layout="sharded"`` (needs ``mesh``): rank r of
    dp holds rows ``[r * n_rows / dp, (r + 1) * n_rows / dp)``, ``n_rows``
    rounded up to a multiple of dp with more zero sentinel rows; the gather
    has each rank fill the slots of the global batch whose rows it owns and
    zero the rest, and one integer SUM reduce-scatter hands each rank its
    block: exactly one owner contributes to a slot, so uint8 never widens
    (JAX's ``shard_map`` + ``psum_scatter``). The memory check is per
    device.
    """

    def __init__(self, ds: YoloDataset, device: Device,
                 layout: str = "replicated", mesh=None):
        if layout not in ("replicated", "sharded"):
            raise ValueError(f"unknown device_cache layout {layout!r}")
        if layout == "sharded" and mesh is None:
            raise ValueError("layout='sharded' requires a mesh")
        self.group = None if mesh is None else mesh.group
        dp = 1 if mesh is None else mesh.data_parallel
        if mesh is not None and self.group is None and dp > 1:
            raise ValueError("the device cache of a data-parallel run takes "
                             "a process mesh (one process a device)")
        self.device = torch.device(device)
        n, s, m = ds.num_examples, ds.image_size, ds.max_boxes
        n_rows = n + 1
        if layout == "sharded":
            n_rows = -(-n_rows // dp) * dp
        row_bytes = s * s * 3 + m * 5 * 4 + m
        per_device = n_rows * row_bytes // (dp if layout == "sharded" else 1)
        budget = device_budget_bytes(self.device)
        if per_device > budget:  # before any allocation or decode
            raise ValueError(
                f"device_cache: the dataset needs {per_device / 1e9:.1f} GB "
                f"per device ({layout}), too large for the device (budget "
                f"{budget / 1e9:.1f} GB); "
                + ("use cache_dir (disk) instead" if layout == "sharded"
                   or dp == 1 else "try device_cache_layout='sharded' or "
                   "cache_dir (disk)"))
        rank = 0 if self.group is None else mesh.index
        lo, hi = ((rank * n_rows // dp, (rank + 1) * n_rows // dp)
                  if layout == "sharded" else (0, n_rows))
        imgs = np.zeros((hi - lo, s, s, 3), np.uint8)
        boxes = np.zeros((hi - lo, m, 5), np.float32)
        valid = np.zeros((hi - lo, m), bool)
        for i in range(lo, min(hi, n)):
            imgs[i - lo], boxes[i - lo], valid[i - lo] = ds._load_one(
                ds.paths[i])
        self.images = torch.from_numpy(imgs).to(self.device)
        self.boxes = torch.from_numpy(boxes).to(self.device)
        self.valid = torch.from_numpy(valid).to(self.device)
        if ds._cache:
            ds._cache.clear()  # the device holds the data now
        self.layout = layout
        self.n_rows = n_rows
        self.row_offset = lo
        self.data_parallel = dp
        self.pad_row = n
        self.batch_size = ds.batch_size
        self.num_examples = n
        self._ds = ds

    def __len__(self) -> int:
        return len(self._ds)

    def block(self) -> slice:
        """This rank's rows of a global batch."""
        return shard_rows(self.batch_size, self.data_parallel)[
            distributed.rank_of(self.group)]

    def gather(self, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(images, boxes, valid)`` of this rank's block of the global
        batch ``idx`` (``(batch,)`` row indices on the device)."""
        if self.layout == "replicated":
            own = idx[self.block()]
            return self.images[own], self.boxes[own], self.valid[own]
        local = idx - self.row_offset
        ok = (local >= 0) & (local < self.images.shape[0])
        li = local.clamp(0, self.images.shape[0] - 1)

        def pick(arr):
            rows = arr[li]
            mask = ok.reshape((-1,) + (1,) * (rows.dim() - 1))
            rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
            return distributed.reduce_scatter_rows(rows, self.group)

        # bool has no sum: validity travels as uint8
        return (pick(self.images), pick(self.boxes),
                pick(self.valid.to(torch.uint8)) != 0)

    def epoch_indices(self) -> Iterator[np.ndarray]:
        """Each batch's row indices, padded to ``batch_size`` with the
        sentinel row."""
        for sel in self._ds.epoch_indices():
            if len(sel) < self.batch_size:
                sel = np.concatenate([
                    sel, np.full(self.batch_size - len(sel), self.pad_row)])
            yield sel.astype(np.int64)

    def epoch(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor]]:
        """One epoch of ``(images, boxes, valid, idx)`` on the device, each
        this rank's block of a global batch gathered by its row indices
        (``idx``, the block's); the epoch's indices go to the device in one
        copy."""
        rows = list(self.epoch_indices())
        if not rows:
            return
        for idx in torch.from_numpy(np.stack(rows)).to(self.device):
            yield (*self.gather(idx), idx[self.block()])
