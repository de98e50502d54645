"""Batch loader: shuffle, batch, place on the device, prefetch.

The port of mlcomp_tpu/data/loader.py.  The batch order is the JAX
loader's: the permutation is ``np.random.RandomState(seed + epoch)``'s,
``drop_last`` drops the ragged tail, and otherwise ``pad_to_batch`` pads
it by repeating the last row and masks the pad rows through ``valid``.
A one-deep prefetch thread assembles batch k+1 on the host while the
device runs batch k; on a CUDA device each host batch goes into pinned
memory and is copied ``non_blocking``, so the copy overlaps the device's
work as well.  As in the reference, ``MLCOMP_TPU_NATIVE_SHUFFLE`` opts into
the native Fisher-Yates permutation (``mlcomp_tpu_torch/native``), and the
rows of a batch are gathered on the native thread pool with the
interpreter lock released; either falls back to numpy, with the same rows,
where the library did not build.

Under a mesh every process walks the same global batches (the order is
the seed's) and feeds only its own rows: ``shard=(index, count)`` keeps
rows ``[index * B / count, (index + 1) * B / count)`` of each global
batch of ``batch_size`` B, the rank's (dp, fsdp) coordinate
(``parallel.mesh.batch_sharding``), as the JAX loader's multi-host feed
hands each process the slices its devices own.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch import native


class DataLoader:
    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        device: Optional[torch.device] = None,
        pad_to_batch: bool = True,
        shard: Tuple[int, int] = (0, 1),
    ):
        # "_"-prefixed keys are dataset metadata (e.g. _class_names), not
        # batchable arrays — kept aside for consumers like report builders
        self.meta = {k: v for k, v in data.items() if k.startswith("_")}
        data = {k: v for k, v in data.items() if not k.startswith("_")}
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"array {k!r} length {len(v)} != {n}")
        self.data = data
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.pad_to_batch = pad_to_batch
        self.shard = (int(shard[0]), int(shard[1]))
        if batch_size % self.shard[1]:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the {self.shard[1]} data shards "
                "(dp x fsdp)")
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            # index permutation: numpy's RNG by default (reproducible across
            # installs); the native Fisher-Yates when explicitly opted in
            nidx = None
            if os.environ.get("MLCOMP_TPU_NATIVE_SHUFFLE"):
                nidx = native.shuffled_indices(self.n, self.seed + self._epoch)
            if nidx is not None:
                idx = nidx
            else:
                np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            # gather on the native thread pool (a memcpy without the
            # interpreter lock); numpy where the library is missing
            batch = {}
            for k, v in self.data.items():
                g = native.gather_rows(v, sel)
                batch[k] = g if g is not None else v[sel]
            if self.pad_to_batch and len(sel) < self.batch_size:
                # fixed batch shapes: pad the ragged tail, mask via 'valid'
                pad = self.batch_size - len(sel)
                batch = {
                    k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                    for k, v in batch.items()
                }
                batch["valid"] = np.concatenate(
                    [np.ones(len(sel), np.float32), np.zeros(pad, np.float32)]
                )
            index, count = self.shard
            if count > 1:
                per = len(next(iter(batch.values()))) // count
                batch = {k: v[index * per:(index + 1) * per] for k, v in batch.items()}
            yield batch

    def _host_tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host tensors of a batch, pinned when they go to a CUDA device
        (runs on the prefetch thread)."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _place(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.device.type == "cpu":
            return batch
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def __iter__(self):
        """One-deep prefetch: host assembly of batch k+1 overlaps device k."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            try:
                for b in self._host_batches():
                    if stop.is_set():
                        return
                    q.put(self._host_tensors(b))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    break
                yield self._place(b)
        finally:
            stop.set()
            # drain so the producer can observe stop and exit
            while not q.empty():
                q.get_nowait()
            t.join(timeout=5.0)
