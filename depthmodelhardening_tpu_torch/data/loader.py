"""Threaded prefetch pipeline: host decode -> device batches.

Counterpart of `depthmodelhardening_tpu/data/loader.py` (reference
DataLoader worker processes, trainer.py:181-191, num_workers=12): a
thread pool decodes and stacks numpy items while the card trains (the C
decoder and numpy release the GIL), one batch or more ahead of the step.
The same batches in the same order as the JAX package's for a seed: the
epoch's shuffle from RandomState(seed + epoch), each item's draws
(do_flip) from its own RandomState seeded from that one.

A batch leaves the producer thread as `collate`'s arrays in pinned host
memory (on a CUDA device), and the consuming thread copies it to the
device with `non_blocking=True`, so the copy is queued on the step's
stream behind the work already there. Numpy arrays become tensors of
the same dtype (bool stays bool); the nesting of the batch is kept.

With `mesh=` (JAX loader.py:35, 57-62: each global batch sharded over the
mesh's devices) the batch size is the global batch's: every rank walks
the same global batches with the same item seeds, and decodes and yields
only its own rows of each.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


def _to_host(batch, pin: bool):
    """numpy leaves -> tensors (pinned when `pin`), nesting kept."""
    if isinstance(batch, dict):
        return {k: _to_host(v, pin) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    return t.pin_memory() if pin else t


def _to_device(batch, device: torch.device):
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return batch.to(device, non_blocking=True)


class PrefetchLoader:
    """Batched, shuffled, prefetched iterator over an indexable dataset.

    dataset: object with __len__ and a get(index, rng) -> item callable
      (defaults to get_item / __getitem__).
    collate: items -> batch (a dict, possibly nested) of numpy arrays.
    device: where the batches land; default the current CUDA card
      (`device.resolve_device`, which raises without one), or the mesh's.
      Tests pass "cpu".
    mesh: a data-parallel `parallel.mesh.Mesh`: each batch is this rank's
      batch_size / world_size rows of the global batch.
    """

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_threads: int = 8,
                 prefetch: int = 2, mesh=None,
                 item_fn: Optional[Callable] = None, device=None):
        if mesh is not None:
            mesh.rows(batch_size, "batch_size")
            device = mesh.own_device(device)
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.item_fn = item_fn or (
            lambda ds, i, rng: ds.get_item(i, rng)
            if hasattr(ds, "get_item") else ds[i])
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)

        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        pin = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def _put(item) -> bool:
            """put that re-checks stop so an abandoned iterator (early
            break) can't leave the producer blocked on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        seeds = rng.randint(0, 2 ** 31, size=len(idxs))
                        mine = (slice(None) if self.mesh is None
                                else self.mesh.rows(len(idxs)))
                        items = list(pool.map(
                            lambda a: self.item_fn(
                                self.dataset, int(a[0]),
                                np.random.RandomState(int(a[1]))),
                            zip(idxs[mine], seeds[mine])))
                        if not _put(_to_host(self.collate(items), pin)):
                            return
            except Exception as e:  # handed to the consumer, raised there
                failure.append(e)
            _put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield _to_device(batch, self.device)
        finally:
            stop.set()
