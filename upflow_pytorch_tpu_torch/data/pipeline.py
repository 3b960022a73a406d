"""Host-side input pipeline: threaded decode, batching and device prefetch.

Port of ``upflow_pytorch_tpu/data/pipeline.py``.  A thread pool decodes
and augments items, a producer thread stacks them into batches, and up to
``prefetch`` batches wait in a bounded queue ahead of the consumer.

Deterministic iteration: each epoch's order comes from
``RandomState((seed * 100003 + epoch) % 2**31)``, items with an
``item(index, epoch=)`` method draw their augmentation from ``(seed,
epoch, index)`` (``data/rng.py``), and ``state()`` is the cursor of the
next batch the consumer will see, so a loader built from it resumes
mid-epoch with the same batches.

With ``device`` on the card, the producer stacks each batch into pinned
host tensors and copies it on a side stream with ``non_blocking=True``;
``__next__`` makes the consumer's current stream wait on the copy's event
and records the batch's tensors on that stream, so the copy overlaps the
previous step and the caching allocator never reuses them early.  With a
CPU ``device`` the batch is ``torch.from_numpy`` of the stacked arrays;
with ``device=None`` (and no ``post_fn``) it stays numpy, as the JAX
loader's does.

With ``shard=(rank, ranks)`` (the sharded training step of
``parallel/``) every rank walks the same epoch order and cursor over
global batches of ``batch_size`` items, and decodes only its contiguous
``batch_size / ranks`` of each: the rank's slice of the global batch, as
each JAX process feeds its addressable part of a global array.  ``state()``
and ``set_cursor`` count global batches, so a checkpoint resumes on any
rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from upflow_pytorch_tpu_torch.parallel.mesh import batch_rows


def _stack_batch(items):
    if isinstance(items[0], dict):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def _stack_pinned(arrays) -> torch.Tensor:
    """``np.stack(arrays)`` written straight into a pinned host tensor."""
    first = torch.from_numpy(np.ascontiguousarray(arrays[0]))
    out = torch.empty((len(arrays),) + tuple(first.shape), dtype=first.dtype,
                      pin_memory=True)
    np.stack(arrays, out=out.numpy())
    return out


def _tensors(batch):
    return list(batch.values()) if isinstance(batch, dict) else [batch]


class DataLoader:
    """Epoch-shuffled, thread-decoded, device-prefetched batch loader."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, device=None, epoch: int = 0,
                 position: int = 0,
                 post_fn: Optional[Callable[[Dict[str, np.ndarray]],
                                            Any]] = None,
                 shard: Tuple[int, int] = (0, 1)):
        self._rows = batch_rows(batch_size, *shard)
        if shard[1] > 1 and not drop_last:
            raise ValueError("a sharded loader drops the last partial "
                             "batch (drop_last=True)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.post_fn = post_fn
        self.epoch = epoch
        self.position = position  # producer: next batch index to decode
        # consumed cursor: the (epoch, position) to resume from, the first
        # batch the training loop has not received.  The producer runs up
        # to prefetch + 1 batches ahead, so its counter would skip batches.
        self._resume_epoch = epoch
        self._resume_position = position
        self._pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._copy_stream = None

    # --- iteration state (for checkpoint/resume) ---
    def state(self) -> Dict[str, int]:
        """Cursor of the next batch the consumer will see; a loader built
        with these values resumes right after the last batch ``__next__``
        returned (stateless augmentation included)."""
        return {"epoch": self._resume_epoch,
                "position": self._resume_position,
                "seed": self.seed}

    def set_cursor(self, epoch: int, position: int):
        """Repositions the loader before iteration starts (resume)."""
        if self._thread is not None:
            raise RuntimeError("set_cursor must come before iterating")
        self.epoch = int(epoch)
        self.position = int(position)
        self._resume_epoch = int(epoch)
        self._resume_position = int(position)

    def _n_batches(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState((self.seed * 100003 + epoch) % (2 ** 31)
                                  ).shuffle(order)
        return order

    def _get_item(self, epoch: int, index: int):
        item_fn = getattr(self.dataset, "item", None)
        if item_fn is not None:
            return item_fn(int(index), epoch=epoch)
        return self.dataset[int(index)]

    def _to_device(self, items):
        """The stacked batch on ``self.device`` and the event its copy
        recorded (None when nothing was copied asynchronously)."""
        on_card = self.device.type == "cuda"
        stack = (_stack_pinned if on_card
                 else lambda arrays: torch.from_numpy(np.stack(arrays)))
        if isinstance(items[0], dict):
            host = {k: stack([it[k] for it in items]) for k in items[0]}
        else:
            host = stack(items)
        if not on_card:
            return host, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            if isinstance(host, dict):
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in host.items()}
            else:
                batch = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return batch, event

    def _put(self, item) -> bool:
        """Queue put that stays responsive to close(); returns False when
        stopping (a blocked ``put`` into a full queue would otherwise leak
        the producer thread)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            self._produce_batches()
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)

    def _produce_batches(self):
        while not self._stop.is_set():
            order = self._epoch_order(self.epoch)
            n_batches = self._n_batches()
            while self.position < n_batches:
                if self._stop.is_set():
                    return
                epoch, pos = self.epoch, self.position
                lo = pos * self.batch_size
                idx = order[lo:lo + self.batch_size][self._rows]
                items = list(self._pool.map(
                    lambda i: self._get_item(epoch, i), idx))
                event = None
                if self.post_fn is not None:
                    batch = self.post_fn(_stack_batch(items))
                elif self.device is not None:
                    batch, event = self._to_device(items)
                else:
                    batch = _stack_batch(items)
                if not self._put((epoch, pos, batch, event)):
                    return
                self.position += 1
            self.epoch += 1
            self.position = 0

    def __iter__(self) -> Iterator:
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        if self._thread is None:
            iter(self)
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        epoch, pos, batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(stream)
        if pos + 1 < self._n_batches():
            self._resume_epoch, self._resume_position = epoch, pos + 1
        else:
            self._resume_epoch, self._resume_position = epoch + 1, 0
        return batch

    def close(self):
        self._stop.set()
        # drain until the producer exits: it may be blocked mid-put
        thread = self._thread
        while thread is not None and thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
        self._pool.shutdown(wait=False)
