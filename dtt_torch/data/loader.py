"""Input pipeline: threaded decode -> transform -> batch, and the upload of
each batch to the card ahead of the step (counterpart of
``dtt.data.loader``).

``PairLoader`` is the reference's roibatchLoader + DataLoader workers
(lib/roi_data_layer/roibatchLoader.py): worker threads prepare the frame
pairs of a batch while the step runs. ``device_prefetch`` keeps the next
batches' host-to-device copies in flight on a CUDA stream of their own.
"""

from __future__ import annotations

import queue
import threading
from multiprocessing.pool import ThreadPool
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from dtt_torch.core.config import InputConfig
from dtt_torch.data.transforms import prepare_pair


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Queue `item` unless `stop` is set first; whether it was queued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class PairLoader:
    """Iterates shuffled roidb frame pairs as stacked numpy batch dicts.

    The index stream is ``dtt``'s: one ``RandomState(seed)``, a
    permutation per epoch, or with ``det_fraction`` a DET-or-VID draw per
    batch slot. Worker threads prepare a batch's pairs and ``map`` keeps
    their order, so a seed gives the same batches as ``dtt``'s loader.

    Data parallel: with ``world_size`` > 1, `batch_size` is the global
    batch and the loader of rank `rank` yields its rows [r*b, (r+1)*b) of
    each global batch the one-process loader yields at the same seed
    (``shard_batch``'s rows), preparing only those.
    """

    def __init__(self, roidb: Sequence[dict], cfg: InputConfig,
                 batch_size: int, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, prepare_fn: Callable | None = None,
                 drop_last: bool = True, loop: bool = True,
                 det_fraction: float | None = None, rank: int = 0,
                 world_size: int = 1):
        if not roidb:
            raise ValueError("empty roidb")
        if batch_size % world_size or not 0 <= rank < world_size:
            raise ValueError(f"a global batch of {batch_size} does not "
                             f"divide over {world_size} ranks (rank {rank})")
        local = batch_size // world_size
        self._rows = slice(rank * local, (rank + 1) * local)
        self.roidb = list(roidb)
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prepare_fn = prepare_fn or prepare_pair
        self.drop_last = drop_last
        self.loop = loop
        self._rng = np.random.RandomState(seed)
        self._stop = threading.Event()
        self._batch_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._started = False
        # DET:VID mixture (input.det_fraction; D&T paper §3.4): entries
        # whose source name contains "det" form the DET group, and each
        # batch slot draws from it with probability det_fraction. With
        # one group missing the knob does nothing.
        self.det_fraction = None
        if det_fraction is not None and det_fraction >= 0.0:
            det_set = {i for i, e in enumerate(self.roidb)
                       if "det" in str(e.get("source", "")).lower()}
            det = sorted(det_set)
            vid = [i for i in range(len(self.roidb)) if i not in det_set]
            if det and vid:
                self.det_fraction = float(det_fraction)
                self._groups = (np.asarray(vid), np.asarray(det))

    def _index_stream(self) -> Iterator[list[int]]:
        n = len(self.roidb)
        if self.det_fraction is not None:
            vid, det = self._groups
            batches_per_epoch = max(n // self.batch_size, 1)
            while True:
                for _ in range(batches_per_epoch):
                    pick_det = self._rng.rand(self.batch_size) < self.det_fraction
                    yield [int(det[self._rng.randint(len(det))]) if d
                           else int(vid[self._rng.randint(len(vid))])
                           for d in pick_det]
                if not self.loop:
                    return
        while True:
            order = self._rng.permutation(n)
            for i in range(0, n - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size):
                yield [int(j) for j in order[i:i + self.batch_size]]
            if not self.loop:
                return

    def _producer(self):
        try:
            for idx_batch in self._index_stream():
                if self._stop.is_set():
                    return
                samples = self._pool.map(
                    lambda i: self.prepare_fn(self.roidb[i], self.cfg),
                    idx_batch[self._rows])
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                if not _put(self._batch_q, batch, self._stop):
                    return
        except Exception as e:   # the consumer raises it
            _put(self._batch_q, e, self._stop)
        finally:
            _put(self._batch_q, None, self._stop)

    def start(self):
        if not self._started:
            self._pool = ThreadPool(self.num_workers)
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
            self._started = True
        return self

    def __iter__(self):
        self.start()
        while True:
            item = self._batch_q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self):
        self._stop.set()
        if self._started:
            try:
                while True:
                    self._batch_q.get_nowait()
            except queue.Empty:
                pass
            self._pool.terminate()
            try:                       # wake a consumer that waits
                self._batch_q.put_nowait(None)
            except queue.Full:
                pass
        self._started = False


def _upload(batch: dict, device: torch.device, stream, cast: dict | None
            ) -> tuple:
    """Copy one host batch to `device` on `stream`: each array as a pinned
    tensor (cast on the host first where `cast` names its key), copied
    without blocking. Returns the device batch and an event recorded after
    the copies."""
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            if cast and k in cast:
                t = t.to(cast[k])
            out[k] = t.pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def device_prefetch(iterator, device=None, size: int = 2,
                    cast: dict | None = None):
    """Upload the batches of `iterator` to a CUDA device ahead of their
    use, `size` batches in flight.

    A background thread pins each host batch, casts the keys `cast` names
    (``{"images": torch.bfloat16}`` is lossless for a bf16 model, whose
    first op is the same cast, and halves the bytes) and copies it with
    ``non_blocking=True`` on a CUDA stream of its own. Each yielded batch
    is safe on the consumer's current stream: that stream waits on an
    event recorded after the copies, and every tensor is marked as used
    by it (``record_stream``), so the caching allocator does not hand its
    memory to the copy stream while the consumer still reads it. An error
    in the iterator or the thread is raised to the consumer; closing the
    generator stops the thread at its next batch. Raises RuntimeError
    without a CUDA device; it never runs on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("device_prefetch copies batches to a CUDA device "
                           f"and none is available as {device}")
    return _prefetch(iterator, device, size, cast)


def _prefetch(iterator, device: torch.device, size: int, cast):
    copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def worker():
        try:
            with torch.cuda.device(device):
                for batch in iterator:
                    if not _put(q, _upload(batch, device, copy_stream, cast),
                                stop):
                        return
        except Exception as e:   # the consumer raises it
            _put(q, e, stop)
        finally:
            _put(q, end, stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            batch, done = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
