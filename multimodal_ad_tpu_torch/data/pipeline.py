"""Host input pipeline (port of the TPU package's data/pipeline.py).

- `load_volume`: decode one NIfTI volume with the pure-Python reader (the
  native C++ decoder comes with a later slice);
- `VolumeBatcher`: batches of decoded volumes, decoded by a thread pool one
  batch ahead of the consumer. A ragged last batch is padded to the static
  size with real rows cycled from the order, and `mask` marks the real
  rows, so every forward sees one shape;
- `device_prefetch`: in place of the TPU package's mesh `device_put`
  loop, a thread copies each batch's arrays into pinned host memory and
  uploads them on a side CUDA stream, `depth` batches ahead; the consumer's
  stream waits on each batch's upload event. An error raised while
  producing a batch is re-raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import nifti


def load_volume(path: str) -> np.ndarray:
    """Decode one NIfTI volume as float32 [x, y, z]; accepts the path with
    or without a trailing '.gz'."""
    return nifti.load(nifti.exists_with_ext(path) or path)


class VolumeBatcher:
    """Iterates records ({'MRI': path, 'label', 'Subject'}) in order, in
    batches of decoded volumes.

    Yields host dicts {'image': (B, X, Y, Z, 1) f32 raw intensities,
    'label': (B,) i32, 'mask': (B,) f32, 'subject': list[str]} with B padded
    to `batch_size` (`mask` marks the real rows, which come first, and
    `subject` names only them). Normalization runs on the device. With
    `shuffle`, each epoch's order is ``np.random.default_rng((seed,
    epoch))``'s shuffle (epoch counts the iterations started), as in the
    TPU package. Other modalities and host transforms (data/transforms.py)
    are not ported."""

    def __init__(self, records, batch_size: int = 8, num_threads: int = 8,
                 loader=load_volume, shuffle: bool = False, seed: int = 0):
        self.records = list(records)
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.loader = loader
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    def _decode(self, rec):
        return self.loader(rec["MRI"])[..., None], rec["label"], rec["Subject"]

    def _chunks(self):
        """(indices, n_real) per batch of the next epoch's order; a ragged
        last batch is padded with real samples cycled from the order, so
        BatchNorm batch statistics see real voxels and the mask keeps them
        out of the results."""
        order = np.arange(len(self.records))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        chunks = []
        for i in range(0, len(order), bs):
            chunk = order[i:i + bs]
            n_real = len(chunk)
            if n_real < bs:
                pad = bs - n_real
                extra = np.concatenate([order] * (pad // len(order) + 1))[:pad]
                chunk = np.concatenate([chunk, extra])
            chunks.append((chunk, n_real))
        return chunks

    def __iter__(self):
        chunks = self._chunks()
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            def submit(chunk):
                return [pool.submit(self._decode, self.records[i]) for i in chunk]

            pending = submit(chunks[0][0]) if chunks else None
            for ci, (_, n_real) in enumerate(chunks):
                futures = pending  # decode the next batch while this one is used
                pending = submit(chunks[ci + 1][0]) if ci + 1 < len(chunks) else None
                vols, labels, subjects = zip(*(f.result() for f in futures))
                mask = np.ones((len(vols),), np.float32)
                mask[n_real:] = 0.0
                yield {"image": np.stack(vols).astype(np.float32),
                       "label": np.asarray(labels, np.int32),
                       "mask": mask,
                       "subject": list(subjects[:n_real])}


def device_prefetch(iterator, device, depth: int = 2):
    """Yield the batches of `iterator` with every ndarray entry as a tensor
    on `device`; other entries (subject ids) pass through.

    A producer thread runs `iterator`. On CUDA it copies each array into
    pinned memory and uploads it on a side stream, records an event, and
    stays at most `depth` batches ahead; the consumer's current stream
    waits on that event before the batch is yielded (no host sync). On the
    CPU the arrays become tensors without a copy. An exception raised by
    `iterator` is re-raised here; closing this generator stops the
    producer."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def upload(batch):
        if stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    if isinstance(v, np.ndarray) else v for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(dev, non_blocking=True)
                   if isinstance(v, np.ndarray) else v for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def producer():
        try:
            for batch in iterator:
                if not put(upload(batch)):
                    return
            put((end, None))
        except Exception as e:  # handed to the consumer, which re-raises it
            put((e, None))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, name="device_prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item, ready = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            if ready is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)
                for v in item.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)  # allocated on the side stream
            yield item
    finally:
        stop.set()
        thread.join()
