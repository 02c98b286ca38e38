"""Host input pipeline (port of the TPU package's data/pipeline.py).

- `load_volume`: decode one NIfTI volume, with the native C++ decoder
  (utils/native_loader.py, built with g++ at first use) whenever it
  builds, and per volume with the pure-Python reader where the file's
  encoding is one the native decoder does not cover (not 3-D, an unknown
  datatype). ``MAD_NO_NATIVE_IO=1`` forces the Python reader. Both give
  the same bits;
- `VolumeBatcher`: batches of decoded volumes (one modality or several,
  with an optional per-subject table vector), decoded by a thread pool one
  batch ahead of the consumer. A ragged last batch is padded to the static
  size with real rows cycled from the order, and `mask` marks the real
  rows, so every forward sees one shape. `VolumeBatcher.reads` counts the
  decodes of every batcher by reader ("native", "python", or "custom" for
  a loader of the caller's);
- `device_prefetch`: in place of the TPU package's mesh `device_put`
  loop, a thread copies each batch's arrays into pinned host memory and
  uploads them on a side CUDA stream, `depth` batches ahead; the consumer's
  stream waits on each batch's upload event. An error raised while
  producing a batch is re-raised in the consumer.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel.mesh import local_rows
from ..utils import native_loader, nifti


def read_volume(path: str, native: bool | None = None) -> tuple[np.ndarray, str]:
    """Decode one NIfTI volume as float32 [x, y, z] (the path with or
    without a trailing '.gz'); returns (volume, reader), reader "native" or
    "python". `native=None` decodes natively unless ``MAD_NO_NATIVE_IO=1``
    is set or the decoder did not build; a file in an encoding the native
    decoder does not cover falls back to the Python reader, a broken file
    raises."""
    actual = nifti.exists_with_ext(path) or path
    if native is None:
        native = os.environ.get("MAD_NO_NATIVE_IO", "0") != "1"
    if native and native_loader.available():
        try:
            return native_loader.load_volume_native(actual), "native"
        except native_loader.UnsupportedEncoding:
            pass
    return nifti.load(actual), "python"


def load_volume(path: str) -> np.ndarray:
    """Decode one NIfTI volume as float32 [x, y, z] (see `read_volume`)."""
    return read_volume(path)[0]


class VolumeBatcher:
    """Iterates records ({'MRI': path, 'label', 'Subject'}, plus a path per
    further key of `image_keys`) in order, in batches of decoded volumes.

    Yields host dicts {'image': (B, X, Y, Z, 1) f32 raw intensities,
    'label': (B,) i32, 'mask': (B,) f32, 'subject': list[str]} with B padded
    to `batch_size` (`mask` marks the real rows, which come first, and
    `subject` names only them); `drop_remainder` drops a ragged last batch
    instead. The first of `image_keys` is 'image'; each
    further one (e.g. "PET") is one more (B, X, Y, Z, 1) entry under its
    lowercase name ('pet'). With `table_lookup` ({subject: vector}) each
    batch also holds 'table', the rows' vectors stacked as float32.
    Normalization runs on the device, per modality. With `shuffle`, each
    epoch's order is ``np.random.default_rng((seed, epoch))``'s shuffle
    (epoch counts the iterations started), as in the TPU package. With a
    `transform` (data/transforms.py), each batch also holds 'plan': the
    host entry of one `AugmentPlan` a row, drawn for the row's position in
    `records` and the epoch (a padding row repeats its source's); the
    device applies it to every modality of the row after normalizing, as
    the TPU package draws one plan per (row, epoch) for each."""

    # decodes of every batcher in the process, by reader
    reads = {"native": 0, "python": 0, "custom": 0}
    _reads_lock = threading.Lock()

    def __init__(self, records, batch_size: int = 8, num_threads: int = 8,
                 loader=load_volume, shuffle: bool = False, seed: int = 0,
                 transform=None, image_keys=("MRI",), table_lookup=None,
                 drop_remainder: bool = False):
        self.records = list(records)
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.loader = loader
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.image_keys = tuple(image_keys)
        self.table_lookup = table_lookup
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self):
        if self.drop_remainder:
            return len(self.records) // self.batch_size
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    def _decode(self, rec):
        vols, readers = [], []
        for key in self.image_keys:
            if self.loader is load_volume:
                vol, reader = read_volume(rec[key])
            else:
                vol, reader = self.loader(rec[key]), "custom"
            vols.append(vol[..., None])
            readers.append(reader)
        return vols, rec["label"], rec["Subject"], readers

    def _chunks(self):
        """(indices, n_real) per batch of the next epoch's order; a ragged
        last batch is dropped with `drop_remainder`, else padded with real
        samples cycled from the order, so BatchNorm batch statistics see
        real voxels and the mask keeps them out of the results."""
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
                if self.drop_remainder:
                    continue
                pad = bs - n_real
                extra = np.concatenate([order] * (pad // len(order) + 1))[:pad]
                chunk = np.concatenate([chunk, extra])
            chunks.append((chunk, n_real))
        return chunks

    def __iter__(self):
        epoch = self._epoch
        chunks = self._chunks()
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            def submit(chunk):
                return [pool.submit(self._decode, self.records[i]) for i in chunk]

            pending = submit(chunks[0][0]) if chunks else None
            for ci, (chunk, n_real) in enumerate(chunks):
                futures = pending  # decode the next batch while this one is used
                pending = submit(chunks[ci + 1][0]) if ci + 1 < len(chunks) else None
                vols, labels, subjects, readers = zip(*(f.result() for f in futures))
                with self._reads_lock:
                    for row in readers:
                        for reader in row:
                            self.reads[reader] += 1
                mask = np.ones((len(vols),), np.float32)
                mask[n_real:] = 0.0
                batch = {"image": np.stack([v[0] for v in vols]).astype(np.float32)}
                for ki, key in enumerate(self.image_keys[1:], 1):
                    batch[key.lower()] = np.stack([v[ki] for v in vols]).astype(np.float32)
                if self.table_lookup is not None:
                    batch["table"] = np.stack([np.asarray(self.table_lookup[s], np.float32)
                                               for s in subjects])
                batch.update(label=np.asarray(labels, np.int32), mask=mask,
                             subject=list(subjects[:n_real]))
                if self.transform is not None:
                    batch["plan"] = [self.transform.plan(int(i), epoch) for i in chunk]
                yield batch


def device_prefetch(iterator, device, depth: int = 2, mesh=None):
    """Yield the batches of `iterator` with every ndarray entry as a tensor
    on `device`; other entries (subject ids) pass through. Under a `mesh`
    (parallel/mesh.py) only this rank's contiguous rows of each ndarray and
    of the per-row 'plan' list are uploaded; 'subject' still names the
    global batch's real rows. The batch size must divide by the mesh's
    size.

    A producer thread runs `iterator`. On CUDA it copies each array into
    pinned memory and uploads it on a side stream, records an event, and
    stays at most `depth` batches ahead; the consumer's current stream
    waits on that event before the batch is yielded (no host sync). On the
    CPU the arrays become tensors without a copy. An exception raised by
    `iterator` is re-raised here; closing this generator stops the
    producer."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def shard(batch):
        if mesh is None:
            return batch
        rows = local_rows(len(batch["mask"]), mesh)
        return {k: v[rows] if isinstance(v, np.ndarray) or k == "plan" else v
                for k, v in batch.items()}
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
                if not put(upload(shard(batch))):
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
