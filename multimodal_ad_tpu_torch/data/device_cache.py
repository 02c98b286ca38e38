"""Device-resident dataset cache (port of the TPU package's
data/device_cache.py, serving half).

The whole preprocessed ADNI corpus is small for an 80 GB card (~900
volumes x 91x109x91 uint8 ~= 0.8 GB), so the corpus is uploaded once and
batches are sampled on the device: gather by index, then the per-volume
min-max normalize of K1 (ops/fused_gather.py), one fused pass. The host
sends only index vectors.

`DeviceEpochIterator` walks a subset of the store once per epoch for the
training path: a per-epoch shuffle, K1 (or `adaptive_normal`) and, for
training, augmentation on the device (ops/augment.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.augment import augment_batch
from ..ops.fused_gather import _as_indices, gather_normalize
from ..ops.normalize import NORMALIZERS


def quantize_uint8(volumes: np.ndarray) -> np.ndarray:
    """Per-volume affine map to uint8 [0, 255] (chunked, O(1) temp memory).

    Min-max normalization is invariant under a positive-scale affine map of
    the voxels, so storing the quantized volume changes the normalized
    batch only by the <= 1/255 rounding, at a quarter of float32's bytes."""
    if volumes.ndim != 5:
        raise ValueError(f"expect (N, X, Y, Z, C), got shape {volumes.shape}")
    out = np.empty(volumes.shape, np.uint8)
    for i in range(volumes.shape[0]):
        v = volumes[i].astype(np.float32)
        mn, mx = float(v.min()), float(v.max())
        if mx - mn < 1e-12:
            out[i] = 0
        else:
            np.rint((v - mn) * (255.0 / (mx - mn)), out=v)
            out[i] = v.astype(np.uint8)
    return out


# the TPU package runs without 64-bit types; its device arrays are 32-bit
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


class DeviceDataset:
    """Device-resident (N, X, Y, Z, C) voxel store + (N,) int32 labels.

    Volumes keep their dtype (int16 or uint8 quarter or halve the upload
    and the device footprint of float32; ``quantize="uint8"`` applies
    `quantize_uint8`). `gather_normalized` runs K1 whatever the store dtype
    K1 takes (uint8, int16, float32). ``fused_norm=True`` stores non-integer
    volumes as int16, as the TPU package's fused store does; the normalize
    path is the same either way."""

    def __init__(self, volumes: np.ndarray, labels: np.ndarray,
                 device: str | torch.device = "cuda", store_dtype=None,
                 fused_norm: bool = False, quantize: str | None = None):
        if volumes.ndim != 5:
            raise ValueError(f"expect (N, X, Y, Z, C), got shape {volumes.shape}")
        self.device = resolve_device(device)
        if store_dtype is not None:
            volumes = volumes.astype(store_dtype)
        if quantize is not None:
            if quantize != "uint8":
                raise ValueError(f"unknown quantize={quantize!r}")
            if fused_norm:
                raise ValueError("quantize composes with the default "
                                 "gather path, not the fused_norm store")
            volumes = quantize_uint8(volumes)
        if fused_norm and not np.issubdtype(volumes.dtype, np.integer):
            volumes = volumes.astype(np.int16)
        volumes = volumes.astype(_NARROW.get(volumes.dtype, volumes.dtype),
                                 copy=False)
        self.n = volumes.shape[0]
        self.vol_shape = volumes.shape[1:]
        self.volumes = torch.empty(volumes.shape,
                                   dtype=torch.from_numpy(volumes[:0]).dtype,
                                   device=self.device)
        # chunked upload: bounded host staging for big corpora
        step = max(1, int(256e6 // max(volumes[0].nbytes, 1)))
        for i in range(0, self.n, step):
            self.volumes[i:i + step].copy_(
                torch.from_numpy(np.ascontiguousarray(volumes[i:i + step])))
        self.labels = torch.from_numpy(
            np.asarray(labels, np.int32)).to(self.device)

    def _batch(self, idx: torch.Tensor, image: torch.Tensor) -> dict:
        return {
            "image": image,
            "label": self.labels.index_select(0, idx),
            "mask": torch.ones(idx.shape, dtype=torch.float32,
                               device=self.device),
        }

    def gather(self, indices) -> dict:
        """Device-side batch gather of the raw stored voxels."""
        idx = _as_indices(indices, self.n).to(self.device)
        return self._batch(idx, self.volumes.index_select(0, idx))

    def gather_normalized(self, indices, out_dtype=torch.float32) -> dict:
        """Fused gather + per-volume min-max normalize: one K1 launch on a
        card. Returns the same dict as `gather` with "image" normalized."""
        idx = _as_indices(indices, self.n).to(self.device)  # checked on the host
        return self._batch(idx, gather_normalize(self.volumes, idx, out_dtype))

    def epoch_indices(self, rng: np.random.Generator, batch_size: int,
                      shuffle: bool = True, drop_remainder: bool = True):
        """Host-side index plan for one epoch (tiny transfers)."""
        order = np.arange(self.n)
        if shuffle:
            rng.shuffle(order)
        nb = self.n // batch_size if drop_remainder else -(-self.n // batch_size)
        for i in range(nb):
            chunk = order[i * batch_size:(i + 1) * batch_size]
            if len(chunk) < batch_size:
                chunk = np.concatenate(
                    [chunk, order[: batch_size - len(chunk)]])
            yield chunk.astype(np.int32)


class DeviceEpochIterator:
    """Epoch iterator over a device-resident dataset subset.

    Yields device batches {'image': (B, X, Y, Z, C) float32 normalized,
    'label': (B,) int32, 'mask': (B,) float32, 'subject': names of the real
    rows}. Each epoch's order is ``np.random.default_rng((seed, epoch))``'s
    shuffle of `indices` (epoch counts the iterations started), as in the
    TPU package. A ragged last batch is padded with real rows cycled from
    the epoch order and the mask marks them (repeating one row would bias
    BatchNorm's batch statistics). ``normalizer="scale_intensity"`` gathers
    and normalizes in one K1 launch (`DeviceDataset.gather_normalized`);
    ``"adaptive_normal"`` gathers, then normalizes with ops/normalize.py.
    With `augment`, `augment_batch` follows, its draws from a host
    generator seeded with `seed`. The host sends only index vectors."""

    device_resident = True

    def __init__(self, dataset: DeviceDataset, indices, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 normalizer: str = "scale_intensity", subjects=None,
                 augment: bool = False, flip_prob: float = 0.3,
                 rotate_prob: float = 0.3, zoom_prob: float = 0.3,
                 scale_prob: float = 0.0):
        if normalizer not in NORMALIZERS:
            raise ValueError(f"unknown normalizer {normalizer!r}")
        self.ds = dataset
        self.indices = np.asarray(indices, np.int64)
        _as_indices(self.indices, dataset.n)  # range-checked once, here
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.normalizer = normalizer
        self.subjects = subjects
        self.augment = augment
        self.aug_kw = dict(flip_prob=flip_prob, rotate_prob=rotate_prob,
                           zoom_prob=zoom_prob, scale_prob=scale_prob)
        self.generator = torch.Generator().manual_seed(seed)
        self._epoch = 0

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def _upload(self, chunk: np.ndarray) -> torch.Tensor:
        # a few bytes: an asynchronous copy returns once they are staged,
        # without waiting for the card
        return torch.from_numpy(chunk).to(self.ds.device, non_blocking=True)

    def _batch(self, chunk: np.ndarray) -> dict:
        idx = self._upload(chunk)
        if self.normalizer == "scale_intensity":
            batch = self.ds.gather_normalized(idx)  # K1
        else:
            batch = self.ds.gather(idx)
            batch["image"] = NORMALIZERS[self.normalizer](batch["image"])
        if self.augment:
            batch["image"] = augment_batch(batch["image"], self.generator,
                                           **self.aug_kw)
        return batch

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for i in range(0, len(order), bs):
            chunk = order[i:i + bs]
            n_real = len(chunk)
            if n_real < bs:
                pad = bs - n_real
                extra = np.concatenate(
                    [order] * (pad // max(len(order), 1) + 1))[:pad]
                chunk = np.concatenate([chunk, extra])
            batch = self._batch(chunk)
            batch["mask"] = (torch.arange(bs, device=self.ds.device)
                             < n_real).to(torch.float32)
            real = chunk[:n_real]
            batch["subject"] = ([self.subjects[j] for j in real]
                                if self.subjects is not None else
                                [str(j) for j in real])
            yield batch


def build_device_dataset(records, device: str | torch.device = "cuda",
                         loader=None, transform=None, store_dtype=np.int16,
                         num_threads: int = 8, quantize: str | None = None):
    """Decode a manifest's volumes once on the host and upload them.

    `transform` (optional) runs per volume on the host before upload."""
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline import load_volume

    dev = resolve_device(device)  # fail before decoding anything
    loader = loader or load_volume

    def decode(rec):
        vol = loader(rec["MRI"])
        if transform is not None:
            vol = transform(vol)
        if vol.ndim == 3:
            vol = vol[..., None]
        return vol

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        vols = list(pool.map(decode, records))
    volumes = np.stack(vols)
    labels = np.asarray([r["label"] for r in records], np.int32)
    return DeviceDataset(volumes, labels, device=dev, store_dtype=store_dtype,
                         quantize=quantize)
