"""U-Net voxel + atlas-ROI feature extraction (port of the TPU package's
eval/features.py::extract_unet_features).

Forwards the records through a UNet3D and writes
- features.csv:     Subject_ID, f0..f{X*Y*Z-1} (the flattened 1-channel output),
- roi_features.csv: Subject_ID, {ROIname}_c{ch} (ROI means of the 64-channel
  pre-head map), ROI-major; `reference_bug_compat=True` writes each row
  channel-major instead, as the reference does under its ROI-major header.

Each batch is uploaded raw (pinned, on a side stream, two batches ahead),
normalized on the device (K1 for `scale_intensity`), forwarded in float32
(TF32 off), and pooled by K2 (ops/roi_pool.py) over an atlas prepared once;
only the output map and the (B, R, C) means come back to the host. The
path holds cuDNN to deterministic algorithms while it runs
(`deterministic_cudnn`), so the CSVs are byte-identical from run to run
on one machine.

`extract_encoder_features` (ResNet encoder embeddings) is not ported yet.
"""

from __future__ import annotations

import contextlib
import csv
import os

import torch

from ..core.device import resolve_device
from ..data.pipeline import VolumeBatcher, device_prefetch, load_volume
from ..models.unet3d import UNet3D
from ..ops.normalize import NORMALIZERS
from ..ops.roi_pool import RoiAtlas, roi_pool


@contextlib.contextmanager
def deterministic_cudnn():
    """For the duration: cuDNN restricted to deterministic algorithms (a
    transposed conv runs as a backward-data convolution, some of whose
    algorithms add with atomics) and chosen by its heuristics rather than
    by benchmarking, so the choice, and with it the order of every sum,
    does not depend on a timing race: the CSVs are the same bytes in every
    process. Benchmarking the full-width float32 3-D convolutions would
    also cost minutes on the first batch (PERF.md)."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def extract_unet_features(records, atlas_labels, roi_names, out_dir,
                          model: UNet3D | None = None, batch_size: int = 4,
                          loader=load_volume, num_threads: int = 8, seed: int = 0,
                          reference_bug_compat: bool = False,
                          normalizer: str = "scale_intensity",
                          device: str | torch.device = "cuda"):
    """Run the U-Net over `records` ({'MRI': path, 'label', 'Subject'}),
    write features.csv + roi_features.csv into `out_dir`, and return their
    paths.

    `atlas_labels` is the (X, Y, Z) label volume with ROI ids
    1..len(roi_names) on the volumes' grid. `model` carries its weights; by
    default it is an untrained UNet3D drawn from a generator seeded with
    `seed`, as the reference extracts with an untrained network."""
    dev = resolve_device(device)
    if normalizer not in NORMALIZERS:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    normalize = NORMALIZERS[normalizer]
    if model is None:
        model = UNet3D(in_channels=1, num_classes=1,
                       generator=torch.Generator().manual_seed(seed))
    model = model.eval().requires_grad_(False).to(dev)
    num_rois = len(roi_names)
    atlas = RoiAtlas.build(atlas_labels, num_rois, dev)
    batcher = VolumeBatcher(records, batch_size=batch_size,
                            num_threads=num_threads, loader=loader)

    os.makedirs(out_dir, exist_ok=True)
    feat_path = os.path.join(out_dir, "features.csv")
    roi_path = os.path.join(out_dir, "roi_features.csv")
    with open(feat_path, "w", newline="") as ff, \
            open(roi_path, "w", newline="") as rf, deterministic_cudnn():
        fw, rw = csv.writer(ff), csv.writer(rf)
        wrote_headers = False
        for batch in device_prefetch(iter(batcher), dev, depth=2):
            subjects = batch["subject"]  # the real rows, which come first
            with torch.inference_mode():
                out, feats = model(normalize(batch["image"]), return_features=True)
                roi = roi_pool(feats, atlas, num_rois).cpu().numpy()  # (B, R, C)
                flat = out.reshape(out.shape[0], -1).cpu().numpy()
            n_ch = roi.shape[-1]
            if not wrote_headers:
                fw.writerow(["Subject_ID"] + [f"f{i}" for i in range(flat.shape[1])])
                rw.writerow(["Subject_ID"] + [f"{name}_c{c}" for name in roi_names
                                              for c in range(n_ch)])
                wrote_headers = True
            if reference_bug_compat:
                rows = roi.transpose(0, 2, 1).reshape(roi.shape[0], -1)
            else:
                rows = roi.reshape(roi.shape[0], -1)
            for i, sid in enumerate(subjects):
                fw.writerow([sid] + flat[i].tolist())
                rw.writerow([sid] + rows[i].tolist())
    return feat_path, roi_path
