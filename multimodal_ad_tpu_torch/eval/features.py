"""Feature extraction (port of the TPU package's eval/features.py): U-Net
voxel + atlas-ROI features, and ResNet encoder embeddings.

`extract_unet_features` forwards the records through a UNet3D and writes
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

`extract_encoder_features` forwards the records through a ResNet encoder
(head 'none': the layer4 map, or 'pool': its global average) in float32
and writes adni_features.csv (Subject_ID, f0.., label; each row the
sample's output flattened channels-last, as the TPU package's
channels-last model flattens it) and feature_map_shapes.csv (the four
stage taps' (B, X, Y, Z, C) shapes, B the padded batch). Input as above:
uploaded raw, normalized on the device (K1 for `scale_intensity`), cuDNN
held to deterministic heuristic algorithms.

Under a mesh (parallel/mesh.py; by default `make_mesh({"data": -1})` when
a process group is initialized, as in the TPU package) each rank uploads,
normalizes (K1), forwards and pools (K2) its contiguous rows of every
batch; the rows are assembled on the device in global order
(`gather_rows`) and the mesh's first rank alone writes the CSVs, whose
rows and order are the single process's. The batch size must divide by
the mesh's data axes (a 'space' axis replicates the rows over its ranks).
"""

from __future__ import annotations

import contextlib
import csv
import os

import torch

from ..core.device import resolve_device
from ..data.pipeline import VolumeBatcher, device_prefetch, load_volume
from ..models.resnet3d import ResNet3D
from ..models.unet3d import UNet3D
from ..ops.normalize import NORMALIZERS
from ..ops.roi_pool import RoiAtlas, roi_pool
from ..parallel import mesh as pmesh


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
                          device: str | torch.device = "cuda", mesh=None):
    """Run the U-Net over `records` ({'MRI': path, 'label', 'Subject'}),
    write features.csv + roi_features.csv into `out_dir`, and return their
    paths (None on a rank outside the mesh).

    `atlas_labels` is the (X, Y, Z) label volume with ROI ids
    1..len(roi_names) on the volumes' grid. `model` carries its weights; by
    default it is an untrained UNet3D drawn from a generator seeded with
    `seed`, as the reference extracts with an untrained network."""
    dev = resolve_device(device)
    if normalizer not in NORMALIZERS:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    mesh, main = pmesh.resolve_mesh(mesh, {"data": -1}, batch_size)
    if main is None:
        return None
    normalize = NORMALIZERS[normalizer]
    if model is None:
        model = UNet3D(in_channels=1, num_classes=1,
                       generator=torch.Generator().manual_seed(seed))
    model = model.eval().requires_grad_(False).to(dev)
    num_rois = len(roi_names)
    atlas = RoiAtlas.build(atlas_labels, num_rois, dev)
    batcher = VolumeBatcher(records, batch_size=batch_size,
                            num_threads=num_threads, loader=loader)

    feat_path = os.path.join(out_dir, "features.csv")
    roi_path = os.path.join(out_dir, "roi_features.csv")
    with _writers(main, out_dir, feat_path, roi_path) as (fw, rw), deterministic_cudnn():
        wrote_headers = False
        for batch in device_prefetch(iter(batcher), dev, depth=2, mesh=mesh):
            subjects = batch["subject"]  # the real rows, which come first
            with torch.inference_mode():
                out, feats = model(normalize(batch["image"]), return_features=True)
                roi = pmesh.gather_rows(roi_pool(feats, atlas, num_rois), mesh)  # (B, R, C)
                flat = pmesh.gather_rows(out.reshape(out.shape[0], -1), mesh)
                roi, flat = roi.cpu().numpy(), flat.cpu().numpy()
            if not main:
                continue
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
    pmesh.barrier(mesh, dev)  # the CSVs are complete on every rank's return
    return feat_path, roi_path


@contextlib.contextmanager
def _writers(main: bool, out_dir: str, *paths):
    """csv writers of `paths` (opened for writing, `out_dir` created) on the
    writing rank; Nones on the others."""
    if not main:
        yield (None,) * len(paths)
        return
    os.makedirs(out_dir, exist_ok=True)
    with contextlib.ExitStack() as stack:
        yield tuple(csv.writer(stack.enter_context(open(p, "w", newline="")))
                    for p in paths)


def extract_encoder_features(records, out_dir, depth: int = 18,
                             global_pool: bool = False, model: ResNet3D | None = None,
                             batch_size: int = 4, loader=load_volume,
                             num_threads: int = 8, seed: int = 0,
                             normalizer: str = "scale_intensity",
                             device: str | torch.device = "cuda", mesh=None):
    """ResNet encoder features of `records` ({'MRI': path, 'label',
    'Subject'}) -> adni_features.csv + feature_map_shapes.csv in `out_dir`;
    returns their paths (None on a rank outside the mesh).

    `model` carries its weights (its head 'none' or 'pool' decides the
    row); by default it is an eval-mode float32 ResNet `depth` with head
    'pool' if `global_pool` else 'none', its weights drawn from a
    generator seeded with `seed`, as the reference extracts with an
    untrained encoder."""
    dev = resolve_device(device)
    if normalizer not in NORMALIZERS:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    mesh, main = pmesh.resolve_mesh(mesh, {"data": -1}, batch_size)
    if main is None:
        return None
    normalize = NORMALIZERS[normalizer]
    if model is None:
        model = ResNet3D(depth=depth, head="pool" if global_pool else "none",
                         compute_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    if model.head not in ("none", "pool"):
        raise ValueError(f"encoder features need head 'none' or 'pool', not {model.head!r}")
    model = model.eval().requires_grad_(False).to(dev)
    batcher = VolumeBatcher(records, batch_size=batch_size, num_threads=num_threads,
                            loader=loader)

    feat_path = os.path.join(out_dir, "adni_features.csv")
    shape_path = os.path.join(out_dir, "feature_map_shapes.csv")
    shape_rows = []
    w = pmesh.data_size(mesh)
    with _writers(main, out_dir, feat_path) as (fw,), deterministic_cudnn():
        wrote_header = False
        for batch in device_prefetch(iter(batcher), dev, depth=2, mesh=mesh):
            subjects = batch["subject"]  # the real rows, which come first
            with torch.inference_mode():
                out, taps = model(normalize(batch["image"]), return_taps=True)
                flat = pmesh.gather_rows(out.float().reshape(out.shape[0], -1), mesh)
                flat = flat.cpu().numpy()
            labels = pmesh.gather_rows(batch["label"], mesh).cpu().numpy()
            if not main:
                continue
            if not wrote_header:
                fw.writerow(["Subject_ID"] + [f"f{i}" for i in range(flat.shape[1])]
                            + ["label"])
                # the global batch's shapes: B counts every rank's rows
                shape_rows = [("stage_out", (w * int(t.shape[0]),)
                               + tuple(int(d) for d in t.shape[1:])) for t in taps]
                wrote_header = True
            for i, sid in enumerate(subjects):
                fw.writerow([sid] + flat[i].tolist() + [int(labels[i])])

    if main:
        with open(shape_path, "w", newline="") as sf:
            sw = csv.writer(sf)
            sw.writerow(["module", "output_shape"])
            for name, shape in shape_rows:
                sw.writerow([name, str(shape)])
    pmesh.barrier(mesh, dev)
    return feat_path, shape_path
