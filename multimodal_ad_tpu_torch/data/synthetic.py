"""Seeded synthetic ADNI-like volumes and clinical tables for tests and
chip_smoke.py (own copy of the TPU package's data/synthetic.py:21-110).

The label CSV and the table are written with the csv module, so no path
needs pandas.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..utils import nifti


def make_volume(rng: np.random.Generator, shape=(91, 109, 91), label: int = 0,
                extent_jitter: float = 0.0, center_jitter: float = 0.0,
                noise: float = 0.05):
    """Structured random volume: a smooth blob whose intensity/extent
    depends weakly on the class label, plus voxel noise.

    With the default jitters of 0 every volume of a class is identical up
    to voxel noise; `extent_jitter` / `center_jitter` add per-sample
    variation. Draws from `rng` in the same order as the TPU package, so
    one seed gives the same volume in both."""
    coords = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape],
                         indexing="ij")
    if center_jitter:
        shifts = rng.normal(0, center_jitter, size=3)
        coords = [c - s for c, s in zip(coords, shifts)]
    r2 = sum(c ** 2 for c in coords)
    extent = 3.0 + 0.8 * label
    if extent_jitter:
        extent += rng.normal(0, extent_jitter)
    base = np.exp(-r2 * extent).astype(np.float32)
    vnoise = rng.normal(0, noise, shape).astype(np.float32)
    return (base * (200.0 + 40.0 * label) + vnoise * 20.0).astype(np.float32)


def make_adni_dir(root: str, n_per_class=4, classes=("AD", "CN"),
                  shape=(24, 28, 24), seed: int = 0, gz: bool = False,
                  pet: bool = False, **volume_kw):
    """Write a miniature ADNI dataset: label CSV + per-subject NIfTI files.
    Returns (label_csv_path, mri_dir) or (csv, mri_dir, pet_dir) with
    pet=True. Extra kwargs pass through to make_volume."""
    rng = np.random.default_rng(seed)
    mri_dir = os.path.join(root, "MRI")
    os.makedirs(mri_dir, exist_ok=True)
    pet_dir = os.path.join(root, "PET")
    if pet:
        os.makedirs(pet_dir, exist_ok=True)
    rows = []
    ext = ".nii.gz" if gz else ".nii"
    for ci, group in enumerate(classes):
        for k in range(n_per_class):
            subject = f"{group}_{k:03d}"
            vol = make_volume(rng, shape, label=ci, **volume_kw)
            nifti.save(os.path.join(mri_dir, subject + ext), vol)
            if pet:
                pvol = make_volume(rng, shape, label=ci, **volume_kw) * 0.5
                nifti.save(os.path.join(pet_dir, subject + ext), pvol)
            rows.append((subject, group))
    csv_path = os.path.join(root, "labels.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Subject_ID", "Group"])
        w.writerows(rows)
    if pet:
        return csv_path, mri_dir, pet_dir
    return csv_path, mri_dir


def make_atlas(shape=(24, 28, 24), n_rois: int = 6, seed: int = 0):
    """Random contiguous-ish ROI label volume with ids 1..n_rois (0 = bg):
    each voxel takes the id of its nearest random centre, and voxels
    farther than 0.55 from the grid's centre are background.

    The TPU package builds the whole (X, Y, Z, R) distance array at once
    (1.8 GB at 91x109x91 with 166 ROIs); this takes the same float64
    distances and argmin one x-slab at a time, so the labels are
    identical and the memory is one slab's."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.15, 0.85, size=(n_rois, 3))
    axes = [np.linspace(0, 1, s, dtype=np.float32) for s in shape]
    gy, gz = np.meshgrid(axes[1], axes[2], indexing="ij")
    labels = np.empty(tuple(shape), np.int32)
    for i, x in enumerate(axes[0]):
        pts = np.stack([np.full_like(gy, x), gy, gz], -1)  # (Y, Z, 3)
        d = np.linalg.norm(pts[..., None, :] - centers[None, None], axis=-1)
        lab = np.argmin(d, axis=-1).astype(np.int32) + 1
        lab[np.linalg.norm(pts - 0.5, axis=-1) > 0.55] = 0
        labels[i] = lab
    return labels


def make_table(n: int = 120, n_features: int = 20,
               classes=("CN", "AD"), seed: int = 0,
               n_categorical: int = 3, start_pad_cols: int = 14,
               path: str | None = None):
    """Clinical-style table: `start_pad_cols` id/demographic filler
    columns, a 'Group' label column, then numeric+categorical features
    (features from column 14). Returns {column name: values} in the TPU
    package's DataFrame column order and from its draws, or, given `path`,
    writes it there as that DataFrame's ``to_csv(index=False)`` does and
    returns the path."""
    from .tabular import write_table

    rng = np.random.default_rng(seed)
    y = rng.integers(0, len(classes), n)
    data = {}
    data["Subject_ID"] = np.array([f"S{i:04d}" for i in range(n)], dtype=object)
    data["Group"] = np.array([classes[c] for c in y], dtype=object)
    for j in range(start_pad_cols - 2):
        data[f"meta{j}"] = rng.normal(size=n).round(3)
    for j in range(n_features - n_categorical):
        data[f"feat{j}"] = (rng.normal(size=n) + 0.8 * y).astype(np.float32)
    for j in range(n_categorical):
        data[f"cat{j}"] = rng.choice(["a", "b", "c"], size=n).astype(object)
    if path is None:
        return data
    return write_table(path, data)
