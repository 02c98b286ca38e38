"""AAL atlas loading (own copy of the TPU package's eval/atlas.py:1-143).

- atlas NIfTI + LUT ingestion, with ROI ids ascending > 0 and names from
  the LUT, else 'ROI{id}';
- LUT schemas: the NeuroParc JSON ({"rois": {"<id>": {"label": name}}}),
  the AAL3 TSV `ROI_MNI_V7_vol.txt` (header `nom_c nom_l color ...`; id =
  color, name = nom_l) and the headerless `AAL3v1*.nii.txt` (`id name
  color` rows);
- nearest-neighbour resampling through world coordinates onto another grid
  (the 1-mm AAL3 atlas onto the 2-mm 91x109x91 MNI grid of the volumes);
- `compact_labels`: arbitrary ROI ids -> contiguous 1..R for pooling.

The ROI queries, the overlay PNG and the HTML viewer belong to the
visualisation CLI and are not ported yet.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils import nifti

# the 2-mm MNI152 grid of the ADNI volumes: world = affine @ [i, j, k, 1]
MNI152_2MM_SHAPE = (91, 109, 91)
MNI152_2MM_AFFINE = np.array([
    [-2.0, 0.0, 0.0, 90.0],
    [0.0, 2.0, 0.0, -126.0],
    [0.0, 0.0, 2.0, -72.0],
    [0.0, 0.0, 0.0, 1.0],
], np.float64)


def load_text_lut(path: str) -> dict:
    """Parse the AAL3 text LUTs -> {roi_id: name}. Auto-detects the
    `nom_c nom_l color ...` TSV against headerless `id name color` rows."""
    lut = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        return lut
    header = lines[0].split()
    if header[:3] == ["nom_c", "nom_l", "color"]:
        for ln in lines[1:]:
            parts = ln.split()
            if len(parts) < 3:
                continue
            lut[int(parts[2])] = parts[1]
    else:  # `id name color` rows
        for ln in lines:
            parts = ln.split()
            if len(parts) < 2 or not parts[0].lstrip("-").isdigit():
                continue
            lut[int(parts[0])] = parts[1]
    return lut


def load_lut(path: str) -> dict:
    """{roi_id: name} from a NeuroParc JSON (keyed on the .json extension;
    an unreadable JSON gives {}, so every name falls back to 'ROI{id}') or
    from the text formats."""
    if path.endswith(".json"):
        try:
            with open(path) as f:
                raw = json.load(f)["rois"]
            return {int(k): v.get("label", f"ROI{k}") for k, v in raw.items()
                    if isinstance(v, dict)}
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            return {}
    return load_text_lut(path)


def resample_labels_nearest(labels: np.ndarray, src_affine: np.ndarray,
                            dst_shape, dst_affine: np.ndarray) -> np.ndarray:
    """Resample an integer label volume onto another grid (nearest
    neighbour through world coordinates; out-of-source voxels -> 0)."""
    dst_shape = tuple(int(s) for s in dst_shape)
    ii, jj, kk = np.meshgrid(*[np.arange(s) for s in dst_shape],
                             indexing="ij")
    dst_ijk1 = np.stack([ii, jj, kk, np.ones_like(ii)], axis=-1).reshape(-1, 4)
    world = dst_ijk1 @ np.asarray(dst_affine, np.float64).T
    src_ijk = world @ np.linalg.inv(np.asarray(src_affine, np.float64)).T
    src_idx = np.round(src_ijk[:, :3]).astype(np.int64)
    valid = np.all((src_idx >= 0) & (src_idx < np.asarray(labels.shape)),
                   axis=1)
    out = np.zeros(src_idx.shape[0], labels.dtype)
    v = src_idx[valid]
    out[valid] = labels[v[:, 0], v[:, 1], v[:, 2]]
    return out.reshape(dst_shape)


def load_atlas(nii_path: str, lut_path: str | None = None,
               target_shape=None, target_affine=None):
    """(labels int32 (X, Y, Z), roi_ids ascending > 0, roi_names, affine).

    With `target_shape` the labels are resampled onto that grid
    (`target_affine` defaults to the 2-mm MNI grid's)."""
    hdr = nifti.read_header(nii_path)
    labels = nifti.load(nii_path).astype(np.int32)
    affine = hdr.affine
    if target_shape is not None:
        if target_affine is None:
            target_affine = MNI152_2MM_AFFINE
        labels = resample_labels_nearest(labels, affine, target_shape,
                                         target_affine)
        affine = np.asarray(target_affine, np.float64)
    roi_ids = np.unique(labels)
    roi_ids = roi_ids[roi_ids > 0]
    lut = load_lut(lut_path) if lut_path else {}
    roi_names = [lut.get(int(i), f"ROI{int(i)}") for i in roi_ids]
    return labels, roi_ids, roi_names, affine


def compact_labels(labels: np.ndarray, roi_ids: np.ndarray) -> np.ndarray:
    """Remap ROI ids to contiguous 1..R in the order of `roi_ids` (0 stays
    background). AAL ids are sparse (AAL3 skips 35/36)."""
    mapping = np.zeros(int(roi_ids.max()) + 1, np.int32)
    for new, old in enumerate(roi_ids, start=1):
        mapping[int(old)] = new
    return mapping[labels]
