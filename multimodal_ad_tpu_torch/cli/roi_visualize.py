"""ROI overlay + atlas query tool (port of the TPU package's
cli/roi_visualize.py; prints the same lines).

Mirrors the reference's nilearn-based viewers: models/ROL_visual.py (ROI
mask over a subject MRI, default hippocampus AAL ids 41/42) and
models/ROI_pol_test.py (voxel/world-coordinate ROI queries). The queries
and the HTML viewer need numpy only; the PNG overlay (`--mri` without
`--html`, or with `--out`) needs matplotlib. Runs on the host: nothing
here uses a card.

Usage:
    python -m multimodal_ad_tpu_torch.cli.roi_visualize --atlas atlas.nii \
        --mri subject.nii --roi-ids 41 42 --out overlay.png
    python -m multimodal_ad_tpu_torch.cli.roi_visualize --atlas atlas.nii \
        --atlas-json atlas.json --query-voxel 45 54 45
    python -m multimodal_ad_tpu_torch.cli.roi_visualize --atlas atlas.nii \
        --mri subject.nii --html viewer.html      # interactive slice viewer
"""

from __future__ import annotations

import argparse

import numpy as np

from ..eval.atlas import (MNI152_2MM_SHAPE, load_atlas, query_voxel, query_world,
                          roi_centers, save_roi_overlay)
from ..eval.html_view import save_interactive_html
from ..utils import nifti


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--atlas", required=True)
    p.add_argument("--atlas-json", "--atlas-lut", dest="atlas_json",
                   default=None,
                   help="atlas LUT: NeuroParc JSON, ROI_MNI_V7_vol.txt, or "
                        "AAL3v1*.nii.txt")
    p.add_argument("--resample-2mm", action="store_true",
                   help="nearest-neighbor resample the atlas onto the 2-mm "
                        "91x109x91 MNI grid (for the in-tree 1-mm AAL3)")
    p.add_argument("--mri", default=None, help="subject MRI for overlay")
    p.add_argument("--roi-ids", type=int, nargs="+", default=[41, 42],
                   help="ROI ids to overlay (default: hippocampus L/R)")
    p.add_argument("--out", default="roi_overlay.png")
    p.add_argument("--html", default=None,
                   help="also write a self-contained interactive HTML "
                        "viewer (three orthogonal slice views + ROI hover "
                        "queries; the reference's nilearn view_img "
                        "equivalent, models/ROL_visual.py:55-66)")
    p.add_argument("--all-rois", action="store_true",
                   help="overlay every atlas ROI in the HTML viewer "
                        "instead of only --roi-ids")
    p.add_argument("--axis", type=int, default=2)
    p.add_argument("--query-voxel", type=int, nargs=3, default=None)
    p.add_argument("--query-world", type=float, nargs=3, default=None)
    args = p.parse_args(argv)

    target = MNI152_2MM_SHAPE if args.resample_2mm else None
    labels, roi_ids, roi_names, affine = load_atlas(
        args.atlas, args.atlas_json, target_shape=target)
    names = dict(zip((int(i) for i in roi_ids), roi_names))

    if args.query_voxel:
        name = query_voxel(labels, names, args.query_voxel)
        print(f"voxel {tuple(args.query_voxel)} -> {name or 'background'}")
    if args.query_world:
        centers = roi_centers(labels, roi_ids, affine)
        name, rid, dist = query_world(args.query_world, centers, names)
        print(f"world {tuple(args.query_world)} -> {name} (id {rid}, "
              f"{dist:.1f} mm from centroid)")
    if args.mri:
        mri = nifti.load(args.mri)
        if args.html is None or args.out != "roi_overlay.png":
            out = save_roi_overlay(mri, labels, args.roi_ids, args.out,
                                   axis=args.axis)
            print(f"overlay saved: {out}")
        if args.html:
            out = save_interactive_html(
                mri, args.html, labels=labels, roi_names_by_id=names,
                roi_ids=None if args.all_rois else args.roi_ids,
                title="ROI overlay")
            print(f"interactive viewer saved: {out}")
    elif args.html:
        # no subject MRI: view the atlas itself with full ROI overlay
        out = save_interactive_html(
            labels.astype(np.float32), args.html, labels=labels,
            roi_names_by_id=names, title="atlas viewer")
        print(f"interactive viewer saved: {out}")
    return 0


if __name__ == "__main__":
    main()
