"""Extract U-Net voxel + atlas-ROI features over the test split.

Mirrors the reference's `python image_features.py`: the seed-42 stratified
test split, an untrained UNet3D forward, features.csv + roi_features.csv.
Runs on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.extract_features --config config.json \
        --atlas atlas.nii --atlas-json atlas.json --out output/ \
        [--reference-bug-compat] [--device cuda|cpu] [key=value ...]
"""

from __future__ import annotations

from ..data.adni import ADNIManifest
from ..data.splits import stratified_test_split
from ..eval.atlas import MNI152_2MM_SHAPE, compact_labels, load_atlas
from ..eval.features import extract_unet_features
from .common import add_device_args, base_parser, distributed, echo, is_rank0, load_config


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--atlas", required=True,
                   help="AAL atlas NIfTI (2mm grid, or any grid with "
                        "--resample-2mm, e.g. AAL3v1_1mm.nii.gz)")
    p.add_argument("--atlas-json", "--atlas-lut", dest="atlas_json",
                   default=None,
                   help="atlas LUT: NeuroParc JSON, ROI_MNI_V7_vol.txt, or "
                        "AAL3v1*.nii.txt")
    p.add_argument("--resample-2mm", action="store_true",
                   help="nearest-neighbor resample the atlas onto the 2-mm "
                        "91x109x91 MNI grid the volumes live on")
    p.add_argument("--out", default="output", help="output directory")
    p.add_argument("--reference-bug-compat", action="store_true",
                   help="emit ROI rows in the reference's transposed order")
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)

    records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task,
                           augment=False, verbose=is_rank0()).data_dict
    _, test_data = stratified_test_split(records, cfg.split_ratio, cfg.seed)

    target = MNI152_2MM_SHAPE if args.resample_2mm else None
    labels, roi_ids, roi_names, _ = load_atlas(args.atlas, args.atlas_json,
                                               target_shape=target)
    labels = compact_labels(labels, roi_ids)
    with distributed(args, cfg) as (device, mesh):
        fpath, rpath = extract_unet_features(
            test_data, labels, roi_names, args.out,
            batch_size=cfg.batch_size, num_threads=cfg.loader_threads,
            seed=cfg.seed, reference_bug_compat=args.reference_bug_compat,
            device=device, mesh=mesh)
    echo(f"\nvoxel CSV : {fpath}")
    echo(f"ROI   CSV : {rpath}")
    return fpath, rpath


if __name__ == "__main__":
    main()
