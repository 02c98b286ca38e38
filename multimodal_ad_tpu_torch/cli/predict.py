"""Batch prediction over NIfTI volumes with a trained fold ensemble.

Point it at a checkpoint directory of `best_fold{k}` folds and a list of
volumes (or a label CSV + image dir) to get per-subject fold-mean
probabilities as CSV. Runs on the card unless told otherwise.

Under ``python -m torch.distributed.run`` every rank serves its rows of
each batch (cli/common.py) and rank 0 writes the CSV.

Usage:
    python -m multimodal_ad_tpu_torch.cli.predict --ckpt-dir checkpoints/ \
        --volumes a.nii b.nii.gz --out predictions.csv
    python -m multimodal_ad_tpu_torch.cli.predict --ckpt-dir checkpoints/ \
        --label-file labels.csv --mri-dir MRI/ --task ADCN --out pred.csv
"""

from __future__ import annotations

import argparse
import csv
import os

from .common import add_device_args, distributed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="CV output dir holding best_fold{k} checkpoints")
    p.add_argument("--volumes", nargs="*", default=None,
                   help="NIfTI volume paths to classify")
    p.add_argument("--label-file", default=None,
                   help="ADNI label CSV (alternative to --volumes)")
    p.add_argument("--mri-dir", default=None)
    p.add_argument("--task", default="ADCN")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--out", default="predictions.csv")
    add_device_args(p)
    args = p.parse_args(argv)

    import numpy as np

    from ..data.pipeline import load_volume
    from ..parallel.mesh import is_main
    from ..serve import EnsemblePredictor, labels_from_proba

    if args.volumes:
        paths = list(args.volumes)
        subjects = [os.path.basename(p) for p in paths]
    elif args.label_file and args.mri_dir:
        from ..data.adni import ADNIManifest

        records = ADNIManifest(args.label_file, args.mri_dir, args.task,
                               verbose=False).data_dict
        paths = [r["MRI"] for r in records]
        subjects = [r["Subject"] for r in records]
    else:
        p.error("give --volumes or (--label-file and --mri-dir)")

    with distributed(args) as (device, mesh):
        pred = EnsemblePredictor.from_checkpoint_dir(
            args.ckpt_dir, batch_size=args.batch_size, device=device, mesh=mesh)
        vols = np.stack([load_volume(path) for path in paths])
        proba = pred.predict_proba(vols)
        main = is_main(mesh)
    labels = labels_from_proba(proba)

    if main:
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Subject_ID", "pred"]
                       + [f"prob_{c}" for c in range(proba.shape[1])])
            for s, lab, pr in zip(subjects, labels, proba):
                w.writerow([s, int(lab)] + [f"{v:.6f}" for v in pr])
        print(f"wrote {len(subjects)} predictions ({pred.n_folds}-fold "
              f"ensemble) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
