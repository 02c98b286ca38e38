"""Train the multimodal fusion classifier (MRI + PET + clinical table) with
stratified K-fold CV (port of the TPU package's cli/train_fusion.py). Runs
on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.train_fusion --config config.json \
        --use-pet --use-table --table ADNI_Tabel.csv [--device cuda|cpu] [key=value ...]

The table is read with the csv module (data/tabular.py), not pandas; its
Subject_ID column stays text, as the manifest's subject ids. The table
embedder is `ICLClassifier()` on the bundled asset, on `--device`.
"""

from __future__ import annotations

import numpy as np

from ..train.fusion import train_fusion_cv
from .common import add_device_args, base_parser, distributed, echo, load_config


def read_fusion_table(path: str, start_col: int = 14, classes=("CN", "AD")):
    """(X, y, subjects) of the clinical table's rows in `classes`: features
    from column `start_col` (text columns as codes), the Group labels as
    their position in `classes`, the Subject_ID column as text."""
    from ..data.tabular import isin, load_adni_table, read_table

    X, y, _ = load_adni_table(path, label_col="Group", classes=list(classes),
                              start_col=start_col)
    _, columns = read_table(path, str_columns=("Subject_ID",))
    keep = isin(columns["Group"], list(classes))
    return X, y, [str(s) for s in columns["Subject_ID"][keep]]


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--use-pet", action="store_true")
    p.add_argument("--use-table", action="store_true")
    p.add_argument("--table", default=None, help="clinical CSV (ADNI_Tabel)")
    p.add_argument("--table-start-col", type=int, default=14)
    p.add_argument("--arch", choices=["cross_transformer", "daft"],
                   default="cross_transformer")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)

    table_data = None
    if args.use_table:
        if not args.table:
            p.error("--use-table requires --table")
        table_data = read_fusion_table(args.table, args.table_start_col)

    model_kw = {} if args.arch == "daft" else dict(dim=args.dim, depth=args.depth)
    with distributed(args, cfg) as (device, mesh):
        best, ckpt_dir = train_fusion_cv(
            cfg, use_pet=args.use_pet, use_table=args.use_table, table_data=table_data,
            arch=args.arch, model_kw=model_kw, device=device, mesh=mesh)
    echo(f"\nbest fold scores: {np.round(best, 4).tolist()}")
    echo(f"checkpoints: {ckpt_dir}")
    return best


if __name__ == "__main__":
    main()
