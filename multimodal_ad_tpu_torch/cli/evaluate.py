"""Standalone test evaluation of saved fold checkpoints (port of the TPU
package's cli/evaluate.py; the reference's `python test.py`): rebuild the
seed-42 stratified test split, load best_fold{k} for k = 1..n_splits,
print per-fold metrics and confusion matrices, and write the pooled ROC
PNG when matplotlib is present. Runs on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.evaluate --config config.json \
        [--device cuda|cpu] [checkpoint_dir=... key=value ...]
"""

from __future__ import annotations

from ..data.adni import ADNIManifest
from ..data.splits import stratified_test_split
from ..train.cv import test_models
from .common import add_device_args, base_parser, distributed, is_rank0, load_config


def main(argv=None):
    p = base_parser(__doc__)
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)
    records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task,
                           augment=False, verbose=is_rank0()).data_dict
    _, test_data = stratified_test_split(records, cfg.split_ratio, cfg.seed)
    with distributed(args, cfg) as (device, mesh):
        return test_models(cfg, test_data, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
