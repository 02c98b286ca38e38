"""Train the 3-D U-Net classifier on a single 64/16/20 split (port of the
TPU package's cli/train_unet3d.py; the reference's `python
train_unet3d.py`). Runs on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.train_unet3d --config config.json \
        [--device cuda|cpu] [lr=1e-3 num_epochs=50 augment=true ...]
"""

from __future__ import annotations

from ..train.single_split import train_unet_classifier
from .common import add_device_args, base_parser, distributed, echo, load_config


def main(argv=None):
    p = base_parser(__doc__)
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)
    with distributed(args, cfg) as (device, mesh):
        best_auc, ckpt_dir = train_unet_classifier(cfg, device=device, mesh=mesh)
    echo(f"\nbest val AUC: {best_auc:.4f}  checkpoints: {ckpt_dir}")
    return best_auc


if __name__ == "__main__":
    main()
