"""Train the 3D ResNet classifier with stratified K-fold CV (port of the
TPU package's cli/train_resnet3d.py; the reference's
`python train_ResNet3D.py`). Runs on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.train_resnet3d --config config.json \
        [--device cuda|cpu] [lr=1e-4 num_epochs=50 hbm_cache=true ...]
    python -m torch.distributed.run --nproc_per_node=N \
        -m multimodal_ad_tpu_torch.cli.train_resnet3d ...   # data parallel
"""

from __future__ import annotations

from ..train.cv import train_cv
from .common import add_device_args, base_parser, distributed, echo, load_config


def main(argv=None):
    p = base_parser(__doc__)
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)
    with distributed(args, cfg) as (device, mesh):
        results, ckpt_dir = train_cv(cfg, device=device, mesh=mesh)
    echo(f"\ncheckpoints: {ckpt_dir}")
    return results


if __name__ == "__main__":
    main()
