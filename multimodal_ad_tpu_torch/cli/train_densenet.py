"""Train the dilated DenseNet MRI classifier with stratified K-fold CV (port
of the TPU package's cli/train_densenet.py): the ResNet trainer's harness
(`train_cv`) with a DenseNet-3D per fold, whose initial weights depend on
``seed + fold`` alone. Runs on the card unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.train_densenet --config config.json \
        [--growth 16] [--blocks 6 12 24 16] [--device cuda|cpu] [key=value ...]
"""

from __future__ import annotations

from ..core.config import torch_dtype
from ..models.densenet import DilatedDenseNet
from ..train.cv import train_cv
from .common import add_device_args, base_parser, distributed, echo, load_config


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--growth", type=int, default=16)
    p.add_argument("--blocks", type=int, nargs="+", default=[6, 12, 24, 16])
    add_device_args(p)
    args = p.parse_args(argv)
    cfg = load_config(args)

    def factory():
        return DilatedDenseNet(
            num_classes=cfg.nb_class, in_channels=cfg.in_channels,
            growth=args.growth, block_config=tuple(args.blocks),
            dropout_rate=cfg.dropout_rate, spatial_dims=3,
            compute_dtype=torch_dtype(cfg.compute_dtype)).to(torch_dtype(cfg.param_dtype))

    with distributed(args, cfg) as (device, mesh):
        results, ckpt_dir = train_cv(cfg, model_factory=factory, device=device, mesh=mesh)
    echo(f"\ncheckpoints: {ckpt_dir}")
    return results


if __name__ == "__main__":
    main()
