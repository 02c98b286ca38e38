"""Shared CLI plumbing (port of the TPU package's cli/common.py): a
`--config <json>` path in the reference config.json schema, plus
positional key=value overrides; and the data-parallel launch.

Started by ``python -m torch.distributed.run --nproc_per_node=N -m
multimodal_ad_tpu_torch.cli.<name> ...`` (``WORLD_SIZE`` in the
environment), a CLI joins the process group (`distributed`): NCCL for
``--device cuda``, each rank on ``cuda:LOCAL_RANK``; gloo for ``--device
cpu``. The mesh is `make_mesh(cfg.mesh_shape)`; only rank 0 prints the config and the
results, and only the mesh's first rank writes files. A rank that raises
ends its process with a non-zero code, and the launcher stops the others.
Without that environment a CLI runs as one process, with no mesh.

With ``MAD_LAUNCH_COUNTS_DIR`` set, each CLI process writes its launches
of the hand kernels K1-K3 at exit to ``launches-rank<RANK>.json`` there
(chip_smoke.py reads them from a launched run).
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os

from ..core.config import Config


def launch_counts() -> dict:
    """This process's launches of K1 (fused gather + normalize), K2 (ROI
    pooling) and K3 (int8 conv)."""
    from ..ops import fused_gather, int8_conv, roi_pool

    return {"K1": fused_gather.gather_normalize.launches,
            "K2": roi_pool.roi_pool.launches, "K3": int8_conv.conv_i8.launches}


def _write_launch_counts(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"launches-rank{os.environ.get('RANK', '0')}.json")
    with open(path, "w") as f:
        json.dump(launch_counts(), f)


if os.environ.get("MAD_LAUNCH_COUNTS_DIR"):
    atexit.register(_write_launch_counts, os.environ["MAD_LAUNCH_COUNTS_DIR"])


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config (reference config/config.json schema)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides (values JSON-parsed)")
    return p


def add_device_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """--device (default cuda; under a launcher cuda:LOCAL_RANK)."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card); under "
                        "torch.distributed.run, cuda means cuda:LOCAL_RANK")
    return p


def launched() -> bool:
    """True in a process started by ``torch.distributed.run``."""
    return "WORLD_SIZE" in os.environ


def is_rank0() -> bool:
    """True outside a launch, and on the launch's rank 0."""
    return int(os.environ.get("RANK", "0")) == 0


def echo(*args, **kwargs) -> None:
    """print() on rank 0 only."""
    if is_rank0():
        print(*args, **kwargs)


@contextlib.contextmanager
def distributed(args, cfg: Config | None = None):
    """(device, mesh) for the CLI's run. Under a launcher: join the group
    (`init_distributed` with ``args.device``), build
    `make_mesh(cfg.mesh_shape)` (or the whole world without a config), and
    leave the group on exit. Otherwise (``args.device``, None)."""
    if not launched():
        yield args.device, None
        return
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh

    dev = init_distributed(device=args.device)
    try:
        yield dev, make_mesh(cfg.mesh_shape if cfg is not None else None)
    finally:
        dist.destroy_process_group()


def load_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.overrides:
        cfg = cfg.apply_overrides(args.overrides)
    echo(cfg.describe())
    return cfg
