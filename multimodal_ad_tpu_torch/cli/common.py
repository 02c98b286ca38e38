"""Shared CLI plumbing (port of the TPU package's cli/common.py): a
`--config <json>` path in the reference config.json schema, plus
positional key=value overrides."""

from __future__ import annotations

import argparse

from ..core.config import Config


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config (reference config/config.json schema)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides (values JSON-parsed)")
    return p


def load_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.overrides:
        cfg = cfg.apply_overrides(args.overrides)
    print(cfg.describe())
    return cfg
