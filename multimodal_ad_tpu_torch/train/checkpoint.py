"""Fold checkpoints as torch state dicts (serving half of the TPU package's
train/checkpoint.py).

A checkpoint is a directory, named as train_cv names them (`best_fold{k}`,
`model_fold{k}_final`), holding `model.pt` (the model's state_dict, saved
with torch.save) and `meta.json` ({"metrics": ..., "config": ...}), the
same meta file the TPU package writes. The TPU package's Orbax
directories are not read: convert their variables with
utils.torch_weights.state_dict_from_flax and save them here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

WEIGHTS_FILE = "model.pt"


def save_checkpoint(path: str, state_dict: dict, metrics: dict | None = None,
                    config: dict | None = None):
    """Write `state_dict` (tensors, moved to the host) and meta.json."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, WEIGHTS_FILE))
    meta = {
        "metrics": {k: float(v) for k, v in (metrics or {}).items()
                    if np.isscalar(v) or getattr(v, "ndim", 1) == 0},
        "config": config or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def restore_state(path: str) -> tuple[dict, dict]:
    """Return (state_dict on the host, meta dict) of a checkpoint dir."""
    weights = os.path.join(path, WEIGHTS_FILE)
    if not os.path.isfile(weights):
        if os.path.isdir(path) and os.listdir(path):
            raise ValueError(
                f"{path} holds no {WEIGHTS_FILE}: it is not a checkpoint of "
                "this package (an Orbax directory written by the TPU "
                "package?). Convert its variables with "
                "utils.torch_weights.state_dict_from_flax and save them with "
                "save_checkpoint.")
        raise FileNotFoundError(f"no checkpoint at {path}")
    state_dict = torch.load(weights, map_location="cpu", weights_only=True)
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state_dict, meta
