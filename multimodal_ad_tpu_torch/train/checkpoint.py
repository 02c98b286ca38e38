"""Fold checkpoints as torch state dicts (port of the TPU package's
train/checkpoint.py).

A checkpoint is a directory, named as train_cv names them (`best_fold{k}`,
`last_fold{k}`, `model_fold{k}_final`), holding

- `model.pt`: the model's plain state_dict (torch.save), which serving
  (`EnsemblePredictor`) loads as it is;
- `train_state.pt`, when a TrainState was saved: the optimizer's
  state_dict, `epoch`, `step` and the dropout generator's state, so
  `restore_state(path, template)` resumes training where it stopped;
- `meta.json` ({"metrics": ..., "config": ...}), the same meta file the
  TPU package writes.

The TPU package's Orbax directories are not read: convert their variables
with utils.torch_weights.state_dict_from_flax (and the Adam moments with
utils.torch_weights.load_optax_adam_state) and save them here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

WEIGHTS_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def save_checkpoint(path: str, state, metrics: dict | None = None,
                    config: dict | None = None):
    """Write a model state_dict, or a TrainState (train/loop.py) with its
    optimizer and counters, and meta.json."""
    os.makedirs(path, exist_ok=True)
    state_dict = state if isinstance(state, dict) else state.model.state_dict()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, WEIGHTS_FILE))
    train_file = os.path.join(path, TRAIN_STATE_FILE)
    if isinstance(state, dict):
        if os.path.exists(train_file):
            os.remove(train_file)  # not a stale optimizer beside new weights
    else:
        gen = state.dropout_generator
        torch.save({"optimizer": state.optimizer.state_dict(),
                    "epoch": int(state.epoch), "step": int(state.step),
                    "dropout_rng": None if gen is None else gen.get_state()},
                   train_file)
    meta = {
        "metrics": {k: float(v) for k, v in (metrics or {}).items()
                    if np.isscalar(v) or getattr(v, "ndim", 1) == 0},
        "config": config or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def restore_state(path: str, template=None) -> tuple:
    """Without `template`: (state_dict on the host, meta dict) of a
    checkpoint dir. With a TrainState `template` (a freshly created one of
    the same model and optimizer): load the weights, the optimizer state,
    the counters and the dropout stream into it and return (template,
    meta); a checkpoint without a train state restores the weights only."""
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
    if template is None:
        return state_dict, meta
    template.model.load_state_dict(state_dict)
    train_file = os.path.join(path, TRAIN_STATE_FILE)
    if os.path.isfile(train_file):
        train = torch.load(train_file, map_location="cpu", weights_only=True)
        template.optimizer.load_state_dict(train["optimizer"])
        template.epoch, template.step = train["epoch"], train["step"]
        if train["dropout_rng"] is not None and template.dropout_generator is not None:
            template.dropout_generator.set_state(train["dropout_rng"])
    return template, meta


def latest_epoch_checkpoint(ckpt_dir: str, prefix: str) -> str | None:
    """The last (by name) `{prefix}*` checkpoint dir in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir) if d.startswith(prefix)]
    if not cands:
        return None
    return os.path.join(ckpt_dir, sorted(cands)[-1])
