"""Serving: load a trained fold ensemble and predict on volumes (port of
the TPU package's serve.py).

- every fold is its own eval-mode ResNet3D on the device; folds run in a
  Python loop and their softmax probabilities are averaged in float32 on
  the device; only the final (n, classes) array crosses back to the host,
- each request is cut into chunks of the static batch size, and a ragged
  last chunk is padded by repeating its last volume (padded rows are
  dropped), so every forward sees one shape and cuDNN tunes it once,
- preprocessing runs on the device: each chunk is uploaded raw and K1
  (ops/fused_gather.py) gathers the padded batch and min-max normalizes it
  in one pass. Multi-channel volumes normalize per channel, as the host
  path does: (n, X, Y, Z, C) is viewed as n*C channel planes. K1 writes
  bf16 directly when the model computes in bf16 (the first convolution
  would round its input to bf16 anyway).

Usage:
    pred = EnsemblePredictor.from_checkpoint_dir("checkpoints/")
    proba = pred.predict_proba(volumes)   # (n, X, Y, Z[, C]) -> (n, C)
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from .core.config import Config, torch_dtype
from .core.device import resolve_device
from .models.resnet3d import generate_model
from .ops.fused_gather import gather_normalize
from .ops.normalize import NORMALIZERS
from .train import checkpoint as ckpt


def labels_from_proba(proba: np.ndarray) -> np.ndarray:
    """Argmax labels; binary uses the reference's prob > 0.5 rule."""
    if proba.shape[1] == 2:
        return (proba[:, 1] > 0.5).astype(np.int32)
    return np.argmax(proba, axis=1).astype(np.int32)


class EnsemblePredictor:
    """Fold-ensemble classifier over 3D volumes on one device.

    `model` is a ResNet3D template; each entry of `fold_state_dicts` is
    loaded into its own copy."""

    def __init__(self, model, fold_state_dicts: list, batch_size: int = 8,
                 normalizer: str = "scale_intensity",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if not fold_state_dicts:
            raise ValueError("no fold weights given")
        if normalizer not in NORMALIZERS:
            raise ValueError(f"unknown normalizer {normalizer!r}")
        self.model = model
        self.n_folds = len(fold_state_dicts)
        self.batch_size = int(batch_size)
        self.normalizer = normalizer
        self.input_dtype = model.compute_dtype
        self.folds = []
        for sd in fold_state_dicts:
            m = copy.deepcopy(model)
            m.load_state_dict(sd)
            self.folds.append(m.eval().requires_grad_(False).to(self.device))

    # ---- construction -------------------------------------------------

    @classmethod
    def from_checkpoint_dir(cls, ckpt_dir: str, cfg: Config | None = None,
                            prefix: str = "best_fold",
                            batch_size: int | None = None,
                            device: str | torch.device = "cuda"):
        """Load every `{prefix}{k}` checkpoint (k = 1..) of a CV output
        directory. The config comes from the checkpoints' meta.json unless
        `cfg` is given."""
        device = resolve_device(device)
        folds = []
        k = 1
        while os.path.isdir(os.path.join(ckpt_dir, f"{prefix}{k}")):
            folds.append(os.path.join(ckpt_dir, f"{prefix}{k}"))
            k += 1
        if not folds:
            raise FileNotFoundError(f"no {prefix}* checkpoints in {ckpt_dir}")

        if cfg is None:
            with open(os.path.join(folds[0], "meta.json")) as f:
                cfg = Config.from_dict(json.load(f).get("config", {}))

        model = generate_model(
            model_type=cfg.model_type, model_depth=cfg.model_depth,
            resnet_shortcut=cfg.resnet_shortcut, nb_class=cfg.nb_class,
            dropout_rate=cfg.dropout_rate, in_channels=cfg.in_channels,
            compute_dtype=torch_dtype(cfg.compute_dtype),
            param_dtype=torch_dtype(cfg.param_dtype))
        state_dicts = [ckpt.restore_state(path)[0] for path in folds]
        return cls(model, state_dicts, batch_size=batch_size or cfg.batch_size,
                   normalizer=cfg.normalizer, device=device)

    # ---- inference -----------------------------------------------------

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized device batch (B, X, Y, Z, C) -> fold-mean
        probabilities (B, classes), float32, on the device."""
        acc = None
        for m in self.folds:
            p = torch.softmax(m(x).float(), dim=-1)
            acc = p if acc is None else acc + p
        return acc / self.n_folds

    def _prep(self, chunk: torch.Tensor, preprocess: bool) -> torch.Tensor:
        """Device chunk (real, X, Y, Z[, C]) float32 -> padded, normalized
        batch (batch_size, X, Y, Z, C)."""
        if chunk.dim() == 4:
            chunk = chunk.unsqueeze(-1)
        real, *spatial, c = chunk.shape
        bs = self.batch_size
        rows = torch.arange(bs).clamp(max=real - 1)  # pad: repeat the last row
        if not preprocess:
            return chunk[rows.to(chunk.device)]
        planes = chunk.permute(0, 4, 1, 2, 3).contiguous().view(real * c, -1)
        plane_idx = (rows[:, None] * c + torch.arange(c)).reshape(-1)
        if self.normalizer == "scale_intensity":
            x = gather_normalize(planes, plane_idx, self.input_dtype)
        else:
            x = NORMALIZERS[self.normalizer](
                planes[plane_idx.to(chunk.device)]).to(self.input_dtype)
        # channel planes are NCDHW memory; hand the model its channels-last view
        return x.view(bs, c, *spatial).permute(0, 2, 3, 4, 1)

    def predict_proba(self, volumes, preprocess: bool = True) -> np.ndarray:
        """(n, X, Y, Z) or (n, X, Y, Z, C) host volumes -> (n, classes)
        fold-mean probabilities."""
        vols = np.asarray(volumes, np.float32)
        bs = self.batch_size
        out = []
        for i in range(0, vols.shape[0], bs):
            chunk = torch.from_numpy(np.ascontiguousarray(vols[i:i + bs]))
            real = chunk.shape[0]
            probs = self.forward(self._prep(chunk.to(self.device), preprocess))
            out.append(probs[:real].cpu().numpy())
        return np.concatenate(out, axis=0)

    def predict(self, volumes, preprocess: bool = True) -> np.ndarray:
        """Argmax labels; binary uses the reference's prob > 0.5 rule."""
        return labels_from_proba(self.predict_proba(volumes, preprocess))


def evaluate_records(predictor: EnsemblePredictor, records) -> dict:
    """Held-out AUC/ACC of a fold-ensemble predictor on manifest records
    ({'MRI': path, 'label': int}), with the prob > 0.5 binary rule."""
    from sklearn.metrics import accuracy_score, roc_auc_score

    from .data.pipeline import load_volume

    vols = np.stack([load_volume(r["MRI"]) for r in records])
    y = np.asarray([r["label"] for r in records])
    proba = predictor.predict_proba(vols)
    if proba.shape[1] == 2:
        auc = roc_auc_score(y, proba[:, 1])
    else:
        auc = roc_auc_score(y, proba, multi_class="ovr")
    return {"AUC": float(auc),
            "ACC": float(accuracy_score(y, labels_from_proba(proba)))}
