"""Experiment configuration (own copy of the TPU package's core/config.py).

The same JSON key schema and defaults, so a ``meta.json`` written by either
package restores here. ``compute_dtype`` / ``param_dtype`` stay strings;
`torch_dtype` maps them to torch dtypes. The mesh and prefetch knobs are
kept only so configs round-trip; the port does not read them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / 'float16' -> torch dtype."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}") from None


@dataclass
class Config:
    # ---- data ----
    dataroot: str = ""
    label_file: str = ""
    mri_dir: str = ""
    pet_dir: str = ""
    task: str = "ADCN"
    augment: bool = False
    split_ratio: float = 0.2
    seed: int = 42

    # ---- training ----
    num_epochs: int = 100
    batch_size: int = 8
    lr: float = 1e-6
    weight_decay: float = 1e-4
    dropout_rate: float = 0.5
    n_splits: int = 5
    grad_clip_norm: float = 1.0
    warmup_frac: float = 0.1
    min_lr_factor: float = 1e-4
    best_metric_weights: tuple = (0.3, 0.7)

    # ---- model ----
    normalizer: str = "scale_intensity"
    model_type: str = "resnet"
    model_depth: int = 18
    input_W: int = 91
    input_H: int = 109
    input_D: int = 91
    resnet_shortcut: str = "B"
    pretrain_path: str = ""
    nb_class: int = 2
    in_channels: int = 1
    seg_task: bool = False

    # ---- io ----
    checkpoint_dir: str = "checkpoints"
    log_file: str = "training_log1.csv"

    # ---- precision, and TPU-package knobs kept for round-tripping ----
    mesh_shape: dict = field(default_factory=lambda: {"data": -1})
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    prefetch_depth: int = 2
    loader_threads: int = 8
    resume: bool = False
    precise_bn: bool = False
    hbm_cache: bool = False
    profile_dir: str = ""

    extra: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "Config":
        with open(path) as f:
            d = json.load(f)
        d.update(overrides)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        extra = {k: v for k, v in d.items() if k not in names}
        cfg = cls(**known)
        cfg.extra.update(extra)
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extra")
        d.update(self.extra)
        return d

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def apply_overrides(self, pairs: list[str]) -> "Config":
        """Apply CLI overrides of the form ``key=value`` (JSON-parsed values)."""
        d = self.to_dict()
        for p in pairs:
            k, _, v = p.partition("=")
            try:
                d[k] = json.loads(v)
            except json.JSONDecodeError:
                d[k] = v
        return Config.from_dict(d)

    def describe(self) -> str:
        lines = ["Configuration Parameters:", "=" * 40]
        for k, v in self.to_dict().items():
            lines.append(f"{k}: {v}")
        lines.append("=" * 40)
        return "\n".join(lines)
