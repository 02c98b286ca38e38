"""Model families: everything the harness does that depends on the model,
in one file a family, `portbench/families/<model_type>.py`, found by the
configuration's `model_type` as `run.py` finds a metric's reader.

A family file defines:

- `describe(cfg)`: the network's shape as the readers count its work
  (`ctx["model"]`), a dict that holds `"type"`, the family's name;
- `program_model(cfg, device)`: the port's model, through the port's own
  factory, on `device`, with its initial weights to be loaded;
- `init_weights(cfg, seed, device)`: a float32 state dict drawn on
  `device` from `seed`, which the program loads and the reference starts
  from;
- `serving_weights(cfg, seed, fold, calibration, device)`: fold `fold`'s
  weights for serving (`calibration`: normalized NCDHW pool volumes, for a
  family whose eval-mode forward needs statistics from data);
- `precisions`: the serve mixes' precisions the family serves (`bf16`,
  and `int8` where the port quantizes it); for `int8` also
  `int8_forward(sd, calibration, cfg, levels)`, the int8 reference (or,
  at `levels=7`, its 4-bit control) as a function of NCDHW `x`;
- `reference_forward(sd, x, cfg, train=False, dropout_keep=None,
  stats=None, quant=None)`: the plain float32 forward of NCDHW `x`, with
  dropout from the bool mask `dropout_keep`, a train-mode statistics
  record `stats` and the low-precision control's rounding `quant`;
- `update_running_stats(buffers, stats)`: a train step's update of the
  running statistics in `buffers` from `stats` (a no-op for a family
  that keeps none);
- `dropout_width(cfg)`: the width of the features a train step's dropout
  mask covers (the program draws `torch.rand((batch, width))` a step);
- `forward_ops(model)`: one volume's forward operations
  `{"stem", "blocks", "fc"}` for `lib/work.py`'s least times (the stem,
  whose input needs no gradient, always at the bf16 peak).

The reference parts import neither JAX nor anything of the program."""

from __future__ import annotations

from pathlib import Path

from portbench.lib.loading import load_file

FAMILIES = Path(__file__).resolve().parent.parent / "families"


def load(model_type: str):
    """The family module `FAMILIES/<model_type>.py`, loaded once a
    process."""
    path = Path(FAMILIES) / f"{model_type}.py"
    if not path.is_file():
        raise ValueError(f"portbench: no model family {model_type!r} ({path})")
    return load_file(path, f"portbench_family_{model_type}")


def of(cfg: dict):
    """The family of configuration `cfg`, by its `model_type`."""
    return load(cfg["model_type"])
