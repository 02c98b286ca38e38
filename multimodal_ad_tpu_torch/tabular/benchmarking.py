"""Reproducible experiment harness (own copy of the TPU package's
tabular/benchmarking.py): a base class that seeds `random`, numpy's global
generator and torch's before each run, collects the results with the run's
wall time, saves them as JSON, and can plot them.
"""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch


class Experiment:
    """Subclass and implement `run_experiment(**kwargs) -> dict`."""

    name = "experiment"

    def __init__(self, seed: int = 42, output_dir: str = "experiments"):
        self.seed = seed
        self.output_dir = output_dir
        self.results: dict | None = None

    def set_seeds(self):
        random.seed(self.seed)
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)  # the CPU's and every card's generator

    def run(self, **kwargs) -> dict:
        self.set_seeds()
        t0 = time.time()
        results = self.run_experiment(**kwargs)
        results = dict(results or {})
        results.setdefault("name", self.name)
        results["seed"] = self.seed
        results["wall_time_s"] = round(time.time() - t0, 3)
        self.results = results
        return results

    def run_experiment(self, **kwargs) -> dict:
        raise NotImplementedError

    def save(self, path: str | None = None) -> str:
        if self.results is None:
            raise RuntimeError("run() first")
        os.makedirs(self.output_dir, exist_ok=True)
        path = path or os.path.join(self.output_dir, f"{self.name}.json")
        with open(path, "w") as f:
            json.dump(self.results, f, indent=2, default=str)
        return path

    def plot(self, out_png: str | None = None):
        """Bar chart of the numeric scalars in results (host-only:
        matplotlib is imported here)."""
        if self.results is None:
            raise RuntimeError("run() first")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nums = {k: v for k, v in self.results.items()
                if isinstance(v, (int, float)) and k not in ("seed",)}
        fig, ax = plt.subplots(figsize=(max(4, len(nums)), 3))
        ax.bar(list(nums), list(nums.values()))
        ax.set_title(self.name)
        plt.xticks(rotation=30, ha="right")
        out_png = out_png or os.path.join(self.output_dir, f"{self.name}.png")
        os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_png
