#!/usr/bin/env python3
"""The ICL quality benchmark's six synthetic classification families
(benchmarks/icl_quality.py:46-108) through the port's in-context models on
the card.

    python3 scripts/icl_quality_port.py [--out DIR] [--device cuda|cpu]

For each family and seed 0-2 (N = 360, a stratified 2/3 : 1/3 split seeded
by the seed, as the JAX script splits): `ICLClassifier()` with the bundled
asset; on the binary families `AutoICLClassifier(n_configs=6)` and
`TunedICLClassifier(n_trials=8)` as the JAX script configures them; on the
6-class family `ManyClassClassifier(ICLClassifier(), alphabet_size=4)`,
ECOC below the network's 10 classes. It prints each family's mean test
accuracy and AUC beside the JAX package's figures read from
benchmarks/ICL_QUALITY.md (accuracies of the same seeds on the CPU, not
speeds), each model's fit + predict seconds, and the card's name and power
limit, and writes the table as JSON to DIR. The generators below are
copies of the JAX script's (tests/test_torch_port_tabular_meta.py holds
them equal); the script needs no JAX and no sklearn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)
N = 360  # samples per dataset (train 2/3, test 1/3)


def family_cluster(rng, n=N):
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, 8)) + 1.2 * y[:, None] * rng.normal(0.8, 0.3, size=8)
    return X.astype(np.float32), y


def family_nonlinear(rng, n=N):
    """XOR of two features: linearly inseparable."""
    X = rng.normal(size=(n, 6))
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(int)
    X[:, 2:] = rng.normal(size=(n, 4))  # distractors
    return X.astype(np.float32), y


def family_mixed(rng, n=N):
    """Numeric + integer-coded categoricals interacting with the label."""
    y = rng.integers(0, 2, n)
    num = rng.normal(size=(n, 4)) + 0.8 * y[:, None]
    cat = rng.integers(0, 3, size=(n, 3)).astype(np.float64)
    cat[:, 0] = np.where(y == 1, rng.integers(1, 3, n), rng.integers(0, 2, n))
    return np.concatenate([num, cat], 1).astype(np.float32), y


def family_imbalanced(rng, n=N):
    """~8% positive class."""
    y = (rng.random(n) < 0.08).astype(int)
    y[:4] = 1
    X = rng.normal(size=(n, 8)) + 1.5 * y[:, None]
    return X.astype(np.float32), y


def family_correlated(rng, n=N):
    """Signal hidden in a difference of two highly correlated features."""
    base = rng.normal(size=(n, 1))
    X = np.concatenate([base + 0.05 * rng.normal(size=(n, 1)),
                        base - 0.05 * rng.normal(size=(n, 1)),
                        rng.normal(size=(n, 6))], 1)
    y = (X[:, 0] - X[:, 1] > 0).astype(int)
    return X.astype(np.float32), y


def family_many_class(rng, n=N):
    """6 classes."""
    y = rng.integers(0, 6, n)
    centers = rng.normal(0, 2.0, size=(6, 8))
    X = centers[y] + rng.normal(0, 0.9, size=(n, 8))
    return X.astype(np.float32), y


FAMILIES = {
    "cluster": family_cluster,
    "nonlinear-xor": family_nonlinear,
    "mixed-type": family_mixed,
    "imbalanced-8pct": family_imbalanced,
    "correlated": family_correlated,
    "many-class-6": family_many_class,
}
MODELS = ("ICL", "AutoICL", "TunedICL", "ECOC")


def make_models(n_classes: int, device: str) -> dict:
    from multimodal_ad_tpu_torch.tabular import (AutoICLClassifier, ICLClassifier,
                                                 ManyClassClassifier, TunedICLClassifier)

    models = {"ICL": ICLClassifier(device=device)}
    if n_classes <= 2:  # the JAX script runs the wrappers on the binary families
        base = ICLClassifier(device=device)
        models["AutoICL"] = AutoICLClassifier(base, n_configs=6, random_state=0)
        models["TunedICL"] = TunedICLClassifier(base, n_trials=8, random_state=0)
    else:
        models["ECOC"] = ManyClassClassifier(ICLClassifier(device=device), alphabet_size=4)
    return models


def jax_figures() -> dict:
    """{family: {model: (acc, auc)}} from benchmarks/ICL_QUALITY.md's
    accuracy table."""
    path = os.path.join(ROOT, "benchmarks", "ICL_QUALITY.md")
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("| family | ICL |"))
    header = [c.strip() for c in lines[start].strip("|").split("|")]
    out = {}
    for ln in lines[start + 2:]:
        if not ln.startswith("|"):
            break
        cells = [c.strip() for c in ln.strip("|").split("|")]
        out[cells[0]] = {}
        for name, cell in zip(header[1:], cells[1:]):
            if "(" in cell:
                acc, auc = cell.replace(")", "").split("(")
                out[cells[0]][name] = (float(acc), float(auc))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "icl_quality_port"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.tabular.estimator import train_test_split
    from multimodal_ad_tpu_torch.tabular.scoring import safe_roc_auc_score

    resolve_device(args.device)  # "cuda" raises where there is no card
    card = "host CPU"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    results = {}  # {family: {model: [(acc, auc, seconds), ...]}}
    for fam, gen in FAMILIES.items():
        for seed in SEEDS:
            X, y = gen(np.random.default_rng(seed))
            Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=1 / 3, random_state=seed,
                                                  stratify=y)
            for name, model in make_models(len(np.unique(y)), args.device).items():
                t0 = time.perf_counter()
                model.fit(Xtr, ytr)
                proba = model.predict_proba(Xte)
                seconds = time.perf_counter() - t0
                acc = float((model.classes_[proba.argmax(1)] == yte).mean())
                auc = safe_roc_auc_score(yte, proba)
                results.setdefault(fam, {}).setdefault(name, []).append((acc, auc, seconds))
                print(f"{fam:16s} seed{seed} {name:9s} acc={acc:.3f} auc={auc:.3f} "
                      f"({seconds:.2f} s)", flush=True)
    ref = jax_figures()
    print(f"\nmean over seeds {SEEDS}: port acc (auc) [JAX acc (auc), "
          f"benchmarks/ICL_QUALITY.md]; {card}")
    print("| family | " + " | ".join(MODELS) + " |")
    print("|---|" + "---|" * len(MODELS))
    table = {}
    for fam in FAMILIES:
        cells = []
        for m in MODELS:
            vals = results[fam].get(m)
            if not vals:
                cells.append("-")
                continue
            acc = float(np.mean([v[0] for v in vals]))
            auc = float(np.nanmean([v[1] for v in vals]))
            secs = float(np.mean([v[2] for v in vals]))
            jref = ref.get(fam, {}).get(m)
            table.setdefault(fam, {})[m] = {"acc": acc, "auc": auc, "seconds": secs,
                                            "jax_acc_auc": jref}
            j = f" [{jref[0]:.3f} ({jref[1]:.3f})]" if jref else " [not in the JAX table]"
            cells.append(f"{acc:.3f} ({auc:.3f}){j}, {secs:.2f} s")
        print(f"| {fam} | " + " | ".join(cells) + " |")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "icl_quality_port.json"), "w") as f:
        json.dump({"card": card, "seeds": SEEDS, "n": N, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
