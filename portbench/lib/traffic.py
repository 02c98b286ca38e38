"""The one generator that turns a traffic file (`portbench/traffic/<name>.json`)
and `--seed` into the work of a run. A file's "kind" names its driver:
"serve" (`portbench/lib/serve.py`) or "train" (`portbench/lib/train.py`).

Every seed gets the same work in another order: request sizes and gaps
between arrivals come in blocks of a fixed composition, each block
shuffled by the seed, so any run that serves whole blocks is offered the
same sizes at the same times; a training corpus has the same class counts
and split sizes for every seed."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.lib.inputs import sub_seed

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"
SERVE_BLOCKS = 400  # blocks drawn ahead: 24,800 requests, over 20 minutes at 20 a second


def load(name: str) -> dict:
    with open(TRAFFIC / f"{name}.json") as f:
        return json.load(f)


def block_sizes(mix: dict) -> list[int]:
    """One block's request sizes: each band of `mix["sizes"]` takes its
    share of `mix["block"]` requests, spread evenly over [min, max]."""
    sizes = []
    for band in mix["sizes"]:
        count = int(round(band["share"] * mix["block"]))
        span = band["max"] - band["min"] + 1
        sizes += [band["min"] + (j * span) // count for j in range(count)]
    return sizes


def serve_requests(mix: dict, seed: int) -> list[tuple[int, int, float]]:
    """(first pool volume, volumes, arrival in mean gaps from the start) of
    each request in order: blocks of `block_sizes` shuffled by the seed,
    and per block the gaps of a Poisson process as the block's quantiles of
    the exponential distribution (mean 1), shuffled by the seed, so every
    seed offers the same sizes and gaps in another order. A request of n
    scans takes n consecutive pool volumes from an offset drawn uniformly:
    a view of the pool, so the client copies nothing. Arrivals scale to
    seconds by the mix's `rate_per_s`."""
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    base = np.asarray(block_sizes(mix))
    gaps = -np.log1p(-(np.arange(len(base)) + 0.5) / len(base))
    gaps /= gaps.mean()
    pool = mix["pool_volumes"]
    out, t = [], 0.0
    for _ in range(SERVE_BLOCKS):
        for n, gap in zip(rng.permutation(base), rng.permutation(gaps)):
            t += float(gap)
            out.append((int(rng.integers(0, pool - n + 1)), int(n), t))
    return out


def train_corpus(mix: dict, seed: int) -> dict:
    """Labels and the fold's split of a training corpus: `corpus_volumes`
    subjects, round(ad_share * N) of them AD (label 1) in seeded places;
    the validation split takes `val_volumes` subjects, stratified, the
    rest train."""
    n = mix["corpus_volumes"]
    rng = np.random.default_rng(sub_seed(seed, "corpus"))
    labels = np.zeros(n, np.int32)
    labels[rng.permutation(n)[:int(round(mix["ad_share"] * n))]] = 1
    n_val_ad = int(round(mix["val_volumes"] * labels.mean()))
    ad, cn = np.flatnonzero(labels == 1), np.flatnonzero(labels == 0)
    val = np.sort(np.concatenate([rng.permutation(ad)[:n_val_ad],
                                  rng.permutation(cn)[:mix["val_volumes"] - n_val_ad]]))
    train = np.setdiff1d(np.arange(n), val)
    return {"labels": labels, "train": train, "val": val}
