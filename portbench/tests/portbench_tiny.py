"""Small stand-ins of the benchmark's configurations and mixes, so the
tests drive the harness on the CPU in seconds: the published widths, a
20 x 24 x 20 volume, a 40-volume pool offered 2 requests a second (what
the CPU serves) and a 40-volume corpus."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SHAPE = [20, 24, 20]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str = "resnet18_adni", **changes) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    return {**cfg, "input_shape": SHAPE, **changes}


def mix(name: str, **changes) -> dict:
    from portbench.lib import traffic
    m = traffic.load(name)
    small = ({"pool_volumes": 40, "rate_per_s": 2.0} if m["kind"] == "serve"
             else {"corpus_volumes": 40, "val_volumes": 8})
    return {**m, **small, **changes}


def cell(name: str) -> dict:
    return next(c for c in manifest()["workloads"] if c["name"] == name)
