"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name from
BENCHMARK.json: the configuration's file, `portbench/traffic/<traffic>.json`
(whose "kind" picks the driver in `portbench/lib/`), the cell's limits in
`portbench/limits/<cell>.json` and each per-layer metric's reader in
`portbench/metrics/<name before the first dot>.py`.

With `--trace 0` the last line of standard output carries the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, read from a
torch.profiler trace of the window's first TRACE_SECONDS, and the
breakdown. Every run checks the window's outputs against the plain
reference; the numbers compared and their limits are the last lines of
standard error and the last key of the result. The run fails, printing no
result, without enough CUDA cards, or when JAX or the JAX package was
loaded."""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_ad_tpu")


def _environment() -> None:
    """The CUDA driver's kernel cache inside the checkout, at a fixed path,
    so only a checkout's first run fills it (the program's own CUDA kernels
    build into multimodal_ad_tpu_torch/build/). The program keeps its own
    host threading."""
    os.environ["CUDA_CACHE_PATH"] = str(BENCH / ".cache" / "cuda")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, a JAX library's or the
    JAX package's (whole names: the port's own name starts with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def reader(metric: str):
    from portbench.lib.loading import load_file
    path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return load_file(path, f"portbench_metric_{path.stem}").read


def cell_metrics(manifest: dict, group: str, cell: str) -> list:
    return [m for m in manifest[group] if cell in m.get("workloads", [cell])]


def driver_for(kind: str):
    from portbench.lib.serve import Serve
    from portbench.lib.train import Train
    return {"serve": Serve, "train": Train}[kind]


def end_to_end(kind: str, w: dict, setup_s: float) -> dict:
    rate = "serve_vols_per_s" if kind == "serve" else "train_vols_per_s"
    return {"setup_s": setup_s, rate: w["volumes"] / w["window_s"]}


def run_cell(manifest: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, cfg: dict | None = None, mix: dict | None = None):
    """One run of `cell` on `device`: (result without `checks`, checks).
    `cfg` and `mix` replace the cell's configuration and traffic (the tests
    drive the harness at a small size on the CPU with them)."""
    import torch

    from portbench.lib import check, traffic
    from portbench.lib import trace as tr

    if cfg is None:
        with open(ROOT / find(manifest["configs"], cell["config"], "config")["file"]) as f:
            cfg = json.load(f)
    mix = mix or traffic.load(cell["traffic"])
    limits = check.load_limits(cell["name"])
    kind = mix["kind"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t_driver = time.perf_counter()
    run = driver_for(kind)(cfg, mix, seed, dev)
    setup_s = time.perf_counter() - T_START
    print(f"portbench: set-up {setup_s:.3f} s: imports and CUDA {t_driver - T_START:.3f} s; "
          + "; ".join(f"{name} {t - T_START:.3f}" for name, t in run.phases[1:]),
          file=sys.stderr)
    w = run.window(seconds, TRACE_SECONDS if trace else None)
    if "backlog" in w:
        print(f"portbench: {w['requests']} requests, {w['volumes']} volumes in "
              f"{w['window_s']:.3f} s; {w['backlog']} more were due and waiting at the close",
              file=sys.stderr)
    if "epoch_s" in w:
        print("portbench: epochs " + " ".join(f"{t:.3f}" for t in w["epoch_s"]), file=sys.stderr)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell["chips"],
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    out = {"correct": False, "attempted": w.get("requests", w.get("steps")), "failed": 0}
    breakdown = None
    if trace:
        prof, *_, traced_s = run.traced
        t_reduce = time.perf_counter()
        summary = tr.reduce(prof, traced_s)
        print(f"portbench: trace of {traced_s:.3f} s reduced in "
              f"{time.perf_counter() - t_reduce:.3f} s", file=sys.stderr)
        run.traced = (None,) + tuple(run.traced[1:])
        ctx = run.trace_context(summary)
        metrics = {}
        for m in cell_metrics(manifest, "per_layer", cell["name"]):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"], device_info["window_s"] = summary["busy_s"], summary["window_s"]
        breakdown = summary["breakdown"]
        del prof, summary, ctx
    else:
        values = end_to_end(kind, w, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(manifest, "end_to_end", cell["name"])}
    run.close()
    t_check = time.perf_counter()
    readings = run.check()
    print(f"portbench: reference and check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct, checks = check.judge(readings, limits)
    out.update(correct=correct, metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))

    manifest = load_manifest()
    cell = find(manifest["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out, checks = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace), dev)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
