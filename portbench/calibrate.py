"""Readings that the limits in `portbench/limits/` are set from (not run by
the benchmark's own runs).

    python3 portbench/calibrate.py --kind serve --config resnet18_adni --seeds 12 --controls 3
    python3 portbench/calibrate.py --kind train --config resnet18_adni --seeds 12 --controls 3
    python3 portbench/calibrate.py --kind serve --config resnet18_adni --seconds 20 \
        --mix clinic_study_mix --sweep 13.4,15.7,17.9,20.2,22.4,24.6

Serve: per seed, the bf16 predictor serves `--seconds` of the bf16 mix
(`--mix`, clinic_study_mix by default) and is compared with the float32
reference (r18_serve_bf16's reading). Where the configuration's model
family serves int8, the same predictor quantized to int8 serves again and
is compared with the int8 reference (r18_serve_int8's reading) and with the
float32 one (the bf16 cell's control: the program's own lower-precision
path); on the first `--controls` seeds the 4-bit reference is compared with
the int8 one (the int8 cell's control).

Sweep: the offered rates in turn, for finding the knee that sets a mix's
`rate_per_s` (about twice it: the window then measures volumes answered a second).

Train: per seed, the program's first checked steps of the train mix
(`--mix`, cv_fold_epochs by default) against the float32 reference; on the
first `--controls` seeds the reference in fp8 in the program's place (the
control) and the reference with half of each batch left out (a fault). Each seed prints one JSON line, with the leaves that
read the widest gradient and change gaps."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _worst(gaps: dict, n: int = 3) -> list:
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:n]


def serve(cfg, mix_name, seeds, controls, seconds, dev):
    from portbench.lib import check, traffic
    from portbench.lib.serve import Serve
    mix = traffic.load(mix_name)
    for i, seed in enumerate(seeds):
        t0 = time.time()
        s = Serve(cfg, mix, seed, dev)
        s.window(seconds)
        ref32 = s.reference_proba(None)
        out = {"seed": seed, "bf16.prob_gap": s.readings(ref32)["prob_gap"]}
        if "int8" in s.family.precisions:
            s.served = []
            s.pred.quantize_int8(s.pool[:mix["calibration_volumes"]])
            s.int8 = True
            s.pred.predict_proba(s.pool[:cfg["batch_size"]])
            s.window(seconds)
            ref8 = s.reference_proba(127)
            out["int8.prob_gap"] = s.readings(ref8)["prob_gap"]
            out["bf16_control.prob_gap"] = s.readings(ref32)["prob_gap"]
            if i < controls:
                out["int8_control.prob_gap"] = check.prob_gap(s.reference_proba(7), ref8)
        out["answers"] = sum(n for _, n, _, _ in s.served)
        out["seconds"] = time.time() - t0
        s.close()
        print(json.dumps(out), flush=True)


def sweep(cfg, mix_name, seed, seconds, rates, dev):
    """The open loop at each offered rate in turn on one predictor: the
    knee is the highest rate served without a backlog that grows through
    the window."""
    import numpy as np

    from portbench.lib import traffic
    from portbench.lib.serve import Serve
    s = Serve(cfg, traffic.load(mix_name), seed, dev)
    for rate in rates:
        s.served = []
        w = s.window(seconds, rate=rate)
        lat = np.asarray(w["latencies_s"]) * 1e3
        print(json.dumps({"mix": mix_name, "rate_per_s": rate, "requests": w["requests"],
                          "vols_per_s": w["volumes"] / w["window_s"],
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "backlog": w["backlog"]}), flush=True)


def train(cfg, mix_name, seeds, controls, dev):
    from portbench.lib import check, traffic
    from portbench.lib.train import Train
    from portbench.reference import lowp
    mix = traffic.load(mix_name)
    for i, seed in enumerate(seeds):
        t0 = time.time()
        t = Train(cfg, mix, seed, dev)
        t.close()
        ref = t.reference()
        out = {"seed": seed, **t.readings(ref),
               "worst_grad": _worst(check.leaf_gaps(t.p_grad, ref["grad"], ref["grad"])),
               "worst_change": _worst(check.leaf_gaps(t.p_change, ref["change"], ref["grad"])),
               "losses": t.p_losses, "ref_losses": ref["losses"]}
        if i < controls:
            ctl = t.reference(quant=lowp.fp8)
            out["control"] = t.readings(ref, ctl)
            out["half_batch"] = t.readings(ref, t.reference(half_batch=True))
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("serve", "train"), required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--sweep", default="",
                    help="serve: offered rates (requests/s, comma-separated) to sweep instead")
    ap.add_argument("--mix", default=None,
                    help="the mix (default clinic_study_mix to serve, cv_fold_epochs to train)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py reads the card: no CUDA device")
    with open(ROOT / "portbench" / "configs" / f"{args.config}.json") as f:
        cfg = json.load(f)
    dev = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    mix = args.mix or {"serve": "clinic_study_mix", "train": "cv_fold_epochs"}[args.kind]
    if args.kind == "serve" and args.sweep:
        sweep(cfg, mix, seeds[0], args.seconds, [float(r) for r in args.sweep.split(",")], dev)
    elif args.kind == "serve":
        serve(cfg, mix, seeds, args.controls, args.seconds, dev)
    else:
        train(cfg, mix, seeds, args.controls, dev)


if __name__ == "__main__":
    main()
