"""Driver of the serving mixes (traffic files of kind "serve"): a fold
ensemble behind `EnsemblePredictor.predict_proba`, offered requests at a
fixed rate above what it sustains, and its check against the plain
reference.

Set-up makes the request pool and the fold weights from the seed (the
configuration's model family's serving weights: the ResNet's BatchNorm
statistics are calibrated by the reference on a few pool volumes, so the
eval-mode network sees normalized activations, as a trained one does),
builds the predictor, quantizes it for int8 mixes, and serves every shape
of the window once. A mix whose precision the family does not serve is
refused before set-up. The window offers the seeded requests at
the mix's fixed rate, served by one caller in order; above the knee a
backlog waits from the first requests on, so the window measures the
volumes answered a second. After it a seeded sample of the requests that
were due but not yet served is answered, late, and the reference works out
every pool volume's fold-mean probabilities: each answer is compared with
its volume's.

"""

from __future__ import annotations

import gc
import time
from functools import partial

import numpy as np
import torch

from portbench.lib import check, family, inputs, traffic
from portbench.lib.trace import REQUEST_SPAN
from portbench.reference import data as ref_data

LATE_SAMPLE = 16  # requests due in the window but not started, answered after it for the check


def _program():
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    return EnsemblePredictor


def _ncdhw(vols: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(vols)).to(device)
    return ref_data.normalize(x).unsqueeze(1)


class Serve:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.family = family.of(cfg)
        if mix["precision"] not in self.family.precisions:
            raise ValueError(f"portbench: model family {cfg['model_type']!r} serves "
                             f"{', '.join(self.family.precisions)}, not {mix['precision']!r}")
        self.dev = torch.device(device)
        self.shape = tuple(cfg["input_shape"])
        self.bs = cfg["batch_size"]
        self.int8 = mix["precision"] == "int8"
        self.phases = [("start", time.perf_counter())]
        self.pool = inputs.brain_volumes(mix["pool_volumes"], self.shape,
                                         inputs.sub_seed(seed, "pool"), self.dev)
        calib = _ncdhw(self.pool[:mix["bn_calibration_volumes"]], self.dev)
        self.fold_sds = []
        for f in range(cfg["n_splits"]):
            with _reference_precision():
                self.fold_sds.append(
                    self.family.serving_weights(cfg, seed, f, calib, self.dev))
        del calib
        self.phases.append(("pool and fold weights made", time.perf_counter()))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        predictor = _program()
        template = self.family.program_model(cfg, self.dev)
        self.pred = predictor(template, self.fold_sds, batch_size=self.bs,
                              normalizer=cfg["normalizer"], device=self.dev)
        self.fold_sds = [{k: v.cpu() for k, v in sd.items()} for sd in self.fold_sds]
        self.phases.append(("predictor built", time.perf_counter()))
        if self.int8:
            self.pred.quantize_int8(self.pool[:mix["calibration_volumes"]])
            self.phases.append(("quantize_int8", time.perf_counter()))
        for n in (self.bs, 1, self.bs):  # every shape the window serves: one padded batch
            self.pred.predict_proba(self.pool[:n])
            self.phases.append((f"warm-up request of {n}", time.perf_counter()))
        self.requests = traffic.serve_requests(mix, seed)
        self.served = []  # (pool start, n, probabilities, seconds)
        self.traced = None

    def window(self, seconds: float, trace_seconds: float | None = None,
               rate: float | None = None) -> dict:
        """Request k is due at its seeded arrival, at `rate` requests a
        second (the mix's `rate_per_s` by default), and served in order,
        one at a time, as soon as it is due and the one before it has
        answered. The window closes at the first answer after `seconds`:
        it holds every request started before then, and ends with the
        last answer. Afterwards LATE_SAMPLE of the requests due in the
        window but not started, drawn from the seed, are answered for the
        check. A request's latency runs from when it was due until its
        probabilities are on the host. With `trace_seconds` the profiler
        records the requests started in the window's first
        `trace_seconds`."""
        rate = rate or self.mix["rate_per_s"]
        prof, first = None, len(self.served)
        if trace_seconds:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        end, k = t0, 0
        while end - t0 < seconds:
            start, n, arrival = self.requests[k]
            k += 1
            wait = t0 + arrival / rate - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with torch.profiler.record_function(REQUEST_SPAN):
                p = self.pred.predict_proba(self.pool[start:start + n])
            end = time.perf_counter()
            self.served.append((start, n, p, end - t0 - arrival / rate))
            if prof is not None and end - t0 >= trace_seconds:
                prof.__exit__(None, None, None)
                self.traced, prof = (prof, first, len(self.served), end - t0), None
        if prof is not None:
            prof.__exit__(None, None, None)
            self.traced = (prof, first, len(self.served), end - t0)
        done = self.served[first:]
        due = sum(1 for *_, arrival in self.requests[k:] if arrival / rate < end - t0)
        self._answer_late(k, due)
        return {"requests": len(done), "volumes": sum(n for _, n, _, _ in done),
                "window_s": end - t0, "latencies_s": [s for *_, s in done],
                "backlog": due}

    def _answer_late(self, k: int, due: int) -> None:
        """Answer a seeded sample of the `due` requests after the k-th that
        were due in the window but not started in it (late, not wrong:
        they are compared as every other answer)."""
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "late"))
        for j in sorted(rng.permutation(due)[:LATE_SAMPLE]):
            start, n, _ = self.requests[k + int(j)]
            self.served.append((start, n, self.pred.predict_proba(self.pool[start:start + n]),
                                float("nan")))

    def trace_context(self, summary: dict) -> dict:
        """What the per-layer readers take from a traced window: the trace's
        reduction and the shapes of the work the traced requests gave the
        program (see portbench/README.md)."""
        _, a, b, _ = self.traced
        reqs = self.served[a:b]
        chunks = [min(self.bs, n - i) for _, n, _, _ in reqs for i in range(0, n, self.bs)]
        return {**summary, "kind": "serve", "model": self.family.describe(self.cfg),
                "batch": self.bs,
                "precision": self.mix["precision"],
                # one K1 launch per chunk: (rows, distinct source rows,
                # source bytes a voxel, output bytes a voxel)
                "k1_launches": [(self.bs, real, 4, 2) for real in chunks],
                "forwards": len(chunks) * self.cfg["n_splits"],
                "volumes_forward": sum(chunks) * self.cfg["n_splits"]}

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        del self.pred
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------

    def reference_proba(self, levels: int | None = None) -> np.ndarray:
        """(pool, classes) fold-mean probabilities of the plain reference:
        float32, or with `levels` the family's int8 model (127) or its 4-bit
        control (7)."""
        acc = None
        with _reference_precision():
            for sd in self.fold_sds:
                sd = {k: v.to(self.dev) for k, v in sd.items()}
                if levels is None:
                    forward = partial(self.family.reference_forward, sd, cfg=self.cfg)
                else:
                    calib = _ncdhw(self.pool[:self.mix["calibration_volumes"]], self.dev)
                    forward = self.family.int8_forward(sd, calib, self.cfg, levels)
                    del calib
                probs = []
                for s in range(0, len(self.pool), self.bs):
                    x = _ncdhw(self.pool[s:s + self.bs], self.dev)
                    with torch.no_grad():
                        logits = forward(x)
                    probs.append(torch.softmax(logits, dim=-1).double().cpu())
                p = torch.cat(probs)
                acc = p if acc is None else acc + p
        return (acc / len(self.fold_sds)).numpy()

    def readings(self, reference: np.ndarray) -> dict:
        """prob_gap: the widest gap of any served answer from its pool
        volume's reference probabilities."""
        served = np.concatenate([p for _, _, p, _ in self.served])
        expect = np.concatenate([reference[s:s + n] for s, n, _, _ in self.served])
        return {"prob_gap": check.prob_gap(served, expect)}

    def check(self) -> dict:
        """The compared numbers against the reference (float32, or the
        int8 reference for an int8 mix)."""
        return self.readings(self.reference_proba(127 if self.int8 else None))


class _reference_precision:
    """float32 without TF32, cuDNN's heuristic algorithms (no autotune)."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = b.cudnn.benchmark = False

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = self.saved
