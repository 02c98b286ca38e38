"""The predictor's spans and row counters (`utils/profiling.py::annotate`,
`count`, `totals`, `reset`; `serve.py::EnsemblePredictor`) and the
benchmark's four `predict_*` readers that take them, on the CPU.

Without a profiler recording, a span records nothing and builds no
`record_function`; under one, `predict_proba` records one request span,
per chunk an upload, a normalize and a fetch span, a fold span per fold
and chunk, and the real and padded rows it forwards. The readers give
nothing outside serving or where the program keeps no totals, and the
harness at a tiny size reads all four from a traced window."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.serve import EnsemblePredictor, bucket
from multimodal_ad_tpu_torch.utils import profiling
from test_torch_port_support import cap_torch_threads, run_ranks

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "portbench" / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "portbench" / "tests"))

SHAPE = (12, 14, 12)
READERS = ("predict_upload_share", "predict_launch_share", "predict_fetch_share",
           "predict_pad_share")
CHILDREN = ("predict.upload", "predict.normalize", "predict.fold", "predict.fetch")


def _predictor(mesh=None) -> EnsemblePredictor:
    sds = [generate_model(model_depth=10, compute_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(s)).state_dict()
           for s in (1, 2)]
    return EnsemblePredictor(generate_model(model_depth=10, compute_dtype=torch.float32),
                             sds, batch_size=4, device="cpu", mesh=mesh)


def _volumes(n: int = 11) -> np.ndarray:
    return np.random.default_rng(0).random((n,) + SHAPE, dtype=np.float32)


def _reader(name: str):
    from portbench import run
    return run.reader(name)


@pytest.fixture
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def test_without_a_profiler_nothing_is_recorded(monkeypatch, fresh_totals):
    def no_record_function(*a, **k):
        raise AssertionError("annotate built a record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    proba = _predictor().predict_proba(_volumes())
    with profiling.annotate("predict.request"):
        profiling.count("predict.rows_real", 3)
    assert proba.shape == (11, 2)
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_predict_proba_records_its_spans_and_rows(fresh_totals):
    """11 volumes at batch 4 (chunks 4 + 4 + 3), 2 folds."""
    pred = _predictor()
    vols = _volumes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proba = pred.predict_proba(vols)
    t = profiling.totals()
    counts = {name: c for name, (c, _) in t["spans"].items()}
    assert counts == {"predict.request": 1, "predict.upload": 3, "predict.normalize": 3,
                      "predict.fold": 6, "predict.fetch": 3}
    assert t["counters"] == {"predict.rows_real": 11, "predict.rows_padded": 1}
    assert set(counts) <= {e.key for e in prof.key_averages()}
    request_s = t["spans"]["predict.request"][1]
    assert 0 < sum(t["spans"][n][1] for n in CHILDREN) <= request_s
    # the spans change nothing of the answer
    np.testing.assert_array_equal(proba, pred.predict_proba(vols))
    assert profiling.totals() == t  # no profiler, no further totals


def test_totals_accumulate_until_reset(fresh_totals):
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.annotate("mad_span"):
                profiling.count("mad_rows", 5)
    t = profiling.totals()
    assert t["spans"]["mad_span"][0] == 2 and t["spans"]["mad_span"][1] >= 0
    assert t["counters"] == {"mad_rows": 10}
    t["counters"]["mad_rows"] = 0  # a copy
    assert profiling.totals()["counters"] == {"mad_rows": 10}
    profiling.reset()
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_quantize_int8_records_no_predictor_span(fresh_totals):
    pred = _predictor()
    with profile(activities=[ProfilerActivity.CPU]):
        pred.quantize_int8(_volumes(5))
    assert not [n for n in profiling.totals()["spans"] if n.startswith("predict.")]
    assert not profiling.totals()["counters"]


def _rank_rows(vols):
    pred = _predictor(pmesh.make_mesh())
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        pred.predict_proba(vols)
    return profiling.totals()


def test_each_rank_counts_its_own_rows(tmp_path):
    """At W = 2 and batch 4 rank 0 forwards rows 0-1 of each chunk, rank 1
    rows 2-3: of 11 volumes (chunks 4 + 4 + 3) rank 1 pads one row."""
    ranks = run_ranks(_rank_rows, 2, tmp_path, _volumes())
    assert [r["counters"] for r in ranks] == [
        {"predict.rows_real": 6, "predict.rows_padded": 0},
        {"predict.rows_real": 5, "predict.rows_padded": 1}]
    for r in ranks:
        assert r["spans"]["predict.fold"][0] == 6 and r["spans"]["predict.fetch"][0] == 3


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_nothing_without_the_programs_totals(name, monkeypatch, fresh_totals):
    read = _reader(name)
    assert read({"kind": "serve"}) is None  # an empty registry
    with profile(activities=[ProfilerActivity.CPU]):
        _predictor().predict_proba(_volumes(3))
    assert read({"kind": "train"}) is None
    assert read({"kind": "serve"}) is not None
    monkeypatch.delattr(profiling, "totals")  # the program before its spans
    assert read({"kind": "serve"}) is None


def test_the_harness_reads_the_four_metrics_from_a_traced_window(fresh_totals):
    """A traced window of the tiny bf16 serving cell on the CPU: the pad
    share equals, to the bit, the padding of the traced requests' chunks;
    the host shares divide the requests' host time."""
    import portbench_tiny
    from portbench import run
    from portbench.lib import trace as tr
    from portbench.lib.serve import Serve

    cell = portbench_tiny.cell("r18_serve_bf16")
    s = Serve(portbench_tiny.config(), portbench_tiny.mix(cell["traffic"]), 2 ** 31 + 29,
              "cpu")
    s.window(2.0, 1.5)
    s.close()
    prof, a, b, traced_s = s.traced
    ctx = s.trace_context(tr.reduce(prof, traced_s))
    names = [m["name"] for m in run.cell_metrics(portbench_tiny.manifest(), "per_layer",
                                                 cell["name"])]
    assert set(READERS) <= set(names)
    got = {name: _reader(name)(ctx) for name in READERS}
    chunks = [min(s.bs, n - i) for _, n, _, _ in s.served[a:b] for i in range(0, n, s.bs)]
    real, padded = sum(chunks), sum(bucket(c, s.bs) - c for c in chunks)
    assert got["predict_pad_share"] == 100.0 * padded / (real + padded)
    host = [got[n] for n in READERS[:3]]
    assert all(0 <= v <= 100 for v in host) and sum(host) <= 100, got
