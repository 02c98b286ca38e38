"""The predictor's batch buckets (`serve.py::bucket_sizes`, `bucket`,
`EnsemblePredictor.predict_proba`), on the CPU.

Each chunk of a request is forwarded at the smallest power of two below
the batch size, or the batch size, that holds its rows. A bucketed answer
equals the answer of the chunk padded to the whole batch; each fold sees
one forward a chunk, at the bucket; the first request of a volume shape
runs every bucket through one fold (cuDNN's heuristics below the batch
size, its autotune at it), and `quantize_int8` starts that over; the pad
counters count the rows up to the bucket."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.serve import EnsemblePredictor, bucket, bucket_sizes
from multimodal_ad_tpu_torch.utils import profiling
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SHAPE = (12, 14, 12)


def _predictor(batch_size: int, int8: bool = False) -> EnsemblePredictor:
    sds = [generate_model(model_depth=10, compute_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(s)).state_dict()
           for s in (3, 4)]
    pred = EnsemblePredictor(generate_model(model_depth=10, compute_dtype=torch.float32),
                             sds, batch_size=batch_size, device="cpu")
    if int8:
        pred.quantize_int8(_volumes(5, seed=9))
    return pred


def _volumes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((n,) + SHAPE, dtype=np.float32)


def _chunks(n: int, bs: int) -> list[int]:
    return [min(bs, n - i) for i in range(0, n, bs)]


def _padded_answer(pred: EnsemblePredictor, vols: np.ndarray) -> np.ndarray:
    """Every chunk padded to the whole batch, as before the buckets (on
    the predictor's device)."""
    bs = pred.batch_size
    return np.concatenate([
        pred.forward(pred._prep(torch.from_numpy(vols[i:i + bs]).to(pred.device), True))
        [:real].cpu().numpy()
        for i, real in zip(range(0, len(vols), bs), _chunks(len(vols), bs))])


class _Spy:
    """The batch of every call of each fold."""

    def __init__(self, folds):
        self.seen = [[] for _ in folds]
        for k, m in enumerate(folds):
            m.register_forward_pre_hook(lambda _m, args, k=k: self.seen[k].append(
                args[0].shape[0]))

    def take(self) -> list[list[int]]:
        seen, self.seen = self.seen, [[] for _ in self.seen]
        return seen


@pytest.mark.parametrize("batch_size, sizes", [
    (1, [1]), (2, [1, 2]), (3, [1, 2, 3]), (4, [1, 2, 4]), (6, [1, 2, 4, 6]),
    (8, [1, 2, 4, 8]), (9, [1, 2, 4, 8, 9])])
def test_bucket_sizes_and_the_bucket_of_each_row_count(batch_size, sizes):
    assert bucket_sizes(batch_size) == sizes
    for real in range(1, batch_size + 1):
        assert bucket(real, batch_size) == min(b for b in sizes if b >= real)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("batch_size", [3, 4])
def test_bucketed_answers_equal_the_padded_ones(batch_size, int8):
    """Every request size from 1 to 2 * bs + 1."""
    pred = _predictor(batch_size, int8)
    vols = _volumes(2 * batch_size + 1, seed=1)
    for n in range(1, 2 * batch_size + 2):
        got = pred.predict_proba(vols[:n])
        assert got.shape == (n, 2)
        np.testing.assert_allclose(got, _padded_answer(pred, vols[:n]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_one_forward_a_chunk_a_fold_at_its_bucket(int8):
    """At batch 4 the first request (3 volumes) forwards fold 1 also at 1
    and 2 rows; later requests of any size forward each fold once a chunk
    at the chunk's bucket, and bring no new batch."""
    pred = _predictor(4, int8)
    spy = _Spy(pred.int8_folds or pred.folds)
    pred.predict_proba(_volumes(3))
    first = spy.take()
    assert first == [[1, 2, 4], [4]]
    for n in range(1, 10):
        pred.predict_proba(_volumes(n, seed=n))
        want = [bucket(c, 4) for c in _chunks(n, 4)]
        assert spy.take() == [want, want], n
    assert set(bucket_sizes(4)) == set(first[0])


def test_quantize_int8_warms_the_buckets_again():
    pred = _predictor(4)
    pred.predict_proba(_volumes(4))
    pred.quantize_int8(_volumes(5, seed=9))
    spy = _Spy(pred.int8_folds)
    pred.predict_proba(_volumes(4))
    assert spy.take() == [[1, 2, 4], [4]]
    pred.predict_proba(_volumes(1))
    assert spy.take() == [[1], [1]]


def test_a_new_volume_shape_warms_its_buckets():
    """A first chunk below the batch size also runs the whole batch."""
    pred = _predictor(4)
    spy = _Spy(pred.folds)
    pred.predict_proba(_volumes(1))
    assert spy.take() == [[1, 2, 4, 1], [1]]
    other = np.random.default_rng(2).random((2, 12, 14, 10), dtype=np.float32)
    pred.predict_proba(other)
    assert spy.take() == [[1, 2, 4, 2], [2]]
    pred.predict_proba(_volumes(2))
    assert spy.take() == [[2], [2]]


@pytest.mark.parametrize("first", [1, 4])
def test_buckets_below_the_batch_warm_on_cudnns_heuristics(first, monkeypatch):
    """cuDNN's autotune is off while the buckets below the batch size
    warm, on for the whole batch and the chunks' own forwards, and left
    as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    pred = _predictor(4)
    tuned = []
    pred.folds[0].register_forward_pre_hook(
        lambda _m, args: tuned.append((args[0].shape[0], torch.backends.cudnn.benchmark)))
    pred.predict_proba(_volumes(first))
    pred.predict_proba(_volumes(3))
    assert tuned == [(1, False), (2, False), (4, True)] + [(first, True)] * (first < 4) + [
        (4, True)]
    assert torch.backends.cudnn.benchmark is True


@pytest.mark.parametrize("n", [1, 3, 5, 7, 8, 11])
def test_pad_counters_count_rows_up_to_the_bucket(n):
    pred = _predictor(4)
    pred.predict_proba(_volumes(4))  # warm outside the profiler
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pred.predict_proba(_volumes(n))
        chunks = _chunks(n, 4)
        assert profiling.totals()["counters"] == {
            "predict.rows_real": n,
            "predict.rows_padded": sum(bucket(c, 4) - c for c in chunks)}
    finally:
        profiling.reset()
