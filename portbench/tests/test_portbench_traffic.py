"""The traffic generator: the same work for every seed, in another order."""

from collections import Counter

import numpy as np
import pytest

import portbench_tiny  # noqa: F401
from portbench.lib import traffic


def test_block_sizes_half_single_scans_half_studies():
    mix = traffic.load("clinic_study_mix")
    sizes = traffic.block_sizes(mix)
    assert len(sizes) == mix["block"] == 62
    assert sizes.count(1) == 31
    assert sorted(s for s in sizes if s > 1) == list(range(2, 33))


@pytest.mark.parametrize("name", ["clinic_study_mix", "clinic_study_mix_int8"])
def test_every_seed_is_offered_the_same_sizes_and_gaps_in_another_order(name):
    mix = traffic.load(name)
    block = len(traffic.block_sizes(mix))
    a = traffic.serve_requests(mix, 1)
    b = traffic.serve_requests(mix, 2 ** 31 + 77)
    assert [n for _, n, _ in a] != [n for _, n, _ in b]

    def gaps(reqs):
        t = np.asarray([0.0] + [arrival for *_, arrival in reqs])
        return np.diff(t)

    ga, gb = gaps(a), gaps(b)
    for k in range(0, len(a), block):
        assert Counter(n for _, n, _ in a[k:k + block]) == Counter(n for _, n, _ in b[k:k + block])
        assert np.allclose(np.sort(ga[k:k + block]), np.sort(gb[k:k + block]))
    assert np.mean(ga[:block]) == pytest.approx(1.0)  # arrivals in mean gaps
    for start, n, _ in a + b:
        assert 0 <= start and start + n <= mix["pool_volumes"]
    assert traffic.serve_requests(mix, 5) == traffic.serve_requests(mix, 5)
    assert mix["rate_per_s"] >= 1.5 * max(mix["knee_per_s"])  # above what one caller sustains


def test_mean_real_volumes_per_chunk_of_eight():
    sizes = traffic.block_sizes(traffic.load("clinic_study_mix"))
    chunks = [min(8, n - i) for n in sizes for i in range(0, n, 8)]
    assert np.mean(chunks) == pytest.approx(5.1, abs=0.15)


def test_training_corpus_counts_and_split():
    mix = traffic.load("cv_fold_epochs")
    for seed in (3, 2 ** 31 + 9):
        plan = traffic.train_corpus(mix, seed)
        labels, train, val = plan["labels"], plan["train"], plan["val"]
        assert len(labels) == 722 and labels.sum() == 289  # AD:CN 2:3
        assert len(val) == 144 and len(train) == 578
        assert not set(train) & set(val)
        assert labels[val].sum() == round(144 * 289 / 722)
    a, b = traffic.train_corpus(mix, 1), traffic.train_corpus(mix, 2)
    assert not np.array_equal(a["labels"], b["labels"])
