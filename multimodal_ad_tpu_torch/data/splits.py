"""Deterministic dataset splitting with seed-42 parity, without sklearn.

The TPU package calls sklearn's ``train_test_split(stratify=...)`` and
``StratifiedKFold(shuffle=True)``. The card's machine has no sklearn, so
this module re-implements both paths in numpy, drawing from
``np.random.RandomState(seed)`` in the same order, so that the same
manifest gives the same membership and the same order:

- test split: the ``StratifiedShuffleSplit`` path of ``train_test_split``
  (per-class counts by ``_approximate_mode``, one permutation per class,
  then a permutation of the train and of the test indices);
- K-fold: ``StratifiedKFold._make_test_folds`` (classes in order of first
  appearance, round-robin allocation, one shuffle per class), with train
  and validation indices in ascending order.
"""

from __future__ import annotations

from math import ceil

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws closest to the multivariate hypergeometric mode;
    ties in the remainders are broken with `rng` (sklearn's
    ``utils.extmath._approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _split_sizes(n_samples: int, test_size: float) -> tuple[int, int]:
    """(n_train, n_test) for a float fraction or an int count, as sklearn's
    ``_validate_shuffle_split`` computes them."""
    if isinstance(test_size, (int, np.integer)) and not isinstance(test_size, bool):
        if not 0 < test_size < n_samples:
            raise ValueError(f"test_size={test_size} outside (0, {n_samples})")
        n_test = int(test_size)
    else:
        if not 0.0 < test_size < 1.0:
            raise ValueError(f"test_size={test_size} outside (0, 1)")
        n_test = ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"test_size={test_size} leaves no training samples")
    return n_train, n_test


def stratified_indices(labels, test_size: float = 0.2, seed=42):
    """(train_indices, test_indices) of a stratified shuffled split; `seed`
    is an int or a `np.random.RandomState` to draw from."""
    y = np.asarray(labels)
    n_train, n_test = _split_sizes(len(y), test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"classes {classes[class_counts < 2].tolist()} have "
                         "fewer than 2 members")
    if min(n_train, n_test) < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) must each hold "
                         f"at least one sample of each of {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_test_split(records: list, test_size: float = 0.2, seed: int = 42):
    """(train_records, test_records), as sklearn's
    ``train_test_split(records, test_size=..., random_state=seed,
    stratify=labels)``."""
    train, test = stratified_indices([r["label"] for r in records],
                                     test_size, seed)
    return [records[i] for i in train], [records[i] for i in test]


def stratified_fold_ids(labels, n_splits: int = 5, seed=42) -> np.ndarray:
    """Validation fold (0..n_splits-1) of each sample, as
    ``StratifiedKFold(n_splits, shuffle=True, random_state=seed)``; `seed`
    is an int or a `np.random.RandomState` to draw from."""
    y = np.asarray(labels)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]  # classes numbered by first appearance
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        folds[y_encoded == k] = folds_for_class
    return folds


def stratified_kfold(records: list, n_splits: int = 5, seed: int = 42):
    """Yield (fold_index starting at 1, train_records, val_records)."""
    folds = stratified_fold_ids([r["label"] for r in records], n_splits, seed)
    for k in range(n_splits):
        yield (k + 1, [r for r, f in zip(records, folds) if f != k],
               [r for r, f in zip(records, folds) if f == k])
