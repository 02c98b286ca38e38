"""The sklearn parts of the tabular inference path, without sklearn.

The card's machine has no sklearn. The in-context estimators need:

- a small `BaseEstimator` (`get_params` / `set_params` read the
  constructor's signature), `clone`, `ClassifierMixin` / `RegressorMixin`
  (`score`) and `is_regressor`;
- the width screen's `f_classif` and `f_regression`;
- the 'quantile' transform's `QuantileTransformer`;
- `train_test_split` (plain, and stratified through
  `data/splits.py::stratified_indices`), `KFold` and `StratifiedKFold`
  (through `data/splits.py::stratified_fold_ids`).

Each computes what sklearn 1.9 computes, with the same numpy operations on
the same dtypes, so a screen or a transform picks the same columns and
gives the same values (tests/test_torch_port_tabular_io.py holds them to
sklearn). scipy is imported inside the functions that use it.
"""

from __future__ import annotations

import copy
import inspect
import warnings
from collections import defaultdict

import numpy as np

from ..data.splits import _split_sizes, stratified_fold_ids, stratified_indices

#: sklearn's margin around the fitted quantile range (preprocessing/_data.py)
BOUNDS_THRESHOLD = 1e-7


class BaseEstimator:
    """`get_params` / `set_params` over the constructor's named arguments,
    which the subclass stores as attributes of the same names."""

    @classmethod
    def _get_param_names(cls) -> list:
        init = cls.__init__
        if init is object.__init__:
            return []
        params = [p for p in inspect.signature(init).parameters.values()
                  if p.name != "self" and p.kind != p.VAR_KEYWORD]
        for p in params:
            if p.kind == p.VAR_POSITIONAL:
                raise RuntimeError(f"{cls.__name__}.__init__ takes *args; "
                                   "estimators name every parameter")
        return sorted(p.name for p in params)

    def get_params(self, deep: bool = True) -> dict:
        out = {}
        for key in self._get_param_names():
            value = getattr(self, key)
            if deep and hasattr(value, "get_params") and not isinstance(value, type):
                out.update((f"{key}__{k}", v) for k, v in value.get_params().items())
            out[key] = value
        return out

    def set_params(self, **params):
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = defaultdict(dict)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key!r} for estimator {self}. "
                                 f"Valid parameters are: {sorted(self._get_param_names())!r}.")
            if delim:
                nested[key][sub_key] = value
            else:
                setattr(self, key, value)
                valid[key] = value
        for key, sub_params in nested.items():
            valid[key].set_params(**sub_params)
        return self

    def __repr__(self):
        return f"{type(self).__name__}()"

    def __sklearn_tags__(self):
        """sklearn's estimator tags, so sklearn's meta-estimators (voting,
        stacking, feature selection) take these estimators; only sklearn
        calls this, so sklearn is importable when it runs."""
        from sklearn.utils import ClassifierTags, RegressorTags, Tags, TargetTags

        kind = getattr(self, "_estimator_type", None)
        return Tags(estimator_type=kind, target_tags=TargetTags(required=kind is not None),
                    classifier_tags=ClassifierTags() if kind == "classifier" else None,
                    regressor_tags=RegressorTags() if kind == "regressor" else None)


class ClassifierMixin:
    _estimator_type = "classifier"

    def score(self, X, y) -> float:
        """Accuracy of `predict(X)` against `y`."""
        return float(np.mean(self.predict(X) == np.asarray(y)))


class RegressorMixin:
    _estimator_type = "regressor"

    def score(self, X, y) -> float:
        """R² of `predict(X)` against `y`."""
        y = np.asarray(y, np.float64)
        resid = ((y - np.asarray(self.predict(X), np.float64)) ** 2).sum()
        total = ((y - y.mean()) ** 2).sum()
        return float(1.0 - resid / total) if total else (1.0 if resid == 0 else 0.0)


def is_regressor(estimator) -> bool:
    return getattr(estimator, "_estimator_type", None) == "regressor"


def clone(estimator, *, safe: bool = True):
    """A new unfitted estimator with the same parameters (deep-copied where
    they are not estimators themselves), as sklearn's `clone`."""
    if isinstance(estimator, (list, tuple, set, frozenset)):
        return type(estimator)([clone(e, safe=safe) for e in estimator])
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        if not safe:
            return copy.deepcopy(estimator)
        raise TypeError(f"Cannot clone object {estimator!r} (type {type(estimator)}): "
                        "it does not implement a 'get_params' method.")
    params = {k: clone(v, safe=False)
              for k, v in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


def host_sklearn(module: str, what: str):
    """Import ``sklearn.<module>`` for a host-only wrapper; the ImportError
    says which wrapper needs scikit-learn (the card's machine has none)."""
    import importlib

    try:
        return importlib.import_module(f"sklearn.{module}")
    except ImportError as e:
        raise ImportError(f"{what} needs scikit-learn (sklearn.{module}), which is not "
                          "installed: it is a host-only wrapper") from e


def _as_float_array(a) -> np.ndarray:
    """sklearn's `as_float_array` for dense input: float32/64 kept, small
    integers to float32, the rest to float64."""
    a = np.asarray(a)
    if a.dtype in (np.float32, np.float64):
        return a
    if a.dtype.kind in "uib" and a.dtype.itemsize <= 4:
        return a.astype(np.float32)
    return a.astype(np.float64)


def _check_xy(X, y, dtype=None):
    X = np.asarray(X) if dtype is None else np.asarray(X, dtype)
    if X.dtype == object:
        X = X.astype(np.float64)
    y = np.asarray(y).ravel()
    if X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D array instead")
    if X.shape[0] != y.shape[0]:
        raise ValueError(f"Found input variables with inconsistent numbers of "
                         f"samples: [{X.shape[0]}, {y.shape[0]}]")
    if X.dtype.kind == "f" and not np.isfinite(X).all():
        raise ValueError("Input X contains NaN or infinity.")
    return X, y


def f_oneway(*args):
    """One-way ANOVA F-value of each column over the groups in `args`
    (sklearn's `f_oneway`, in the groups' own float dtype)."""
    from scipy import special

    n_classes = len(args)
    args = [_as_float_array(a) for a in args]
    n_samples_per_class = np.array([a.shape[0] for a in args])
    n_samples = np.sum(n_samples_per_class)
    ss_alldata = sum((a ** 2).sum(axis=0) for a in args)
    sums_args = [np.asarray(a.sum(axis=0)) for a in args]
    square_of_sums_alldata = sum(sums_args) ** 2
    square_of_sums_args = [s ** 2 for s in sums_args]
    sstot = ss_alldata - square_of_sums_alldata / float(n_samples)
    ssbn = 0.0
    for k, _ in enumerate(args):
        ssbn += square_of_sums_args[k] / n_samples_per_class[k]
    ssbn -= square_of_sums_alldata / float(n_samples)
    sswn = sstot - ssbn
    dfbn = n_classes - 1
    dfwn = n_samples - n_classes
    msb = ssbn / float(dfbn)
    msw = sswn / float(dfwn)
    constant = np.where(msw == 0.0)[0]
    if np.nonzero(msb)[0].size != msb.size and constant.size:
        warnings.warn(f"Features {constant} are constant.", UserWarning)
    f = np.asarray(msb / msw).ravel()
    return f, special.fdtrc(dfbn, dfwn, f)


def f_classif(X, y):
    """(F-value, p-value) of each column against the class labels `y`."""
    X, y = _check_xy(X, y)
    return f_oneway(*[X[y == k] for k in np.unique(y)])


def f_regression(X, y):
    """(F-value, p-value) of each column's centred correlation with `y`,
    `X` taken as float64; a perfect correlation gets float64's max and a
    constant column 0 (sklearn's `f_regression` with `force_finite`)."""
    from scipy import stats

    X, yc = _check_xy(X, y, np.float64)
    yc = yc - np.mean(yc)
    X_norms = np.sqrt(np.einsum("ij,ij->i", X.T, X.T) - X.shape[0] * X.mean(axis=0) ** 2)
    corr = yc @ X
    with np.errstate(divide="ignore", invalid="ignore"):
        corr /= X_norms
        corr /= np.linalg.norm(yc)
    corr[np.isnan(corr)] = 0.0
    dof = np.asarray(y).size - 2
    corr2 = corr ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        f = corr2 / (1 - corr2) * dof
        p = stats.f.sf(f, 1, dof)
    f[np.isinf(f)] = np.finfo(f.dtype).max
    nan = np.isnan(f)
    f[nan] = 0.0
    p[nan] = 1.0
    return f, p


class QuantileTransformer(BaseEstimator):
    """Per-column map through the empirical quantiles onto a standard
    normal (sklearn's dense `QuantileTransformer` with
    ``output_distribution="normal"``, the only one the path uses)."""

    def __init__(self, *, n_quantiles: int = 1000, output_distribution: str = "normal",
                 subsample: int | None = 10_000, random_state=None):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.subsample = subsample
        self.random_state = random_state

    @staticmethod
    def _check(X, copy: bool) -> np.ndarray:
        X = np.array(X, copy=copy) if copy else np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        if X.ndim != 2:
            raise ValueError(f"Expected 2D array, got {X.ndim}D array instead")
        if np.isinf(X).any():
            raise ValueError("Input X contains infinity.")
        return X

    def fit(self, X, y=None):
        if self.output_distribution != "normal":
            raise ValueError(f"output_distribution={self.output_distribution!r}: only "
                             "'normal' is supported")
        if self.subsample is not None and self.n_quantiles > self.subsample:
            raise ValueError("The number of quantiles cannot be greater than the "
                             f"number of samples used. Got {self.n_quantiles} "
                             f"quantiles and {self.subsample} samples.")
        X = self._check(X, copy=False)
        n_samples = X.shape[0]
        if self.n_quantiles > n_samples:
            warnings.warn(f"n_quantiles ({self.n_quantiles}) is greater than the total "
                          f"number of samples ({n_samples}). n_quantiles is set to "
                          "n_samples.")
        self.n_quantiles_ = max(1, min(self.n_quantiles, n_samples))
        self.references_ = np.linspace(0, 1, self.n_quantiles_, endpoint=True)
        if self.subsample is not None and self.subsample < n_samples:
            idx = np.arange(n_samples)  # sklearn's resample(replace=False)
            _random_state(self.random_state).shuffle(idx)
            X = X[idx[:self.subsample]]
        self.quantiles_ = np.nanpercentile(X, self.references_ * 100, axis=0)
        return self

    def _transform_col(self, X_col, quantiles):
        from scipy import stats

        with np.errstate(invalid="ignore"):
            lower_idx = X_col - BOUNDS_THRESHOLD < quantiles[0]
            upper_idx = X_col + BOUNDS_THRESHOLD > quantiles[-1]
        finite = ~np.isnan(X_col)
        x = X_col[finite]
        X_col[finite] = 0.5 * (np.interp(x, quantiles, self.references_)
                               - np.interp(-x, -quantiles[::-1], -self.references_[::-1]))
        X_col[upper_idx] = 1
        X_col[lower_idx] = 0
        with np.errstate(invalid="ignore"):
            X_col = stats.norm.ppf(X_col)
            clip_min = stats.norm.ppf(BOUNDS_THRESHOLD - np.spacing(1))
            clip_max = stats.norm.ppf(1 - (BOUNDS_THRESHOLD - np.spacing(1)))
            return np.clip(X_col, clip_min, clip_max)

    def transform(self, X):
        if not hasattr(self, "quantiles_"):
            raise RuntimeError("QuantileTransformer is not fitted yet")
        X = self._check(X, copy=True)
        for j in range(X.shape[1]):
            X[:, j] = self._transform_col(X[:, j], self.quantiles_[:, j])
        return X


def _random_state(seed) -> np.random.RandomState:
    """sklearn's `check_random_state` for an int, a RandomState or None."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def train_test_split(*arrays, test_size=0.25, random_state=None, stratify=None) -> list:
    """[a_train, a_test, b_train, b_test, ...] as sklearn's shuffled
    `train_test_split` (stratified splits through `stratified_indices`,
    which raises ValueError on a class of one member)."""
    if not arrays:
        raise ValueError("At least one array required as input")
    arrays = [a if isinstance(a, np.ndarray) else np.asarray(a) for a in arrays]
    n = len(arrays[0])
    if any(len(a) != n for a in arrays[1:]):
        raise ValueError(f"Found input variables with inconsistent numbers of "
                         f"samples: {[len(a) for a in arrays]}")
    n_train, n_test = _split_sizes(n, test_size)
    rng = _random_state(random_state)
    if stratify is not None:
        train, test = stratified_indices(stratify, test_size, rng)
    else:
        perm = rng.permutation(n)
        test, train = perm[:n_test], perm[n_test:n_test + n_train]
    out = []
    for a in arrays:
        out.extend([a[train], a[test]])
    return out


def _check_n_splits(n_splits) -> int:
    if int(n_splits) < 2:
        raise ValueError(f"k-fold cross-validation requires at least one "
                         f"train/test split by setting n_splits=2 or more, got "
                         f"n_splits={n_splits}.")
    return int(n_splits)


def _folds_to_splits(folds: np.ndarray, n_splits: int):
    """(train, test) index arrays, both ascending, of each fold in order."""
    idx = np.arange(len(folds))
    for k in range(n_splits):
        yield idx[folds != k], idx[folds == k]


class KFold:
    """Contiguous folds of ``arange(n)``, shuffled first by
    ``RandomState(random_state)`` when `shuffle` (sklearn's `KFold`)."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if not shuffle and random_state is not None:
            raise ValueError("Setting a random_state has no effect since shuffle is "
                             "False. You should leave random_state to its default "
                             "(None), or set shuffle=True.")
        self.n_splits = _check_n_splits(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        n = len(X)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} "
                             f"greater than the number of samples: n_samples={n}.")
        order = np.arange(n)
        if self.shuffle:
            _random_state(self.random_state).shuffle(order)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[:n % self.n_splits] += 1
        folds = np.empty(n, dtype=int)
        folds[order] = np.repeat(np.arange(self.n_splits), sizes)
        return _folds_to_splits(folds, self.n_splits)


class StratifiedKFold:
    """Shuffled folds that keep each class's share (sklearn's
    `StratifiedKFold(shuffle=True)`): the fold of each sample from
    `data/splits.py::stratified_fold_ids`."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if not shuffle:
            raise ValueError("only StratifiedKFold(shuffle=True) is ported")
        self.n_splits = _check_n_splits(n_splits)
        self.random_state = random_state

    def split(self, X, y, groups=None):
        y = np.asarray(y)
        if self.n_splits > len(y):
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} "
                             f"greater than the number of samples: n_samples={len(y)}.")
        counts = np.unique(y, return_counts=True)[1]
        if self.n_splits > counts.min() and not np.all(self.n_splits > counts):
            warnings.warn(f"The least populated class in y has only {counts.min()} "
                          f"members, which is less than n_splits={self.n_splits}.",
                          UserWarning)
        folds = stratified_fold_ids(y, self.n_splits, _random_state(self.random_state))
        return _folds_to_splits(folds, self.n_splits)
