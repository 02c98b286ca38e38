"""K-fold out-of-fold embedding harness and the ensemble embedder (own copy
of the TPU package's tabular/embedding.py).

`OoFEmbedding` follows the reference's TabPFNEmbedding:

- n_fold == 0: fit on the full train set; embeddings for the requested
  split come from that single fit;
- n_fold >= 2 and data_source == 'train': KFold(shuffle=False) over the
  train set; fit on k-1 folds, embed the held-out fold as 'test' data,
  concatenate along the sample axis (axis=1 of the (n_estimators, n, d)
  stack);
- n_fold >= 2 and data_source == 'test': single full fit;
- n_fold == 1: error.

The embedder is pluggable: anything with fit(X, y) and
get_embeddings(X, data_source) -> (n_estimators, n, d).

`select_embedder_params` is host-only: it imports sklearn's SVC and
cross-validation inside, and the card's machine has no sklearn. Unlike the
TPU package's, it raises ValueError on duplicate candidate names, where
that one lets a later candidate overwrite an earlier one's score.
"""

from __future__ import annotations

import os

import numpy as np

from .estimator import KFold


class OoFEmbedding:
    def __init__(self, embedder=None, n_fold: int = 0):
        self.model = embedder
        self.n_fold = n_fold

    def fit(self, X_train, y_train):
        if self.model is None:
            raise ValueError("No model has been set.")
        self.model.fit(X_train, y_train)

    def get_embeddings(self, X_train, y_train, X, data_source: str):
        if self.model is None:
            raise ValueError("No model has been set.")
        X_train = np.asarray(X_train)
        y_train = np.asarray(y_train)
        X = np.asarray(X)

        if self.n_fold == 0:
            self.model.fit(X_train, y_train)
            return np.asarray(self.model.get_embeddings(X, data_source=data_source))
        if self.n_fold >= 2:
            if data_source == "test":
                self.model.fit(X_train, y_train)
                return np.asarray(
                    self.model.get_embeddings(X, data_source=data_source))
            kf = KFold(n_splits=self.n_fold, shuffle=False)
            embeddings = []
            for tr_idx, val_idx in kf.split(X_train):
                self.model.fit(X_train[tr_idx], y_train[tr_idx])
                embeddings.append(np.asarray(
                    self.model.get_embeddings(X_train[val_idx],
                                              data_source="test")))
            return np.concatenate(embeddings, axis=1)
        raise ValueError("n_fold must be greater than 1.")


# Alias mirroring the reference export name
TabPFNEmbedding = OoFEmbedding


def embedder_asset_path() -> str:
    """Bundled EMBEDDER asset location (override: MAD_ICL_EMBED_ASSET): a
    separate asset from the classifier's, continued with an embedding
    objective."""
    from .icl import _assets_dir

    return os.environ.get("MAD_ICL_EMBED_ASSET") or os.path.join(
        _assets_dir(), "icl_embedder.msgpack")


def load_embedder_params():
    """Embedder-asset weights for the default ICLConfig under the shared
    `resolve_asset_params` policy; None (members fall back to the classifier
    default asset) when no embedder asset applies."""
    from .icl import ICLConfig, _load_params_file, resolve_asset_params

    cfg = ICLConfig()
    return resolve_asset_params(
        lambda p: _load_params_file(cfg, p), "MAD_ICL_EMBED_ASSET",
        os.path.normpath(embedder_asset_path()), True, f"ICLConfig {cfg}")


def select_embedder_params(X, y, candidates, *, n_fold: int = 5,
                           cv: int = 5, make_embedder=None,
                           downstream=None, seed: int = 0,
                           verbose: bool = False, device: str = "cuda"):
    """Pick embedder weights by TRAIN-split-only cross-validation of the
    downstream linear model (host-only: sklearn's SVC and cross_val_score).

    Args:
      X, y: the TRAIN split only.
      candidates: ``(name, params)`` pairs (or bare weight trees, named
        ``cand{i}``) for the default ICLConfig; the names must be distinct.
      n_fold: OoF folds for the embedding harness (reference default 5).
      cv: stratified CV folds for the downstream score.
      make_embedder: ``params -> embedder`` factory; defaults to
        ``EnsembleICLEmbedder(params=params, device=device)``.
      downstream: estimator factory; defaults to StandardScaler + linear
        SVC.

    Returns ``(best_name, best_params, scores)`` with ``scores`` a
    ``{name: train_cv_accuracy}`` dict.
    """
    from sklearn.model_selection import StratifiedKFold, cross_val_score
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    X = np.asarray(X)
    y = np.asarray(y)
    named = [c if isinstance(c, tuple) else (f"cand{i}", c)
             for i, c in enumerate(candidates)]
    if not named:
        raise ValueError("no candidates")
    names = [name for name, _ in named]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(f"duplicate candidate names {dupes}: each candidate "
                         "needs its own name, or one would overwrite another's score")
    if n_fold < 2:
        raise ValueError("asset selection needs out-of-fold embeddings "
                         "(n_fold >= 2); in-fold embeddings would score "
                         "memorization, not transfer")
    if make_embedder is None:
        make_embedder = lambda p: EnsembleICLEmbedder(params=p, device=device)  # noqa: E731
    if downstream is None:
        downstream = lambda: make_pipeline(  # noqa: E731
            StandardScaler(), SVC(kernel="linear"))
    skf = StratifiedKFold(n_splits=cv, shuffle=True, random_state=seed)
    scores = {}
    for name, params in named:
        oof = OoFEmbedding(make_embedder(params), n_fold=n_fold)
        emb = oof.get_embeddings(X, y, X[:1], data_source="train")[0]
        scores[name] = float(
            cross_val_score(downstream(), emb, y, cv=skf, n_jobs=1).mean())
        if verbose:
            print(f"[select_embedder] {name}: train-CV {scores[name]:.4f}")
    best = max(scores, key=scores.get)
    return best, dict(named)[best], scores


#: preprocess/seed-diverse member recipe for EnsembleICLEmbedder, each
#: FIXED per member so every K-fold refit gives the same representation
#: geometry; 4 views a member
DEFAULT_MEMBER_SPECS = (
    {"preprocess": None, "seed": 0, "n_estimators": 4},
    {"preprocess": "whiten", "seed": 1, "n_estimators": 4},
    {"preprocess": "quantile", "seed": 2, "n_estimators": 4},
    {"preprocess": "pairs", "seed": 3, "n_estimators": 4},
    {"preprocess": None, "seed": 4, "screen_features": 32,
     "n_estimators": 4},
    {"preprocess": "quantile", "seed": 5, "screen_features": 32,
     "n_estimators": 4},
)


class EnsembleICLEmbedder:
    """Diversity-ensemble embedder: concatenates the embeddings of
    preprocess/seed-diverse ICLClassifier members (each under a fixed
    transform; a downstream linear model learns which members to trust).
    Satisfies the OoFEmbedding contract (fit / get_embeddings -> (1, n,
    d)). With neither `params` nor `cfg` the members run the embedder asset
    (`load_embedder_params`), falling back to the classifier's when it does
    not apply; all members share one network on `device`."""

    def __init__(self, specs=None, embedding_kind: str = "rich",
                 cfg=None, params=None, device: str = "cuda"):
        from .icl import ICLClassifier

        self.specs = tuple(dict(s) for s in (specs or DEFAULT_MEMBER_SPECS))
        self.embedding_kind = embedding_kind
        self.device = device
        if params is None and cfg is None:
            params = load_embedder_params()
        self.members = [
            ICLClassifier(cfg=cfg, params=params, embedding_kind=embedding_kind,
                          device=device, **s)
            for s in self.specs]

    def fit(self, X, y):
        for m in self.members:
            m.fit(X, y)
        return self

    def get_embeddings(self, X, data_source: str = "test"):
        embs = [m.get_embeddings(X, data_source)[0] for m in self.members]
        return np.concatenate(embs, axis=1)[None]
