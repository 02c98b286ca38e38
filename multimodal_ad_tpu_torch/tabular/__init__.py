"""The tabular in-context-learning stack (the TPU package's tabular/):
the classifier and regressor networks with their bundled meta-trained
weights and meta-training (`pretrain_icl`, `pretrain_icl_regression`), the
ensemble embedder with its out-of-fold harness, and the meta-estimators
built on them (many-class ECOC, the tree hybrids, TPE-guarded tuning, the
greedy ensembles, the unsupervised conditionals, Shapley attributions and
their figures), with the TabPFN-name aliases.

Importing it needs neither sklearn nor matplotlib: the wrappers that do
(the tree hybrids, voting and stacking, `feature_selection`, the figures,
`Experiment.plot`) import them when they run, and are host-only.
"""

from .embedding import (DEFAULT_MEMBER_SPECS, EnsembleICLEmbedder, OoFEmbedding,
                        TabPFNEmbedding, select_embedder_params)
from .ensembles import (AutoICLClassifier, GreedyWeightedEnsemble,
                        make_stacking_classifier, make_voting_classifier)
from .hpo import SeedEnsembleICL, TunedICLClassifier
from .icl import ICLClassifier, ICLConfig, ICLTransformer, pretrain_icl
from .icl_regression import RegICLConfig, RegICLTransformer, pretrain_icl_regression
from .many_class import ManyClassClassifier
from .plotting import plot_attribution_scatter, plot_attributions, plot_interactions
from .regression import (DecisionTreeICLRegressor, ICLRegressor,
                         RandomForestICLRegressor, TunedICLRegressor)
from .rf_icl import DecisionTreeICLClassifier, RandomForestICLClassifier
from .scoring import safe_roc_auc_score, score_classification, score_regression
from .unsupervised import TabularUnsupervisedModel
from .utils import (get_device, infer_categorical_features, is_icl_estimator,
                    product_dict, softmax)

# reference-name aliases (drop-in for tabpfn_extensions users)
AutoTabPFNClassifier = AutoICLClassifier
TunedTabPFNClassifier = TunedICLClassifier
TunedTabPFNRegressor = TunedICLRegressor
TabPFNUnsupervisedModel = TabularUnsupervisedModel
DecisionTreeTabPFNClassifier = DecisionTreeICLClassifier
RandomForestTabPFNClassifier = RandomForestICLClassifier
DecisionTreeTabPFNRegressor = DecisionTreeICLRegressor
RandomForestTabPFNRegressor = RandomForestICLRegressor
TabPFNClassifier = ICLClassifier
TabPFNRegressor = ICLRegressor

__all__ = [
    "OoFEmbedding", "TabPFNEmbedding", "EnsembleICLEmbedder", "DEFAULT_MEMBER_SPECS",
    "select_embedder_params", "ICLClassifier", "ICLConfig",
    "ICLTransformer", "pretrain_icl", "ManyClassClassifier",
    "AutoICLClassifier", "GreedyWeightedEnsemble", "TunedICLClassifier",
    "SeedEnsembleICL",
    "TabularUnsupervisedModel", "DecisionTreeICLClassifier",
    "RandomForestICLClassifier", "make_voting_classifier",
    "make_stacking_classifier", "safe_roc_auc_score",
    "score_classification", "score_regression",
    "RegICLConfig", "RegICLTransformer", "pretrain_icl_regression",
    "ICLRegressor", "TunedICLRegressor", "DecisionTreeICLRegressor",
    "RandomForestICLRegressor", "get_device", "infer_categorical_features",
    "is_icl_estimator", "product_dict", "softmax",
    "plot_attributions", "plot_attribution_scatter", "plot_interactions",
    "AutoTabPFNClassifier", "TunedTabPFNClassifier", "TunedTabPFNRegressor",
    "TabPFNUnsupervisedModel", "DecisionTreeTabPFNClassifier",
    "RandomForestTabPFNClassifier", "DecisionTreeTabPFNRegressor",
    "RandomForestTabPFNRegressor", "TabPFNClassifier", "TabPFNRegressor",
]
