"""Tabular in-context learning: the inference path of the TPU package's
tabular stack (classifier, regressor, the ensemble embedder with its
out-of-fold harness, and the embedding pipelines), with the bundled
meta-trained weights. Meta-training and the meta-estimators built on
sklearn are not ported here."""

from .embedding import (DEFAULT_MEMBER_SPECS, EnsembleICLEmbedder, OoFEmbedding,
                        TabPFNEmbedding, select_embedder_params)
from .icl import ICLClassifier, ICLConfig, ICLTransformer
from .icl_regression import RegICLConfig, RegICLTransformer
from .regression import ICLRegressor
from .utils import (get_device, infer_categorical_features, is_icl_estimator,
                    product_dict, softmax)

# reference-name aliases (drop-in for tabpfn_extensions users)
TabPFNClassifier = ICLClassifier
TabPFNRegressor = ICLRegressor

__all__ = [
    "OoFEmbedding", "TabPFNEmbedding", "EnsembleICLEmbedder", "DEFAULT_MEMBER_SPECS",
    "select_embedder_params", "ICLClassifier", "ICLConfig", "ICLTransformer",
    "RegICLConfig", "RegICLTransformer", "ICLRegressor", "get_device",
    "infer_categorical_features", "is_icl_estimator", "product_dict", "softmax",
    "TabPFNClassifier", "TabPFNRegressor",
]
