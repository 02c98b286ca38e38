"""utils/torch_weights.py's ICL converters on read-only leaves: the state
dict they return owns its memory (each tensor a copy, none a view of a
leaf), and building it raises no warning, as for the image converters.
Leaves that are JAX arrays, or arrays of a read-only asset, are not
writable; a tensor made over one by `torch.from_numpy` warns that it is
not, and would alias the caller's array."""

import warnings

import numpy as np
import pytest

from multimodal_ad_tpu_torch.tabular.icl import ICLConfig, init_icl_params
from multimodal_ad_tpu_torch.tabular.icl_regression import RegICLConfig, init_reg_icl_params
from multimodal_ad_tpu_torch.utils.torch_weights import (icl_state_dict_from_flax,
                                                         reg_icl_state_dict_from_flax)
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SMALL = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=16)
CASES = {
    "classifier": (ICLConfig(max_classes=4, **SMALL), init_icl_params, icl_state_dict_from_flax),
    "regressor": (RegICLConfig(**SMALL), init_reg_icl_params, reg_icl_state_dict_from_flax),
}


def _read_only(tree, leaves):
    """`tree` with each leaf a read-only float32 array, collected in `leaves`."""
    if isinstance(tree, dict):
        return {k: _read_only(v, leaves) for k, v in tree.items()}
    leaf = np.array(tree, np.float32)
    leaf.setflags(write=False)
    leaves.append(leaf)
    return leaf


@pytest.mark.parametrize("kind", sorted(CASES))
def test_icl_converters_own_their_tensors(kind):
    cfg, init, convert = CASES[kind]
    leaves = []
    tree = _read_only(init(cfg, seed=1), leaves)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd = convert(tree, cfg)
    assert len(sd) == len(leaves)
    for name, t in sd.items():
        assert not any(np.shares_memory(t.numpy(), leaf) for leaf in leaves), name
        t.add_(1.0)  # writable, and the leaves stay as they were
    assert all(not leaf.flags.writeable for leaf in leaves)
