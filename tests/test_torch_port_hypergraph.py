"""Port parity on the CPU: MSHyper, the multi-scale hypergraph forecaster.

The incidence matrix is equal to the JAX package's; `hypergraph_conv`
matches it with and without attention scores, and `MSHyperModel` forwards
match on weights carried over by `mshyper_state_dict_from_flax`, with and
without hyperedge attention (float32 in both; atol 1e-5: the frameworks
sum the dense incidence products in other orders). A few Adam steps lower
the forecasting loss on the persistence task of tests/test_hypergraph.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models import hypergraph as jhg
from multimodal_ad_tpu_torch.models import hypergraph as thg
from multimodal_ad_tpu_torch.utils.torch_weights import mshyper_state_dict_from_flax
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("seq_len,windows,inner", [(16, (4, 4), 3), (8, (2,), 2),
                                                   (96, (4, 4), 3), (10, (3, 2), 4)])
def test_incidence_matches_jax(seq_len, windows, inner):
    assert thg.build_pyramid_sizes(seq_len, windows) == jhg.build_pyramid_sizes(seq_len,
                                                                                windows)
    ours = thg.build_pyramid_incidence(seq_len, windows, inner)
    ref = jhg.build_pyramid_incidence(seq_len, windows, inner)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
def test_hypergraph_conv_matches_jax(attention):
    H = jhg.build_pyramid_incidence(16, (4, 4), 3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H.shape[0], 5)).astype(np.float32)
    scores = rng.uniform(size=(2, *H.shape)).astype(np.float32) if attention else None
    ref = np.asarray(jhg.hypergraph_conv(jnp.asarray(x), jnp.asarray(H),
                                         None if scores is None else jnp.asarray(scores)))
    ours = thg.hypergraph_conv(torch.from_numpy(x), torch.from_numpy(H),
                               None if scores is None else torch.from_numpy(scores))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_constant_signal_stays_constant():
    H = torch.from_numpy(thg.build_pyramid_incidence(6, (2,), inner_size=2))
    out = thg.hypergraph_conv(torch.full((1, H.shape[0], 4), 5.0), H)
    np.testing.assert_allclose(out.numpy(), 5.0, rtol=1e-6)


def _random_variables(jm, x, seed):
    """Seeded numpy variables of the JAX model's shapes (no flax init)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
def test_forward_matches_jax(attention):
    kw = dict(seq_len=16, pred_len=4, channels=3, d_model=8, window_sizes=(4, 4),
              inner_size=3, use_attention=attention)
    jm = jhg.MSHyperModel(**kw)
    x = (np.random.default_rng(1).normal(size=(2, 16, 3)) * 3 + 1).astype(np.float32)
    variables = _random_variables(jm, x, seed=2)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = thg.MSHyperModel(**kw)
    tm.load_state_dict(mshyper_state_dict_from_flax(variables, 2, attention))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 4, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_state_dict_keys_follow_name_map():
    from multimodal_ad_tpu_torch.utils.torch_weights import mshyper_name_map

    for attention in (False, True):
        tm = thg.MSHyperModel(16, 4, 3, d_model=8, window_sizes=(4, 2, 2),
                              use_attention=attention)
        assert set(tm.state_dict()) == {r[0] for r in mshyper_name_map(3, attention)}


def test_instance_norm_round_trip():
    """Scaling the input scales the forecast."""
    torch.manual_seed(0)
    tm = thg.MSHyperModel(16, 4, 2, d_model=16, use_attention=False)
    x = torch.randn(1, 16, 2)
    with torch.no_grad():
        np.testing.assert_allclose(tm(x * 10.0).numpy(), tm(x).numpy() * 10.0,
                                   rtol=1e-3, atol=1e-3)


def test_adam_steps_lower_the_loss():
    """tests/test_hypergraph.py's persistence task (AR(1) random walk, 20
    Adam steps at 1e-2), here with hyperedge attention too."""
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    series = torch.from_numpy(np.cumsum(rng.normal(size=(8, 20, 1)), axis=1)
                              .astype(np.float32))
    x, y = series[:, :16], series[:, 16:]
    for attention in (False, True):
        tm = thg.MSHyperModel(16, 4, 1, d_model=8, window_sizes=(4,),
                              use_attention=attention)
        opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
        with torch.no_grad():
            l0 = float(((tm(x) - y) ** 2).mean())
        for _ in range(20):
            opt.zero_grad()
            loss = ((tm(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
        with torch.no_grad():
            assert float(((tm(x) - y) ** 2).mean()) < l0
