"""Port parity on the CPU: the 3-D U-Net and its weight converter.

The JAX UNet3D (float32) gets seeded numpy variables with randomized
BatchNorm scale/bias/mean and positive var, built from `jax.eval_shape`
so that nothing is initialized eagerly; the same variables go through
`unet3d_state_dict_from_flax` into the port's UNet3D. The segmentation map
and the 64-channel (here 8-channel) pre-head tap are held to
rtol = atol = 1e-4: both frameworks compute in float32 and sum in other
orders (measured errors are in PERF.md, scripts/port_parity_cpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_ad_tpu.models.unet3d import unet_forward_with_features
from multimodal_ad_tpu_torch.models.unet3d import UNet3D, _pad_to_multiple
from multimodal_ad_tpu_torch.utils.torch_weights import (
    unet3d_name_map, unet3d_state_dict_from_flax)
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

NARROW = dict(level_channels=(8, 16, 32), bottleneck_channel=64)
SMALL_SHAPE = (20, 24, 20)  # tests/conftest.py's volume shape


def random_unet_variables(model, shape, seed):
    """Seeded numpy variables: He-normal kernels, BN scale and var in
    [0.5, 1.5], biases and BN mean ~ N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape, 1), jnp.float32),
        train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def jax_forward(model, variables, x):
    out, feats = jax.jit(lambda v, x: unet_forward_with_features(model, v, x))(
        variables, jnp.asarray(x))
    return np.asarray(out), np.asarray(feats)


def port_unet(variables):
    tm = UNet3D(**NARROW).eval()
    sd = unet3d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    tm.load_state_dict(sd)  # strict: every key present, no extras
    return tm, sd


@pytest.mark.parametrize("shape", [(15, 17, 13), SMALL_SHAPE],
                         ids=lambda s: "x".join(map(str, s)))
def test_forward_and_tap_match_jax(shape):
    jm = JaxUNet3D(dtype=jnp.float32, **NARROW)
    variables = random_unet_variables(jm, shape, seed=sum(shape))
    x = np.random.default_rng(1).normal(size=(2, *shape, 1)).astype(np.float32)
    ref_out, ref_feats = jax_forward(jm, variables, x)
    tm, _ = port_unet(variables)
    with torch.no_grad():
        out, feats = tm(torch.from_numpy(x), return_features=True)
        out_only = tm(torch.from_numpy(x))
    assert out.shape == ref_out.shape == (2, *shape, 1)
    assert feats.shape == ref_feats.shape == (2, *shape, 8)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), ref_feats, rtol=1e-4, atol=1e-4)
    assert torch.equal(out_only, out)


def test_state_dict_keys_equal_the_converters():
    jm = JaxUNet3D(dtype=jnp.float32, **NARROW)
    variables = random_unet_variables(jm, (8, 8, 8), seed=0)
    tm, sd = port_unet(variables)
    assert set(tm.state_dict()) == set(sd)
    names = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert names == {row[0] for row in unet3d_name_map()}
    flax_leaves = {jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_leaves_with_path(variables)}
    assert len(flax_leaves) == len(names)  # every flax leaf is mapped once


def test_convtranspose_kernel_is_flipped():
    """flax ConvTranspose equals torch conv_transpose3d only with the
    kernel flipped in all three spatial axes."""
    from flax import linen as nn

    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, 4, 5, 2)).astype(np.float32)
    layer = nn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2))
    kernel = rng.normal(size=(2, 2, 2, 2, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    ref = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}},
                                 jnp.asarray(x)))
    row = next(r for r in unet3d_name_map() if r[0] == "dec3.upconv.weight")
    w = torch.from_numpy(np.ascontiguousarray(row[3](kernel)))
    ours = torch.nn.functional.conv_transpose3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), w, torch.from_numpy(bias),
        stride=2).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 4, 0, 1, 2)))
    assert not np.allclose(torch.nn.functional.conv_transpose3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), unflipped,
        torch.from_numpy(bias), stride=2).permute(0, 2, 3, 4, 1).numpy(), ref,
        atol=1e-3)


def test_pad_to_multiple_pads_right_only():
    x = torch.arange(2 * 91 * 109 * 91, dtype=torch.float32).reshape(1, 2, 91, 109, 91)
    y, crops = _pad_to_multiple(x)
    assert y.shape == (1, 2, 96, 112, 96) and crops == [91, 109, 91]
    assert torch.equal(y[:, :, :91, :109, :91], x)
    assert y[:, :, 91:].abs().sum() == 0 and y[..., 91:].abs().sum() == 0


def test_default_init_follows_flax():
    """lecun_normal kernels (std sqrt(1/fan_in) after truncation at two
    standard deviations), zero biases, BatchNorm at identity; one seed gives
    one network."""
    one, two = (UNet3D(generator=torch.Generator().manual_seed(7), **NARROW)
                for _ in range(2))
    for (name, p), q in zip(one.state_dict().items(), two.state_dict().values()):
        assert torch.equal(p, q), name
    a = UNet3D(generator=torch.Generator().manual_seed(7)).requires_grad_(False)
    for w, fan_in in ((a.enc2.conv2.weight, 27 * 64),
                      (a.dec3.conv1.weight, 27 * 768),
                      (a.dec3.upconv.weight, 8 * 512)):
        std = np.sqrt(1.0 / fan_in)
        assert abs(float(w.std()) / std - 1) < 0.02
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert all(float(m.bias.abs().max()) == 0 for m in a.modules()
               if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)))
    bn = a.head_block.bn2
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.bias, torch.zeros(64)) and torch.equal(bn.running_mean, torch.zeros(64))


def test_rejects_wrong_channel_count():
    with pytest.raises(ValueError, match="channels"):
        UNet3D(**NARROW)(torch.zeros((1, 8, 8, 8, 2)))
