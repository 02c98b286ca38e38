"""Port parity on the CPU: the 3D ResNet and the weight converter.

The JAX ResNet3D (dtype float32) gets seeded numpy variables with
randomized BatchNorm scale/bias/mean and positive var; the same variables
go through `state_dict_from_flax` into the port's ResNet3D. Eval-mode
outputs are held to rtol=atol=2e-3, the bound tests/test_torch_weights.py
uses for the MedicalNet forward parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D
from multimodal_ad_tpu.utils.torch_weights import \
    resnet3d_name_map as jax_name_map
from multimodal_ad_tpu_torch.models.resnet3d import (DEPTH_BLOCKS, ResNet3D,
                                                     generate_model,
                                                     image_encoder)
from multimodal_ad_tpu_torch.utils.torch_weights import (
    HEAD_NAMES, load_medicalnet_weights, resnet3d_name_map,
    state_dict_from_flax)
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


def random_flax_variables(model, shape, seed):
    """Seeded numpy variables for a JAX module: He-normal kernels, BN scale
    and var in [0.5, 1.5], BN bias and mean ~ N(0, 0.1)."""
    x = jnp.zeros((1, *shape), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, x, train=False))
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


PARITY_CASES = [
    # depth, shortcut, head, input (X, Y, Z, C)
    (10, "B", "classifier", (16, 16, 16, 1)),
    (10, "A", "none", (15, 17, 15, 1)),
    (18, "B", "classifier", (15, 17, 15, 1)),
    (18, "A", "pool", (16, 18, 16, 1)),
    (18, "B", "none", (17, 15, 13, 2)),
    (50, "B", "classifier", (12, 13, 12, 1)),
]


@pytest.mark.parametrize("depth,shortcut,head,shape", PARITY_CASES,
                         ids=[f"r{d}{s}-{h}-{'x'.join(map(str, sh))}"
                              for d, s, h, sh in PARITY_CASES])
def test_forward_matches_jax(depth, shortcut, head, shape):
    jm = JaxResNet3D(depth=depth, head=head, shortcut_type=shortcut,
                     in_channels=shape[-1], dtype=jnp.float32)
    variables = random_flax_variables(jm, shape, seed=depth)
    x = np.random.default_rng(1).normal(size=(2, *shape)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))

    tm = ResNet3D(depth=depth, head=head, shortcut_type=shortcut,
                  in_channels=shape[-1], compute_dtype=torch.float32).eval()
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                              depth, shortcut)
    tm.load_state_dict(sd)  # strict: every key present, no extras
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)

    names = {k for k in sd if not k.endswith("num_batches_tracked")}
    expected = {row[0] for row in resnet3d_name_map(depth, shortcut)}
    if head == "classifier":
        expected |= set(HEAD_NAMES)
    assert names == expected


def test_bf16_autocast_close_to_fp32():
    """compute_dtype=bfloat16 runs under autocast over fp32 parameters."""
    torch.manual_seed(0)
    m32 = ResNet3D(depth=10, compute_dtype=torch.float32).eval()
    m16 = ResNet3D(depth=10, compute_dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    x = torch.rand(2, 12, 14, 12, 1)
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.1, atol=0.1)


@pytest.mark.parametrize("depth", sorted(DEPTH_BLOCKS))
@pytest.mark.parametrize("shortcut", ["A", "B"])
def test_name_map_matches_jax(depth, shortcut):
    ours = [(t, c, p) for t, c, p, _ in resnet3d_name_map(depth, shortcut)]
    theirs = [(t, c, p) for t, c, p, _ in jax_name_map(depth, shortcut)]
    assert ours == theirs


@pytest.mark.parametrize("depth,shortcut", [(34, "A"), (50, "B")])
def test_state_dict_keys_follow_name_map(depth, shortcut):
    m = generate_model(model_depth=depth, resnet_shortcut=shortcut)
    keys = {k for k in m.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == {r[0] for r in resnet3d_name_map(depth, shortcut)} | set(HEAD_NAMES)
    assert m.conv_seg[3].in_features == 512 * (4 if depth >= 50 else 1)


def test_heads_and_channel_check():
    x = torch.rand(1, 16, 16, 16, 1)
    with torch.no_grad():
        assert image_encoder(10, global_pool=True, compute_dtype=torch.float32
                             ).eval()(x).shape == (1, 512)
        assert image_encoder(10, compute_dtype=torch.float32
                             ).eval()(x).shape == (1, 2, 2, 2, 512)
        with pytest.raises(ValueError, match="channels"):
            ResNet3D(depth=10, in_channels=2)(x)
    with pytest.raises(ValueError):
        ResNet3D(depth=11)
    with pytest.raises(ValueError):
        ResNet3D(head="segmentation")  # no such head


def test_medicalnet_partial_intersection(tmp_path):
    """Keys missing from the checkpoint keep their init; mismatched shapes
    are reported, not loaded."""
    from multimodal_ad_tpu_torch.utils.torch_weights import load_torch_state_dict

    torch.manual_seed(1)
    src = ResNet3D(depth=10)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()
          if "layer4" not in k}
    sd["module.layer3.0.conv1.weight"] = torch.zeros(3, 3)
    path = str(tmp_path / "medicalnet.pth")
    torch.save({"state_dict": sd}, path)

    torch.manual_seed(2)
    dst = ResNet3D(depth=10)
    old4 = dst.layer4[0].conv1.weight.clone()
    _, report = load_medicalnet_weights(dst, load_torch_state_dict(path))
    assert any("layer4" in s for s in report["skipped"])
    assert [m[0] for m in report["mismatched"]] == ["layer3.0.conv1.weight"]
    assert torch.equal(dst.layer4[0].conv1.weight, old4)
    assert torch.equal(dst.conv1.weight, src.conv1.weight)
