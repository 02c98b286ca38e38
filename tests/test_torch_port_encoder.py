"""Port parity on the CPU: ResNet encoder features, the stage taps and the
seg head.

`extract_encoder_features(device="cpu")` and the JAX package's function
run on the same records and converted weights (a ResNet-10 with
randomized BatchNorm statistics) with heads 'none' and 'pool': equal
headers and subject order, values within rtol = atol = 1e-4 (float32 in
both; the JAX path normalizes on the host by division, the port on the
device by K1's reciprocal, as in tests/test_torch_port_features.py), and
feature_map_shapes.csv equal as text. `forward(return_taps=True)` returns
the four stage outputs the JAX model sows. The seg head (MedicalNet's
conv_seg.{0,1,3,4,6}) matches the JAX head 'seg' through the converter:
float32 within atol 1e-4; bf16 autocast within 2e-2 of the output's
largest magnitude, since one bf16 step is 3.9e-3 relative and the two
frameworks round at other points in the head's three convolutions.
`load_medicalnet_weights` transfers a seg head by key intersection."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.eval.features import \
    extract_encoder_features as jax_extract_encoder_features
from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.eval.features import extract_encoder_features
from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D
from multimodal_ad_tpu_torch.utils.torch_weights import (load_medicalnet_weights,
                                                         resnet3d_name_map,
                                                         state_dict_from_flax)
from test_torch_port_models import random_flax_variables
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def encoder_case(adni_dir):
    records = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                           verbose=False).data_dict[:5]
    shape = (*adni_dir["shape"], 1)
    variables = random_flax_variables(JaxResNet3D(depth=10, head="none", dtype=jnp.float32),
                                      shape, seed=5)
    return records, variables


@pytest.mark.parametrize("head", ["none", "pool"])
def test_csvs_match_jax(encoder_case, adni_dir, mesh8, tmp_path, head):
    records, variables = encoder_case
    ref_f, ref_s = jax_extract_encoder_features(
        records, str(tmp_path / "jax"), depth=10, global_pool=head == "pool",
        variables=variables, batch_size=8, mesh=mesh8, num_threads=2,
        input_shape=adni_dir["shape"])
    tm = ResNet3D(depth=10, head=head, compute_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(variables, 10))
    f, s = extract_encoder_features(records, str(tmp_path / "port"), model=tm,
                                    batch_size=8, num_threads=2, device="cpu")
    ours, ref = _read(f), _read(ref_f)
    assert ours[0] == ref[0] and ours[0][-1] == "label"
    width = 512 if head == "pool" else 512 * 3 * 3 * 3
    assert len(ours[0]) == 1 + width + 1
    assert [r[0] for r in ours[1:]] == [r[0] for r in ref[1:]] == [r["Subject"]
                                                                   for r in records]
    assert [r[-1] for r in ours[1:]] == [r[-1] for r in ref[1:]]
    np.testing.assert_allclose(np.asarray([r[1:-1] for r in ours[1:]], float),
                               np.asarray([r[1:-1] for r in ref[1:]], float),
                               rtol=1e-4, atol=1e-4)
    with open(s) as a, open(ref_s) as b:
        assert a.read() == b.read()


def test_default_encoder_and_head_check(adni_dir, tmp_path):
    records = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                           verbose=False).data_dict[:3]
    f, s = extract_encoder_features(records, str(tmp_path / "a"), depth=10,
                                    global_pool=True, batch_size=2, num_threads=2,
                                    device="cpu")
    rows, shapes = _read(f), _read(s)
    assert len(rows) == 4 and len(rows[0]) == 1 + 512 + 1
    assert shapes[0] == ["module", "output_shape"] and len(shapes) == 5
    assert shapes[1] == ["stage_out", "(2, 5, 6, 5, 64)"]
    again = extract_encoder_features(records, str(tmp_path / "b"), depth=10,
                                     global_pool=True, batch_size=2, num_threads=2,
                                     device="cpu")[0]
    with open(f) as a, open(again) as b:
        assert a.read() == b.read()  # the seed fixes the untrained encoder
    with pytest.raises(ValueError, match="head"):
        extract_encoder_features(records, str(tmp_path / "c"),
                                 model=ResNet3D(depth=10), device="cpu")


def _seg_pair(dtype=jnp.float32, seed=4, classes=2):
    shape = (20, 24, 20, 1)
    jm = JaxResNet3D(depth=10, head="seg", num_seg_classes=classes, dtype=dtype)
    variables = random_flax_variables(
        JaxResNet3D(depth=10, head="seg", num_seg_classes=classes, dtype=jnp.float32),
        shape, seed=seed)
    tm = ResNet3D(depth=10, head="seg", num_seg_classes=classes,
                  compute_dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(variables, 10, head="seg"))
    x = np.random.default_rng(1).normal(size=(2, *shape)).astype(np.float32)
    return jm, variables, tm.eval(), x


def test_seg_head_and_taps_match_jax_float32():
    jm, variables, tm, x = _seg_pair()
    ref, inter = jm.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    with torch.no_grad():
        ours, taps = tm(torch.from_numpy(x), return_taps=True)
        plain = tm(torch.from_numpy(x))
    assert torch.equal(ours, plain)
    assert ours.shape == ref.shape == (2, 6, 6, 6, 2) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    ref_taps = jax.tree_util.tree_leaves(inter["intermediates"])
    assert [tuple(t.shape) for t in taps] == [r.shape for r in ref_taps]
    for t, r in zip(taps, ref_taps):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_seg_head_matches_jax_bf16():
    jm, variables, tm, x = _seg_pair(jnp.bfloat16)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert ours.dtype == torch.bfloat16  # the model dtype, as the JAX head returns
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=2e-2 * scale)


def test_seg_names_and_medicalnet_transfer():
    model = ResNet3D(depth=10, head="seg", num_seg_classes=3)
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == {r[0] for r in resnet3d_name_map(10, "B", head="seg")}
    seg = sorted({k.split(".")[1] for k in keys if k.startswith("conv_seg.")})
    assert seg == ["0", "1", "3", "4", "6"]
    assert isinstance(model.conv_seg[0], torch.nn.ConvTranspose3d)
    assert model.conv_seg[0].bias is not None and model.conv_seg[6].bias is None

    torch.manual_seed(3)
    src = ResNet3D(depth=10, head="seg", num_seg_classes=3)
    dst = ResNet3D(depth=10, head="seg", num_seg_classes=3)
    _, report = load_medicalnet_weights(dst, src.state_dict())
    assert not report["skipped"] and not report["mismatched"]
    assert {n for n in report["loaded"] if n.startswith("conv_seg.")} == {
        r[0] for r in resnet3d_name_map(10, "B", head="seg") if r[0].startswith("conv_seg.")}
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(dst.state_dict()[k], v), k
    # a classifier checkpoint's conv_seg.3 (a Linear) does not fit the seg head
    clf = {k: v for k, v in ResNet3D(depth=10).state_dict().items()}
    _, report = load_medicalnet_weights(ResNet3D(depth=10, head="seg"), clf)
    assert "conv_seg.0.weight" in report["skipped"]
