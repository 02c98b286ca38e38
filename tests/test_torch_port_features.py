"""Port parity on the CPU: the extraction slice end to end.

The port's `extract_unet_features(device="cpu")` and the JAX package's
`extract_unet_features` run on the same records, atlas and converted
weights (a (8, 16, 32)/64 U-Net with randomized BatchNorm statistics).
Headers and subjects must be equal and in the same order, values within
rtol = atol = 1e-4 (float32 in both; the JAX path normalizes on the host
by division, the port on the device by a reciprocal, and the frameworks
sum in other orders). Then `cli.extract_features --device cpu` on the
test dataset writes the contracted CSVs for the seed-42 test split."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data.splits import stratified_test_split as jax_test_split
from multimodal_ad_tpu.data.synthetic import make_atlas
from multimodal_ad_tpu.eval.features import \
    extract_unet_features as jax_extract_unet_features
from multimodal_ad_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_ad_tpu_torch.cli import extract_features as cli
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.eval.features import extract_unet_features
from multimodal_ad_tpu_torch.models.unet3d import UNet3D
from multimodal_ad_tpu_torch.ops import fused_gather, roi_pool
from multimodal_ad_tpu_torch.utils import nifti
from multimodal_ad_tpu_torch.utils.torch_weights import unet3d_state_dict_from_flax
from test_torch_port_unet import NARROW, random_unet_variables
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

ROI_NAMES = ["A", "B", "C"]


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def slice_case(adni_dir):
    records = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                           verbose=False).data_dict[:5]
    labels = make_atlas(adni_dir["shape"], n_rois=3, seed=0)
    jm = JaxUNet3D(dtype=jnp.float32, **NARROW)
    variables = random_unet_variables(jm, adni_dir["shape"], seed=11)
    tm = UNet3D(**NARROW)
    tm.load_state_dict(unet3d_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return records, labels, jm, variables, tm


@pytest.mark.parametrize("compat", [False, True], ids=["roi_major", "bug_compat"])
def test_csvs_match_jax(slice_case, mesh8, tmp_path, compat):
    records, labels, jm, variables, tm = slice_case
    ref_f, ref_r = jax_extract_unet_features(
        records, labels, ROI_NAMES, str(tmp_path / "jax"), model=jm,
        variables=variables, batch_size=8, mesh=mesh8, num_threads=2,
        reference_bug_compat=compat)
    f, r = extract_unet_features(records, labels, ROI_NAMES, str(tmp_path / "port"),
                                 model=tm, batch_size=2, num_threads=2,
                                 reference_bug_compat=compat, device="cpu")
    for ours, ref in ((_read(f), _read(ref_f)), (_read(r), _read(ref_r))):
        assert ours[0] == ref[0]  # headers
        assert [row[0] for row in ours[1:]] == [row[0] for row in ref[1:]]
        assert len(ours) == 1 + len(records)
        np.testing.assert_allclose(np.asarray([row[1:] for row in ours[1:]], float),
                                   np.asarray([row[1:] for row in ref[1:]], float),
                                   rtol=1e-4, atol=1e-4)


def test_bug_compat_transposes_rows(slice_case, tmp_path):
    records, labels, _, _, tm = slice_case
    kw = dict(model=tm, batch_size=4, num_threads=2, device="cpu")
    _, fixed = extract_unet_features(records[:2], labels, ROI_NAMES,
                                     str(tmp_path / "fixed"), **kw)
    _, compat = extract_unet_features(records[:2], labels, ROI_NAMES,
                                      str(tmp_path / "compat"),
                                      reference_bug_compat=True, **kw)
    a = np.asarray([row[1:] for row in _read(fixed)[1:]], np.float32)
    b = np.asarray([row[1:] for row in _read(compat)[1:]], np.float32)
    assert a.shape == b.shape == (2, 3 * 8)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a.reshape(-1, 3, 8),
                                  b.reshape(-1, 8, 3).transpose(0, 2, 1))


def test_rejects_an_unknown_normalizer(slice_case, tmp_path):
    records, labels, _, _, tm = slice_case
    with pytest.raises(ValueError, match="normalizer"):
        extract_unet_features(records, labels, ROI_NAMES, str(tmp_path), model=tm,
                              normalizer="zscore", device="cpu")


def test_adaptive_normal_path_runs(slice_case, tmp_path):
    records, labels, _, _, tm = slice_case
    f, r = extract_unet_features(records[:3], labels, ROI_NAMES, str(tmp_path),
                                 model=tm, batch_size=2, num_threads=2,
                                 normalizer="adaptive_normal", device="cpu")
    rows = _read(r)
    assert len(rows) == 4
    assert np.isfinite(np.asarray([row[1:] for row in rows[1:]], float)).all()


def test_cli_writes_the_contracted_csvs(adni_dir, tmp_path):
    """12 subjects -> the seed-42 test split of 3, in sklearn's order; a
    sparse-id atlas with a JSON LUT; batch 2 pads the last batch."""
    labels = make_atlas(adni_dir["shape"], n_rois=4, seed=2)
    labels[labels == 3] = 5  # sparse ids 1, 2, 4, 5
    nii = str(tmp_path / "atlas.nii")
    nifti.save(nii, labels.astype(np.int16))
    lut = tmp_path / "atlas.json"
    lut.write_text('{"rois": {"1": {"label": "Precentral_L"}, '
                   '"5": {"label": "Hippocampus_L"}}}')
    k1, k2 = fused_gather.gather_normalize.launches, roi_pool.roi_pool.launches
    fpath, rpath = cli.main([
        "--atlas", nii, "--atlas-json", str(lut), "--out", str(tmp_path / "out"),
        "--device", "cpu", f"label_file={adni_dir['label_file']}",
        f"mri_dir={adni_dir['mri_dir']}", "batch_size=2", "loader_threads=2"])
    # no kernel runs on the CPU
    assert (fused_gather.gather_normalize.launches, roi_pool.roi_pool.launches) == (k1, k2)
    records = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                           verbose=False).data_dict
    _, test = jax_test_split(records, 0.2, 42)
    x, y, z = adni_dir["shape"]
    feats, rois = _read(fpath), _read(rpath)
    assert feats[0][:2] == ["Subject_ID", "f0"] and len(feats[0]) == 1 + x * y * z
    names = ["Precentral_L", "ROI2", "ROI4", "Hippocampus_L"]
    assert rois[0] == ["Subject_ID"] + [f"{n}_c{c}" for n in names for c in range(64)]
    assert [row[0] for row in feats[1:]] == [r["Subject"] for r in test]
    assert [row[0] for row in rois[1:]] == [r["Subject"] for r in test]
    values = np.asarray([row[1:] for row in rois[1:]], float)
    assert values.shape == (3, 4 * 64) and np.isfinite(values).all()


def test_default_model_is_seeded(slice_case, tmp_path):
    """No model: a full-width UNet3D drawn from a generator seeded with
    `seed`; the same seed gives the same CSV bytes."""
    records, labels, _, _, _ = slice_case
    paths = [extract_unet_features(records[:1], labels, ROI_NAMES,
                                   str(tmp_path / str(i)), seed=5, device="cpu")[1]
             for i in range(2)]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert torch.backends.cudnn.deterministic is False  # restored after the run
