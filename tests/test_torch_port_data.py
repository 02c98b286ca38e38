"""Port parity on the CPU: the host data layer of the extraction slice.

- the numpy splits against sklearn, reached through the JAX package's
  data/splits.py: membership and order, exact;
- `make_atlas`, `load_atlas` (JSON and both text LUTs, resampled or not)
  and `compact_labels` against the JAX package's: exact;
- `VolumeBatcher` batches against the JAX package's (`drop_remainder` too),
  and `device_prefetch`
  on the CPU: tensors, error propagation, early close."""

import json
import threading

import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data import pipeline as jpipe
from multimodal_ad_tpu.data import splits as jsplits
from multimodal_ad_tpu.data.synthetic import make_atlas as jax_make_atlas
from multimodal_ad_tpu.eval import atlas as jatlas
from multimodal_ad_tpu_torch.data import pipeline as tpipe
from multimodal_ad_tpu_torch.data import splits as tsplits
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.data.synthetic import make_atlas
from multimodal_ad_tpu_torch.eval import atlas as tatlas
from multimodal_ad_tpu_torch.utils import nifti
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

MANIFESTS = {
    "balanced": [0] * 25 + [1] * 25,
    "imbalanced": [0] * 40 + [1] * 11,
    "three_classes": [0, 1, 2] * 10 + [2] * 7,
    "shuffled": np.random.default_rng(3).integers(0, 3, 77).tolist(),
}


def _records(labels):
    return [{"label": int(lab), "Subject": f"S{i:03d}"} for i, lab in enumerate(labels)]


def _ids(recs):
    return [r["Subject"] for r in recs]


@pytest.mark.parametrize("name", sorted(MANIFESTS))
@pytest.mark.parametrize("test_size,seed", [(0.2, 42), (0.25, 0), (7, 42)])
def test_test_split_equals_sklearn(name, test_size, seed):
    recs = _records(MANIFESTS[name])
    ref_train, ref_test = jsplits.stratified_test_split(recs, test_size, seed)
    train, test = tsplits.stratified_test_split(recs, test_size, seed)
    assert _ids(train) == _ids(ref_train)
    assert _ids(test) == _ids(ref_test)


@pytest.mark.parametrize("name", sorted(MANIFESTS))
@pytest.mark.parametrize("n_splits", [2, 5])
def test_kfold_equals_sklearn(name, n_splits):
    recs = _records(MANIFESTS[name])
    ref = list(jsplits.stratified_kfold(recs, n_splits, 42))
    ours = list(tsplits.stratified_kfold(recs, n_splits, 42))
    assert len(ours) == len(ref) == n_splits
    for (fa, ta, va), (fb, tb, vb) in zip(ours, ref):
        assert fa == fb
        assert _ids(ta) == _ids(tb)
        assert _ids(va) == _ids(vb)


def test_split_rejects_a_singleton_class():
    with pytest.raises(ValueError):
        tsplits.stratified_test_split(_records([0] * 9 + [1]), 0.2, 42)


@pytest.mark.parametrize("shape,n_rois,seed", [((12, 14, 12), 5, 1),
                                               ((20, 24, 20), 3, 0),
                                               ((31, 17, 23), 40, 5)])
def test_make_atlas_equals_jax(shape, n_rois, seed):
    np.testing.assert_array_equal(make_atlas(shape, n_rois, seed),
                                  jax_make_atlas(shape, n_rois, seed))


@pytest.fixture(scope="module")
def atlas_files(tmp_path_factory):
    """The fixture of tests/test_features.py: sparse ids 1, 2, 4, 5, a
    JSON LUT, and both AAL3 text LUTs."""
    root = tmp_path_factory.mktemp("port_atlas")
    labels = jax_make_atlas((20, 24, 20), n_rois=4, seed=2)
    labels[labels == 3] = 5
    nii = str(root / "atlas.nii")
    nifti.save(nii, labels.astype(np.int16), pixdim=(2, 2, 2))
    names = {1: "Precentral_L", 2: "Precentral_R", 4: "Frontal_Sup_L",
             5: "Hippocampus_L"}
    paths = {"json": str(root / "atlas.json"), "tsv": str(root / "ROI_MNI_V7_vol.txt"),
             "txt": str(root / "AAL3v1_1mm.nii.txt")}
    with open(paths["json"], "w") as f:
        json.dump({"rois": {str(k): {"label": v} for k, v in names.items() if k != 4}}, f)
    with open(paths["tsv"], "w") as f:
        f.write("nom_c\tnom_l\tcolor\tvol_vox\tvol_mm3\n")
        f.writelines(f"X\t{v}\t{k}\t1\t1\n" for k, v in names.items())
    with open(paths["txt"], "w") as f:
        f.writelines(f"{k} {v} {k}\n" for k, v in names.items())
    return nii, paths


@pytest.mark.parametrize("lut", [None, "json", "tsv", "txt"])
@pytest.mark.parametrize("resample", [False, True])
def test_load_atlas_equals_jax(atlas_files, lut, resample):
    nii, paths = atlas_files
    kw = {}
    if resample:  # onto a coarser grid, half of it outside the source
        kw = dict(target_shape=(12, 14, 12),
                  target_affine=np.diag([3.0, 3.0, 3.0, 1.0]))
    lut_path = paths[lut] if lut else None
    ours = tatlas.load_atlas(nii, lut_path, **kw)
    ref = jatlas.load_atlas(nii, lut_path, **kw)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[0].dtype == ref[0].dtype == np.int32
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2] == ref[2]
    np.testing.assert_array_equal(ours[3], ref[3])
    np.testing.assert_array_equal(tatlas.compact_labels(ours[0], ours[1]),
                                  jatlas.compact_labels(ref[0], ref[1]))


def test_mni_grid_and_lut_fallbacks(tmp_path):
    np.testing.assert_array_equal(tatlas.MNI152_2MM_AFFINE, jatlas.MNI152_2MM_AFFINE)
    assert tatlas.MNI152_2MM_SHAPE == jatlas.MNI152_2MM_SHAPE
    bad = tmp_path / "bad.json"
    bad.write_text('{"rois": {"x": {"label": "A"}}}')
    assert tatlas.load_lut(str(bad)) == jatlas.load_lut(str(bad)) == {}
    src = np.zeros((20, 20, 20), np.int32)
    src[:10], src[10:] = 1, 2
    for affine in (np.diag([2.0, 2.0, 2.0, 1.0]), np.diag([4.0, 4.0, 4.0, 1.0])):
        np.testing.assert_array_equal(
            tatlas.resample_labels_nearest(src, np.eye(4), (10, 10, 10), affine),
            jatlas.resample_labels_nearest(src, np.eye(4), (10, 10, 10), affine))


def _manifest(adni_dir, n=None):
    recs = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                        verbose=False).data_dict
    return recs[:n] if n else recs


def _raw(vol, sample_idx=0, epoch=0):
    return vol[..., None]  # no host normalization: the port normalizes on the device


@pytest.mark.parametrize("n,bs", [(5, 2), (7, 4), (3, 8), (4, 4)])
def test_batcher_equals_jax(adni_dir, n, bs):
    """Same images, labels, masks and subjects, ragged padding included."""
    recs = _manifest(adni_dir, n)
    ours = list(tpipe.VolumeBatcher(recs, batch_size=bs, num_threads=2))
    ref = list(jpipe.VolumeBatcher(recs, _raw, bs, num_threads=2))
    assert len(ours) == len(ref) == -(-n // bs)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["subject"] == b["subject"]
    assert ours[-1]["image"].shape[0] == bs


@pytest.mark.parametrize("n,bs", [(5, 2), (7, 4), (4, 4), (3, 8)])
def test_batcher_drop_remainder_equals_jax(adni_dir, n, bs):
    """`drop_remainder`: the JAX package's length and batches, the ragged
    last batch left out (none at all when one batch is ragged)."""
    recs = _manifest(adni_dir, n)
    ours = tpipe.VolumeBatcher(recs, batch_size=bs, num_threads=2, drop_remainder=True)
    ref = jpipe.VolumeBatcher(recs, _raw, bs, num_threads=2, drop_remainder=True)
    got, want = list(ours), list(ref)
    assert len(ours) == len(ref) == len(got) == len(want) == n // bs
    for a, b in zip(got, want):
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["subject"] == b["subject"] and a["mask"].all()


def test_prefetch_on_cpu_yields_tensors(adni_dir):
    batches = list(tpipe.VolumeBatcher(_manifest(adni_dir, 5), batch_size=2,
                                       num_threads=2))
    got = list(tpipe.device_prefetch(iter(batches), "cpu", depth=2))
    assert len(got) == 3
    for a, b in zip(got, batches):
        assert isinstance(a["image"], torch.Tensor) and a["image"].device.type == "cpu"
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
        assert a["subject"] == b["subject"]


def test_prefetch_reraises_a_loader_error(adni_dir):
    def loader(path):
        if path.endswith("CN_001.nii"):
            raise OSError("unreadable volume")
        return tpipe.load_volume(path)

    batcher = tpipe.VolumeBatcher(_manifest(adni_dir), batch_size=2, num_threads=2,
                                  loader=loader)
    with pytest.raises(OSError, match="unreadable"):
        for _ in tpipe.device_prefetch(iter(batcher), "cpu"):
            pass


def test_prefetch_stops_its_thread_when_closed(adni_dir):
    batcher = tpipe.VolumeBatcher(_manifest(adni_dir), batch_size=1, num_threads=2)
    before = {t.ident for t in threading.enumerate() if t.name == "device_prefetch"}
    gen = tpipe.device_prefetch(iter(batcher), "cpu", depth=1)
    next(gen)
    gen.close()  # joins the producer
    after = {t.ident for t in threading.enumerate() if t.name == "device_prefetch"}
    assert after <= before
