"""The port's native NIfTI decoder (native/nifti_reader.cpp, built with g++
at first use) on the CPU: bit-equal to the port's Python reader, per
volume and in batches, for .nii and .nii.gz and every datatype it covers;
`load_volume` falls back to the Python reader only for encodings the
decoder does not cover (a 4-D file, int64), raises on a broken file,
honours MAD_NO_NATIVE_IO=1, and `VolumeBatcher.reads` counts decodes by
reader. Builds that race write under their own names; a failed build
warns once and decodes with the Python reader."""

import os
import shutil
import threading
import warnings

import numpy as np
import pytest

from multimodal_ad_tpu_torch.data import pipeline
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.utils import native_loader, nifti
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _volumes(adni_dir, n=4):
    recs = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                        verbose=False).data_dict[:n]
    return [nifti.exists_with_ext(r["MRI"]) for r in recs]


@pytest.fixture
def gz_volumes(adni_dir, tmp_path):
    out = []
    for p in _volumes(adni_dir):
        q = str(tmp_path / (os.path.basename(p) + ".gz"))
        nifti.save(q, nifti.load(p))
        out.append(q)
    return out


def test_native_decoder_builds():
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.build_error() is None
    assert native_loader.library_path().parent == native_loader.BUILD_DIR


@pytest.mark.parametrize("kind", ["nii", "nii.gz"])
def test_volumes_bit_equal_to_the_python_reader(adni_dir, gz_volumes, kind):
    paths = _volumes(adni_dir) if kind == "nii" else gz_volumes
    for p in paths:
        ref = nifti.load(p)
        ours = native_loader.load_volume_native(p)
        assert ours.shape == ref.shape == adni_dir["shape"]
        assert np.array_equal(_bits(ours), _bits(ref))
    batch = native_loader.NativeBatchDecoder(adni_dir["shape"], n_threads=3).decode(paths)
    assert batch.shape == (len(paths), *adni_dir["shape"])
    for p, v in zip(paths, batch):
        assert np.array_equal(_bits(v), _bits(nifti.load(p)))


def test_fused_normalize_is_min_max(adni_dir):
    """normalize=True fuses a per-volume min-max to [0, 1] into the decode
    (a reciprocal multiply, so within float32 rounding of the division)."""
    paths = _volumes(adni_dir, 2)
    batch = native_loader.NativeBatchDecoder(adni_dir["shape"], normalize=True,
                                             n_threads=2).decode(paths)
    for p, v in zip(paths + paths[:1], list(batch) + [native_loader.load_volume_native(
            paths[0], normalize=True)]):
        ref = nifti.load(p).astype(np.float64)
        ref = (ref - ref.min()) / (ref.max() - ref.min())
        np.testing.assert_allclose(v, ref, rtol=0, atol=1e-6)
        assert v.min() == 0.0


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint16, np.int32,
                                   np.uint32, np.float32, np.float64])
def test_every_covered_datatype(tmp_path, dtype):
    rng = np.random.default_rng(3)
    data = rng.normal(0, 50, (5, 6, 7))
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        data = np.clip(data, info.min, info.max)
    data = data.astype(dtype)
    data.flat[0] = -0.0 if np.issubdtype(dtype, np.floating) else data.flat[0]
    p = str(tmp_path / "v.nii")
    nifti.save(p, data)
    vol, reader = pipeline.read_volume(p)
    assert reader == "native"
    assert np.array_equal(_bits(vol), _bits(nifti.load(p)))


def test_scaled_volume_bit_equal(tmp_path):
    """scl_slope / scl_inter: one float32 multiply, then one add, in both
    readers (no fused multiply-add)."""
    import struct

    p = str(tmp_path / "scaled.nii")
    nifti.save(p, np.random.default_rng(4).integers(-900, 900, (6, 5, 4)).astype(np.int16))
    with open(p, "r+b") as f:
        f.seek(112)
        f.write(struct.pack("<2f", 0.3711, -17.25))
    ref = nifti.load(p)
    assert np.array_equal(_bits(native_loader.load_volume_native(p)), _bits(ref))


def test_unsupported_encodings_fall_back_to_python(tmp_path):
    four_d = str(tmp_path / "four_d.nii")
    nifti.save(four_d, np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5))
    wide = str(tmp_path / "wide.nii")
    nifti.save(wide, np.arange(60, dtype=np.int64).reshape(3, 4, 5))
    for p in (four_d, wide):
        with pytest.raises(native_loader.UnsupportedEncoding):
            native_loader.load_volume_native(p)
        vol, reader = pipeline.read_volume(p)
        assert reader == "python"
        assert np.array_equal(vol, nifti.load(p))
    assert pipeline.load_volume(four_d).shape == (2, 3, 4, 5)


def test_broken_files_raise(adni_dir, tmp_path):
    garbage = tmp_path / "garbage.nii"
    garbage.write_bytes(b"x" * 400)
    truncated = tmp_path / "truncated.nii"
    with open(_volumes(adni_dir, 1)[0], "rb") as f:
        truncated.write_bytes(f.read()[:2000])
    with pytest.raises(ValueError, match="not a NIfTI-1 file"):
        pipeline.load_volume(str(garbage))
    with pytest.raises(ValueError, match=r"native NIfTI decode failed \(-5\)"):
        pipeline.load_volume(str(truncated))
    with pytest.raises(FileNotFoundError):
        pipeline.load_volume(str(tmp_path / "missing.nii"))
    with pytest.raises(ValueError, match="failures"):
        native_loader.NativeBatchDecoder((20, 24, 20), n_threads=2).decode(
            [_volumes(adni_dir, 1)[0], str(garbage)])
    with pytest.raises(ValueError, match="shape mismatch"):
        native_loader.NativeBatchDecoder((20, 24, 21)).decode(_volumes(adni_dir, 1))


def test_no_native_io_forces_the_python_reader(adni_dir, monkeypatch):
    p = _volumes(adni_dir, 1)[0]
    assert pipeline.read_volume(p)[1] == "native"
    monkeypatch.setenv("MAD_NO_NATIVE_IO", "1")
    vol, reader = pipeline.read_volume(p)
    assert reader == "python" and np.array_equal(vol, nifti.load(p))
    assert pipeline.read_volume(p, native=True)[1] == "native"


def test_batcher_counts_reads_by_reader(adni_dir, monkeypatch):
    recs = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], "ADCN",
                        verbose=False).data_dict[:5]

    def drain(**kw):
        before = dict(pipeline.VolumeBatcher.reads)
        batches = list(pipeline.VolumeBatcher(recs, batch_size=4, num_threads=2, **kw))
        return batches, {k: v - before[k] for k, v in pipeline.VolumeBatcher.reads.items()}

    native_batches, counts = drain()
    assert counts == {"native": 8, "python": 0, "custom": 0}  # 5 rows + 3 padding
    custom_batches, counts = drain(loader=nifti.load)
    assert counts == {"native": 0, "python": 0, "custom": 8}
    monkeypatch.setenv("MAD_NO_NATIVE_IO", "1")
    python_batches, counts = drain()
    assert counts == {"native": 0, "python": 8, "custom": 0}
    for a, b, c in zip(native_batches, python_batches, custom_batches):
        assert np.array_equal(_bits(a["image"]), _bits(b["image"]))
        assert np.array_equal(_bits(a["image"]), _bits(c["image"]))


def test_concurrent_builds_never_load_a_partial_library(monkeypatch, tmp_path):
    """Four threads build into an empty directory at once, each under its
    own temporary name moved into place: the library loads and no
    temporary file is left."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    lib = native_loader.library_path()
    errors = [None] * 4

    def build(i):
        errors[i] = native_loader._build(lib)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [None] * 4
    assert sorted(os.listdir(tmp_path)) == [lib.name]
    import ctypes

    assert ctypes.CDLL(str(lib)).mad_read_nifti is not None


def test_failed_build_warns_once_and_decodes_in_python(adni_dir, monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to show that a bad flag fails the build")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "CXX_FLAGS", native_loader.CXX_FLAGS
                        + ("--no-such-flag",))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_error", None)
    p = _volumes(adni_dir, 1)[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vol, reader = pipeline.read_volume(p)
        pipeline.read_volume(p)
    assert reader == "python" and np.array_equal(vol, nifti.load(p))
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "build failed" in msgs[0]
    assert native_loader.build_error().startswith("build failed")
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.load_volume_native(p)
