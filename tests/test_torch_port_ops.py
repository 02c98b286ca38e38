"""Port parity on the CPU: K1's plain version (fused gather + min-max
normalize), the normalizers, the uint8 store and the device dataset,
against the JAX package on the same seeded numpy inputs.

Tolerances: K1's plain version multiplies by a reciprocal, as the Pallas
kernel does; against the Pallas kernel in interpret mode it is held to
1e-6 in f32 (both compute the same f32 operations), and against the
dividing XLA twin / scale_intensity also to 1e-6 (the two roundings differ
by at most 2 ulp, 1.2e-7 on [0, 1]). bf16 outputs round the same f32
value, so they are held to one bf16 ulp (2^-8 on [0, 1])."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data import device_cache as jdc
from multimodal_ad_tpu.data.transforms import adaptive_normal as host_adaptive
from multimodal_ad_tpu.data.transforms import scale_intensity as host_scale
from multimodal_ad_tpu.ops import fused_gather as jfg
from multimodal_ad_tpu.ops import normalize as jnorm
from multimodal_ad_tpu_torch.data import device_cache as tdc
from multimodal_ad_tpu_torch.ops import fused_gather as tfg
from multimodal_ad_tpu_torch.ops import normalize as tnorm

BF16_ULP = 2.0 ** -8
OUT_DTYPES = [(jnp.float32, torch.float32, 1e-6),
              (jnp.bfloat16, torch.bfloat16, BF16_ULP)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


class TestFusedGatherPlain:
    """The cases of tests/test_ops.py's TestFusedGatherNormalize."""

    @pytest.mark.parametrize("jdt,tdt,tol", OUT_DTYPES, ids=["f32", "bf16"])
    def test_matches_pallas_and_xla(self, rng, jdt, tdt, tol):
        vols = rng.integers(-50, 4096, (5, 9, 11, 10, 1)).astype(np.int16)
        corpus, vox = jfg.flatten_corpus(vols)
        idx = np.array([3, 0, 4, 4], np.int32)
        pallas = np.asarray(jfg.gather_normalize_pallas(
            jnp.asarray(corpus), idx, vox, interpret=True, out_dtype=jdt),
            np.float32).reshape(4, -1)[:, :vox]
        xla = np.asarray(jfg.gather_normalize_xla(
            jnp.asarray(corpus), idx, vox, out_dtype=jdt),
            np.float32).reshape(4, -1)[:, :vox]
        ours = tfg.gather_normalize_plain(torch.from_numpy(vols),
                                          torch.from_numpy(idx), tdt)
        assert ours.shape == (4, 9, 11, 10, 1) and ours.dtype == tdt
        ours = _np(ours).reshape(4, -1)
        np.testing.assert_allclose(ours, pallas, rtol=0, atol=tol)
        np.testing.assert_allclose(ours, xla, rtol=0, atol=tol)

    def test_constant_volume_is_zeroed(self):
        vols = np.full((2, 4, 4, 4, 1), 7, np.int16)
        out = tfg.gather_normalize_plain(torch.from_numpy(vols),
                                         torch.tensor([1, 0]))
        assert (out == 0).all()

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_sources_match_scale_intensity(self, rng, dtype):
        if dtype == np.uint8:
            vols = rng.integers(0, 256, (4, 7, 9, 6, 1)).astype(np.uint8)
        else:
            vols = rng.normal(20, 7, (4, 7, 9, 6, 1)).astype(np.float32)
        idx = np.array([2, 2, 0, 3], np.int64)
        ref = np.asarray(jnorm.scale_intensity(jnp.asarray(vols[idx])))
        ours = _np(tfg.gather_normalize_plain(torch.from_numpy(vols),
                                              torch.from_numpy(idx)))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)

    def test_wrapper_on_cpu_is_plain(self, rng):
        vols = torch.from_numpy(rng.normal(size=(3, 5, 4, 6, 1)).astype(np.float32))
        idx = np.array([2, 0], np.int32)
        before = tfg.gather_normalize.launches
        a = tfg.gather_normalize(vols, idx, torch.bfloat16)
        b = tfg.gather_normalize_plain(vols, torch.from_numpy(idx), torch.bfloat16)
        assert torch.equal(a, b)
        assert tfg.gather_normalize.launches == before  # no kernel on the CPU

    @pytest.mark.parametrize("bad", [[0, 3], [-1], [[0, 1]]])
    def test_wrapper_rejects_bad_host_indices(self, bad):
        vols = torch.zeros((3, 2, 2, 2, 1))
        with pytest.raises((IndexError, ValueError)):
            tfg.gather_normalize(vols, np.asarray(bad, np.int64))

    def test_wrapper_rejects_float_indices(self):
        with pytest.raises(TypeError):
            tfg.gather_normalize(torch.zeros((3, 4)), np.array([0.0]))


class TestNormalize:
    """The cases of tests/test_ops.py's TestDeviceNormalize."""

    def test_scale_intensity_matches_jax_and_host(self, rng):
        vols = rng.normal(20, 7, size=(3, 9, 10, 8)).astype(np.float32)
        ours = _np(tnorm.scale_intensity(torch.from_numpy(vols[..., None])))[..., 0]
        dev = np.asarray(jnorm.scale_intensity(jnp.asarray(vols[..., None])))[..., 0]
        host = np.stack([host_scale(v) for v in vols])
        np.testing.assert_allclose(ours, dev, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours, host, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("dtype", [np.int16, np.uint8])
    def test_scale_intensity_integer_input(self, rng, dtype):
        hi = 4000 if dtype == np.int16 else 255
        vols = rng.integers(0, hi, size=(2, 6, 7, 6, 1)).astype(dtype)
        out = tnorm.scale_intensity(torch.from_numpy(vols))
        assert out.dtype == torch.float32
        assert out.min() == 0.0 and out.max() == 1.0
        np.testing.assert_allclose(
            _np(out), np.asarray(jnorm.scale_intensity(jnp.asarray(vols))),
            rtol=0, atol=1e-6)

    def test_adaptive_normal_matches_jax_and_host(self, rng):
        vols = np.abs(rng.normal(100, 30, size=(3, 11, 9, 10))).astype(np.float32)
        vols[:, 0, 0, 0] = -3.0  # negatives excluded from the percentile pick
        ours = _np(tnorm.adaptive_normal(torch.from_numpy(vols[..., None])))[..., 0]
        dev = np.asarray(jnorm.adaptive_normal(jnp.asarray(vols[..., None])))[..., 0]
        host = np.stack([host_adaptive(v) for v in vols])
        np.testing.assert_allclose(ours, dev, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours, host, rtol=1e-5, atol=1e-5)

    def test_adaptive_normal_uint8(self, rng):
        vols = rng.integers(0, 256, size=(2, 6, 5, 7, 1)).astype(np.uint8)
        ours = _np(tnorm.adaptive_normal(torch.from_numpy(vols)))
        dev = np.asarray(jnorm.adaptive_normal(jnp.asarray(vols)))
        np.testing.assert_allclose(ours, dev, rtol=1e-5, atol=1e-5)

    def test_constant_volume(self):
        vols = torch.ones((1, 4, 4, 4, 1))
        assert torch.isfinite(tnorm.scale_intensity(vols)).all()
        assert torch.isfinite(tnorm.adaptive_normal(vols)).all()
        np.testing.assert_array_equal(
            _np(tnorm.adaptive_normal(vols)),
            np.asarray(jnorm.adaptive_normal(jnp.ones((1, 4, 4, 4, 1)))))


class TestQuantizeUint8:
    def test_matches_jax(self, rng):
        vols = rng.normal(300, 80, size=(3, 6, 7, 5, 1)).astype(np.float32)
        vols[1] = 5.0  # constant volume maps to 0
        np.testing.assert_array_equal(tdc.quantize_uint8(vols),
                                      jdc.quantize_uint8(vols))

    def test_rejects_4d(self):
        with pytest.raises(ValueError):
            tdc.quantize_uint8(np.zeros((2, 3, 3, 3), np.float32))


def _corpus(rng):
    vols = rng.integers(-40, 3000, (6, 7, 8, 6, 1)).astype(np.int16)
    labels = rng.integers(0, 2, 6).astype(np.int32)
    return vols, labels


class TestDeviceDataset:
    @pytest.mark.parametrize("kw", [{}, {"fused_norm": True},
                                    {"quantize": "uint8"}],
                             ids=["default", "fused_norm", "uint8"])
    def test_gather_matches_jax(self, rng, kw):
        vols, labels = _corpus(rng)
        jds = jdc.DeviceDataset(vols, labels, **kw)
        tds = tdc.DeviceDataset(vols, labels, device="cpu", **kw)
        idx = np.array([5, 0, 2, 2], np.int32)
        jb, tb = jds.gather(idx), tds.gather(idx)
        np.testing.assert_array_equal(tb["image"].numpy(),
                                      np.asarray(jb["image"]))
        np.testing.assert_array_equal(tb["label"].numpy(),
                                      np.asarray(jb["label"]))
        np.testing.assert_array_equal(tb["mask"].numpy(), np.asarray(jb["mask"]))
        jn, tn = jds.gather_normalized(idx), tds.gather_normalized(idx)
        assert tn["image"].shape == (4, 7, 8, 6, 1)
        np.testing.assert_allclose(tn["image"].numpy(),
                                   np.asarray(jn["image"]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tn["label"].numpy(),
                                      np.asarray(jn["label"]))

    def test_gather_normalized_bf16(self, rng):
        vols, labels = _corpus(rng)
        tds = tdc.DeviceDataset(vols, labels, device="cpu", quantize="uint8")
        out = tds.gather_normalized(np.array([1, 3]), out_dtype=torch.bfloat16)
        assert out["image"].dtype == torch.bfloat16
        ref = jdc.DeviceDataset(vols, labels, quantize="uint8") \
            .gather_normalized(np.array([1, 3], np.int32))["image"]
        np.testing.assert_allclose(_np(out["image"]), np.asarray(ref),
                                   rtol=0, atol=BF16_ULP)

    @pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
    def test_epoch_indices_match_jax(self, rng, shuffle, drop):
        vols, labels = _corpus(rng)
        jds = jdc.DeviceDataset(vols, labels)
        tds = tdc.DeviceDataset(vols, labels, device="cpu")
        a = list(jds.epoch_indices(np.random.default_rng(3), 4, shuffle, drop))
        b = list(tds.epoch_indices(np.random.default_rng(3), 4, shuffle, drop))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert y.dtype == np.int32

    def test_constructor_errors(self, rng):
        vols, labels = _corpus(rng)
        with pytest.raises(ValueError):
            tdc.DeviceDataset(vols[..., 0], labels, device="cpu")
        with pytest.raises(ValueError):
            tdc.DeviceDataset(vols, labels, device="cpu", quantize="int4")
        with pytest.raises(ValueError):
            tdc.DeviceDataset(vols, labels, device="cpu", quantize="uint8",
                              fused_norm=True)

    def test_out_of_range_index_raises(self, rng):
        vols, labels = _corpus(rng)
        tds = tdc.DeviceDataset(vols, labels, device="cpu")
        with pytest.raises(IndexError):
            tds.gather(np.array([6]))
        with pytest.raises(IndexError):
            tds.gather_normalized(np.array([-1]))

    def test_build_device_dataset(self, tmp_path):
        from multimodal_ad_tpu_torch.data.adni import ADNIManifest
        from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir

        csv_path, mri_dir = make_adni_dir(str(tmp_path), n_per_class=2,
                                          shape=(6, 7, 5), seed=1)
        records = ADNIManifest(csv_path, mri_dir, verbose=False).data_dict
        ds = tdc.build_device_dataset(records, device="cpu", quantize="uint8",
                                      num_threads=2)
        assert ds.volumes.shape == (4, 6, 7, 5, 1)
        assert ds.volumes.dtype == torch.uint8
        assert ds.labels.tolist() == [0, 0, 1, 1]
