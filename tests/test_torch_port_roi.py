"""Port parity on the CPU: K2's plain version (atlas ROI pooling) against
the JAX package's `roi_pool_xla`, `roi_pool_pallas` in interpret mode and
the dense golden of tests/test_ops.py, on the same seeded numpy inputs;
and the atlas state (`RoiAtlas`). The kernel's own tests, which need a
card, are in test_torch_port_guards.py (that file imports no JAX, so it
also runs on the card's machine).

Tolerances: rtol 1e-4, atol 1e-5 against the JAX functions, as
tests/test_ops.py holds them to each other (the sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data.synthetic import make_atlas as jax_make_atlas
from multimodal_ad_tpu.ops.roi_pool import roi_counts as jax_roi_counts
from multimodal_ad_tpu.ops.roi_pool import roi_pool_pallas, roi_pool_xla
from multimodal_ad_tpu_torch.ops import roi_pool as trp

RTOL, ATOL = 1e-4, 1e-5


def reference_roi_pool_dense(feats, labels, num_rois):
    """The reference's dense broadcast reduction, as tests/test_ops.py
    transcribes it."""
    onehot = np.stack([(labels == r).astype(np.float32)
                       for r in range(1, num_rois + 1)])  # (R, X, Y, Z)
    num = (feats[:, None] * onehot[None, :, :, :, :, None]).sum(axis=(2, 3, 4))
    den = onehot.sum(axis=(1, 2, 3)).clip(1e-6)
    return num / den[None, :, None]


@pytest.fixture(scope="module")
def roi_case():
    rng = np.random.default_rng(0)
    shape = (12, 14, 12)
    labels = jax_make_atlas(shape, n_rois=5, seed=1)
    feats = rng.normal(size=(2, *shape, 8)).astype(np.float32)
    return feats, labels, 5


def _plain(feats, labels, r):
    return trp.roi_pool_plain(torch.from_numpy(feats), torch.from_numpy(labels),
                              r).numpy()


class TestRoiPoolPlain:
    """The cases of tests/test_ops.py's TestRoiPool."""

    def test_matches_reference_dense(self, roi_case):
        feats, labels, r = roi_case
        np.testing.assert_allclose(_plain(feats, labels, r),
                                   reference_roi_pool_dense(feats, labels, r),
                                   rtol=RTOL, atol=ATOL)

    def test_matches_xla_and_pallas(self, roi_case):
        feats, labels, r = roi_case
        ours = _plain(feats, labels, r)
        xla = np.asarray(roi_pool_xla(jnp.asarray(feats), jnp.asarray(labels), r))
        pallas = np.asarray(roi_pool_pallas(jnp.asarray(feats), jnp.asarray(labels),
                                            r, tile_n=512, interpret=True))
        assert ours.shape == (2, 5, 8) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)

    def test_bf16_features_accumulate_in_f32(self, roi_case):
        """bf16 features are widened exactly and summed in f32, as the JAX
        einsum's preferred_element_type=f32 does (its bf16 x bf16 -> f32
        dot does not run on the CPU, so the reference takes the widened
        values)."""
        feats, labels, r = roi_case
        f16 = torch.from_numpy(feats).to(torch.bfloat16)
        ours = trp.roi_pool_plain(f16, torch.from_numpy(labels), r)
        assert ours.dtype == torch.float32
        xla = np.asarray(roi_pool_xla(jnp.asarray(f16.float().numpy()),
                                      jnp.asarray(labels), r))
        np.testing.assert_allclose(ours.numpy(), xla, rtol=RTOL, atol=ATOL)

    def test_empty_roi_clamped(self):
        labels = np.ones((4, 4, 4), np.int32)  # only ROI 1 present
        feats = np.ones((1, 4, 4, 4, 2), np.float32)
        ours = _plain(feats, labels, 3)
        ref = np.asarray(roi_pool_xla(jnp.asarray(feats), jnp.asarray(labels), 3))
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours[0, 0], 1.0, rtol=1e-5)
        np.testing.assert_allclose(ours[0, 1:], 0.0)
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)

    def test_counts(self):
        labels = np.array([[[0, 1], [1, 2]], [[2, 2], [3, 0]]], np.int32)
        ours = trp.roi_counts(torch.from_numpy(labels), 4).numpy()
        np.testing.assert_array_equal(ours, [2, 3, 1, 0])
        np.testing.assert_array_equal(
            ours, np.asarray(jax_roi_counts(jnp.asarray(labels), 4)))

    def test_flat_input_accepted(self, roi_case):
        feats, labels, r = roi_case
        b, _, _, _, c = feats.shape
        a = _plain(feats, labels, r)
        flat = _plain(feats.reshape(b, -1, c), labels.reshape(-1), r)
        np.testing.assert_allclose(a, flat, rtol=1e-6)

    def test_voxel_slices_do_not_change_the_result(self, roi_case, monkeypatch):
        """The one-hot is built a slice of voxels at a time; slices of 7
        voxels give the one-einsum result."""
        feats, labels, r = roi_case
        whole = _plain(feats, labels, r)
        monkeypatch.setattr(trp, "_ONEHOT_ELEMS", 7 * r)
        np.testing.assert_allclose(_plain(feats, labels, r), whole,
                                   rtol=1e-6, atol=1e-7)


class TestWrapperOnCpu:
    def test_wrapper_is_plain_and_launches_nothing(self, roi_case):
        feats, labels, r = roi_case
        before = trp.roi_pool.launches
        out = trp.roi_pool(torch.from_numpy(feats), labels, r)
        assert torch.equal(out, torch.from_numpy(_plain(feats, labels, r)))
        assert trp.roi_pool.launches == before

    def test_atlas_state_gives_the_same_means(self, roi_case):
        feats, labels, r = roi_case
        atlas = trp.RoiAtlas.build(labels, r)
        out = trp.roi_pool(torch.from_numpy(feats), atlas, r)
        np.testing.assert_array_equal(out.numpy(), _plain(feats, labels, r))


class TestRoiAtlas:
    def test_segments_hold_each_roi_in_ascending_order(self):
        labels = jax_make_atlas((9, 11, 10), n_rois=6, seed=3)
        labels[labels == 4] = 0  # an ROI without voxels
        atlas = trp.RoiAtlas.build(labels, 7)  # and one id past the last
        flat = labels.reshape(-1)
        order = atlas.order.numpy()
        offsets = atlas.offsets.numpy()
        assert offsets[0] == 0 and offsets[-1] == (flat > 0).sum()
        for r in range(1, 8):
            seg = order[offsets[r - 1]:offsets[r]]
            np.testing.assert_array_equal(seg, np.flatnonzero(flat == r))
        np.testing.assert_array_equal(atlas.counts.numpy(),
                                      np.bincount(flat, minlength=8)[1:])
        assert atlas.order.dtype == atlas.offsets.dtype == torch.int32

    @pytest.mark.parametrize("bad", [-1, 6])
    def test_rejects_labels_out_of_range(self, bad):
        labels = np.zeros((3, 3, 3), np.int32)
        labels[1, 1, 1] = bad
        with pytest.raises(ValueError, match="labels span"):
            trp.RoiAtlas.build(labels, 5)
