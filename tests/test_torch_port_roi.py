"""Port parity on the CPU: K2's plain version (atlas ROI pooling) against
the JAX package's `roi_pool_xla`, `roi_pool_pallas` in interpret mode and
the dense golden of tests/test_ops.py, on the same seeded numpy inputs;
the atlas state (`RoiAtlas`) and the tile plan the kernel follows, summed
along by a plain walker; and which variant of the kernel a layout takes.
The kernel's own tests, which need a card, are in
test_torch_port_guards.py (that file imports no JAX, so it also runs on
the card's machine).

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
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

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


def _plan_case(tile_size):
    """A 9x11x10 atlas of 6 ROIs with ROI 4 emptied, one id past the last,
    a one-voxel ROI 7 and ROI 1 grown over whole rows, so runs break at
    rows, at tiles and between ROIs."""
    labels = jax_make_atlas((9, 11, 10), n_rois=6, seed=3)
    labels[labels == 4] = 0
    labels[2:4, :, :] = 1
    labels[8, 10, 9] = 7
    return labels, trp.RoiAtlas.build(labels, 8, tile_size=tile_size)


def _run_voxels(atlas):
    """Flat voxel indices of every run, in plan order, and each run's tile."""
    _, ys, zs = atlas.shape
    runs = atlas.runs.long()
    flat = [(x * ys + y) * zs + z0 + np.arange(n) for x, y, z0, n in runs.tolist()]
    tile_of_run = np.repeat(np.arange(atlas.num_tiles), np.diff(atlas.tile_runs.numpy()))
    return flat, tile_of_run


def walk_plan(feats, atlas):
    """The kernel's arithmetic in float64 and in plain Python: each tile's
    runs are read from the raw storage through `plan_strides` and summed,
    then each ROI's tile sums in tile order, divided by the clamped count."""
    s_b, s_x, s_y, s_z, s_c = trp.plan_strides(feats, atlas)
    n_store = feats.untyped_storage().nbytes() // feats.element_size()
    store = feats.as_strided((n_store,), (1,), 0).double()
    b, c = feats.shape[0], feats.shape[-1]
    chans = torch.arange(c) * s_c
    batch = torch.arange(b) * s_b
    partial = torch.zeros((b, atlas.num_tiles, c), dtype=torch.float64)
    tile_runs = atlas.tile_runs.tolist()
    for t in range(atlas.num_tiles):
        for x, y, z0, n in atlas.runs[tile_runs[t]:tile_runs[t + 1]].long().tolist():
            z = torch.arange(z0, z0 + n)
            off = feats.storage_offset() + x * s_x + y * s_y + z[:, None] * s_z + chans
            partial[:, t] += store[batch[:, None, None] + off].sum(1)
    roi_tiles = atlas.roi_tiles.tolist()
    sums = torch.stack([partial[:, roi_tiles[r]:roi_tiles[r + 1]].sum(1)
                        for r in range(atlas.num_rois)], 1)
    return sums / atlas.counts.double().clamp(min=1e-6)[None, :, None]


class TestTilePlan:
    """The tile plan K2 follows (RoiAtlas.runs, tile_runs, tile_starts,
    roi_tiles), checked on the CPU."""

    @pytest.mark.parametrize("tile_size", [1, 7, 16, 512])
    def test_covers_every_labelled_voxel_once_in_label_order(self, tile_size):
        _, atlas = _plan_case(tile_size)
        flat, _ = _run_voxels(atlas)
        np.testing.assert_array_equal(np.concatenate(flat), atlas.order.numpy())
        starts = atlas.tile_starts.numpy()
        assert starts[0] == 0 and starts[-1] == atlas.order.numel()
        lengths = atlas.runs[:, 3].numpy()
        per_tile = np.add.reduceat(lengths, atlas.tile_runs.numpy()[:-1])
        np.testing.assert_array_equal(per_tile, np.diff(starts))

    @pytest.mark.parametrize("tile_size", [1, 7, 16, 512])
    def test_no_run_crosses_a_row_or_an_roi(self, tile_size):
        labels, atlas = _plan_case(tile_size)
        flat_labels = labels.reshape(-1)
        flat, tile_of_run = _run_voxels(atlas)
        x, y, z0, n = atlas.runs.numpy().T
        assert (n >= 1).all() and (z0 + n <= atlas.shape[2]).all()
        assert (x < atlas.shape[0]).all() and (y < atlas.shape[1]).all()
        roi_of_tile = np.repeat(np.arange(1, atlas.num_rois + 1),
                                np.diff(atlas.roi_tiles.numpy()))
        for vox, t in zip(flat, tile_of_run):
            assert (flat_labels[vox] == roi_of_tile[t]).all()

    @pytest.mark.parametrize("tile_size", [1, 7, 16, 512])
    def test_tiles_hold_at_most_t_voxels(self, tile_size):
        _, atlas = _plan_case(tile_size)
        sizes = np.diff(atlas.tile_starts.numpy())
        assert (sizes >= 1).all() and (sizes <= tile_size).all()
        counts = atlas.counts.numpy().astype(np.int64)
        np.testing.assert_array_equal(np.diff(atlas.roi_tiles.numpy()),
                                      -(-counts // tile_size))
        assert atlas.tile_size == tile_size

    def test_runs_are_maximal_within_a_tile(self):
        """With one tile per ROI, runs break only at rows and gaps: ROI 1's
        two whole slabs are 2 * 11 rows of 10 voxels."""
        labels, atlas = _plan_case(10_000)
        roi1 = atlas.runs[atlas.tile_runs[0]:atlas.tile_runs[1]].numpy()
        whole_rows = roi1[(roi1[:, 0] >= 2) & (roi1[:, 0] <= 3)]
        assert len(whole_rows) == 22 and (whole_rows[:, 3] == 10).all()
        np.testing.assert_array_equal(atlas.runs[-1].numpy(), [8, 10, 9, 1])

    @pytest.mark.parametrize("layout", ["dense", "padded crop", "flat"])
    @pytest.mark.parametrize("tile_size", [7, 512])
    def test_walker_matches_plain(self, layout, tile_size):
        labels, atlas = _plan_case(tile_size)
        g = torch.Generator().manual_seed(0)
        if layout == "padded crop":  # as the U-Net's tap: a crop of a padded map
            feats = torch.randn((2, 16, 16, 16, 8), generator=g)[:, :9, :11, :10]
        else:
            feats = torch.randn((2, 9, 11, 10, 8), generator=g)
            if layout == "flat":
                feats = feats.reshape(2, -1, 8)
        ours = walk_plan(feats, atlas)
        ref = trp.roi_pool_plain(feats, atlas, 8)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)

    def test_flat_labels_plan_one_row(self):
        labels, _ = _plan_case(16)
        atlas = trp.RoiAtlas.build(labels.reshape(-1), 8, tile_size=16)
        assert atlas.shape == (1, 1, labels.size)
        flat, _ = _run_voxels(atlas)
        np.testing.assert_array_equal(np.concatenate(flat), atlas.order.numpy())
        feats = torch.randn((2, *labels.shape, 4), generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(walk_plan(feats, atlas).numpy(),
                                   trp.roi_pool_plain(feats, atlas, 8).numpy(),
                                   rtol=RTOL, atol=ATOL)

    def test_all_background_has_no_tiles(self):
        atlas = trp.RoiAtlas.build(np.zeros((3, 4, 5), np.int32), 2)
        assert atlas.num_tiles == 0 and atlas.runs.shape == (0, 4)
        np.testing.assert_array_equal(atlas.roi_tiles.numpy(), [0, 0, 0])


class TestKernelPath:
    """Which variant of K2 a layout takes (decided on the host, so checked
    here on CPU tensors)."""

    def test_tap_crop_takes_the_bulk_path(self):
        labels, atlas = _plan_case(16)
        tap = torch.zeros((2, 16, 16, 16, 64))[:, :9, :11, :10]
        assert trp.plan_strides(tap, atlas) == tap.stride()
        assert trp.k2_path(tap, atlas) == "bulk"
        assert trp.k2_path(tap.to(torch.bfloat16), atlas) == "bulk"

    @pytest.mark.parametrize("case", ["channel crop", "unaligned rows", "channels first"])
    def test_other_layouts_take_the_simt_path(self, case):
        labels, atlas = _plan_case(16)
        if case == "channel crop":  # voxel stride 66, not C = 64
            feats = torch.zeros((2, 9, 11, 10, 66))[..., 1:65]
        elif case == "unaligned rows":  # 3 floats a voxel: 12-byte rows
            feats = torch.zeros((2, 9, 11, 10, 3))
        else:
            feats = torch.zeros((2, 64, 9, 11, 10)).permute(0, 2, 3, 4, 1)
        assert trp.k2_path(feats, atlas) == "simt"

    def test_flat_features_index_a_3d_atlas(self):
        _, atlas = _plan_case(16)
        feats = torch.zeros((2, 990, 8))
        assert trp.plan_strides(feats, atlas) == (990 * 8, 110 * 8, 10 * 8, 8, 1)

    def test_grid_mismatch_raises(self):
        _, atlas = _plan_case(16)
        strided = torch.zeros((2, 11, 9, 12, 4))[:, :, :, :10]  # 990 voxels, other grid
        with pytest.raises(ValueError, match="do not match"):
            trp.plan_strides(strided, atlas)
