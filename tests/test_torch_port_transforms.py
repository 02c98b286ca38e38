"""Port parity on the CPU: host-planned augmentation (data/transforms.py)
and the VolumeBatcher that carries its plans.

- plans against the draws the JAX package's `VolumeTransform(augment=True,
  seed=7)` makes (recorded from its own flip, rotation and zoom calls):
  equal, for 15 (epoch, sample_idx) pairs covering every combination of
  flip, rotate and zoom, and the |zoom - 1| < 1e-6 shortcut;
- the device-side result (K1's plain version, then `apply_plans`) against
  the JAX transform's volume: within 1e-6 (K1 multiplies by a reciprocal
  where the host divides: at most 2 ulp of a value in [0, 1]); from the
  host normalize it is bit-equal;
- `VolumeBatcher` with the train transform against the JAX `VolumeBatcher`
  over the same records (12 subjects in batches of 5: a ragged last batch
  padded with real rows, which repeat their source's draws), two shuffled
  epochs, through train/cv.py's `_device_batches`: order, masks and labels
  equal, images within 1e-6;
- the host call form: `rand_flip` / `rand_rotate` / `rand_zoom` against the
  JAX functions on one seeded generator (the same draws, the generator's
  state equal afterwards, the volumes within 1e-6), their chain drawing
  what `plan_augmentation` draws, and `VolumeTransform(augment, normalizer,
  seed)(vol, sample_idx, epoch)` against the JAX transform for both
  normalizers (within 1e-6).
"""

import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data import pipeline as jpipe
from multimodal_ad_tpu.data import transforms as jtf
from multimodal_ad_tpu_torch.data import pipeline as tpipe
from multimodal_ad_tpu_torch.data import transforms as ttf
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
from multimodal_ad_tpu_torch.train.cv import _device_batches
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

# (epoch, sample_idx) of seed 7 by what the draws take
PAIRS = {
    "none": [(0, 0)], "zoom": [(0, 4), (0, 12)], "rotate": [(0, 5), (0, 14)],
    "flip": [(0, 7), (0, 18)], "rotate+zoom": [(0, 37), (1, 0)],
    "flip+zoom": [(0, 30), (1, 7)], "flip+rotate": [(0, 6)],
    "all three": [(0, 2), (2, 9)],
    "zoom within 1e-6 of 1": [(69, 1474)],  # zoom 0.99999903 is skipped
}
CASES = [(k, e, i) for k, pairs in PAIRS.items() for e, i in pairs]


def _volume(seed=0, shape=(13, 17, 11)):
    return (np.random.default_rng(seed).normal(size=shape) * 40 + 100).astype(np.float32)


def _recording_jax_transform(monkeypatch):
    """The JAX VolumeTransform(augment=True, seed=7), with its flip, angle
    and zoom recorded from its own calls."""
    seen = {}
    flip, rotate, zoom = jtf.rand_flip, jtf._rotate_x, jtf.rand_zoom

    def rand_flip(vol, rng, **kw):
        out = flip(vol, rng, **kw)
        seen["flip"] = out is not vol
        return out

    def rotate_x(vol, angle):
        seen["angle"] = angle
        return rotate(vol, angle)

    def rand_zoom(vol, rng, **kw):
        replay = np.random.Generator(type(rng.bit_generator)())
        replay.bit_generator.state = rng.bit_generator.state
        out = zoom(vol, rng, **kw)
        replay.random()
        seen["zoom"] = None if out is vol else replay.uniform(0.95, 1.0)
        return out

    monkeypatch.setattr(jtf, "rand_flip", rand_flip)
    monkeypatch.setattr(jtf, "_rotate_x", rotate_x)
    monkeypatch.setattr(jtf, "rand_zoom", rand_zoom)
    return jtf.VolumeTransform(augment=True, seed=7), seen


@pytest.mark.parametrize("kind,epoch,idx", CASES, ids=[f"{k}-{e}-{i}" for k, e, i in CASES])
def test_plan_and_volume_match_jax(monkeypatch, kind, epoch, idx):
    jt, seen = _recording_jax_transform(monkeypatch)
    vol = _volume(idx)
    ref = jt(vol, sample_idx=idx, epoch=epoch)
    plan = ttf.VolumeTransform(augment=True, seed=7).plan(idx, epoch)
    assert plan == ttf.AugmentPlan(seen["flip"], seen.get("angle"), seen["zoom"])
    taken = "+".join(n for n, on in (("flip", plan.flip), ("rotate", plan.angle is not None),
                                     ("zoom", plan.zoom is not None)) if on)
    assert taken == {"none": "", "all three": "flip+rotate+zoom",
                     "zoom within 1e-6 of 1": "flip+rotate"}.get(kind, kind)

    x = torch.from_numpy(vol)[None, ..., None]
    out = ttf.apply_plans(scale_intensity(x), [plan])
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0, atol=1e-6)
    host = ttf.apply_plans(torch.from_numpy(jtf.scale_intensity(vol))[None, ..., None], [plan])
    assert np.array_equal(host[0].numpy(), ref)


def test_batched_plans_match_jax_per_volume():
    """One apply_plans call over 12 rows with mixed plans equals the JAX
    transform volume by volume, bit for bit from the host normalize."""
    jt = jtf.VolumeTransform(augment=True, seed=7)
    tt = ttf.VolumeTransform(augment=True, seed=7)
    vols = [_volume(i) for i in range(12)]
    plans = [tt.plan(i, 0) for i in range(12)]
    x = torch.from_numpy(np.stack([jtf.scale_intensity(v) for v in vols]))[..., None]
    out = ttf.apply_plans(x, plans).numpy()
    ref = np.stack([jt(v, sample_idx=i, epoch=0) for i, v in enumerate(vols)])
    assert np.array_equal(out, ref)


def test_eval_transform_and_identity_plans():
    train, evaluate = ttf.make_transforms(augment=True, seed=7)
    assert train.augment and not evaluate.augment
    assert all(evaluate.plan(i, e) == ttf.AugmentPlan() for i in range(20) for e in range(3))
    assert ttf.make_transforms(augment=False)[0].plan(2, 0) == ttf.AugmentPlan()
    x = torch.rand((3, 4, 5, 6, 1))
    assert ttf.apply_plans(x, [ttf.AugmentPlan()] * 3) is x
    with pytest.raises(ValueError, match="one channel"):
        ttf.apply_plans(torch.rand((1, 4, 5, 6, 2)), [ttf.AugmentPlan()])
    with pytest.raises(ValueError, match="plans"):
        ttf.apply_plans(x, [ttf.AugmentPlan()])


def test_volume_batcher_with_transform_matches_jax(adni_dir):
    recs = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], verbose=False).data_dict
    assert len(recs) == 12
    jb = jpipe.VolumeBatcher(recs, jtf.VolumeTransform(augment=True, seed=7), batch_size=5,
                             shuffle=True, seed=3, num_threads=2)
    tb = tpipe.VolumeBatcher(recs, batch_size=5, shuffle=True, seed=3, num_threads=2,
                             transform=ttf.VolumeTransform(augment=True, seed=7))
    orders = []
    for _ in range(2):
        batches = list(_device_batches(tb, "cpu", "scale_intensity", 2))
        for a, b in zip(jb, batches, strict=True):
            assert b["subject"] == a["subject"] and "plan" not in b
            np.testing.assert_array_equal(b["mask"].numpy(), a["mask"])
            np.testing.assert_array_equal(b["label"].numpy(), a["label"])
            np.testing.assert_allclose(b["image"].numpy(), a["image"], rtol=0, atol=1e-6)
        assert batches[-1]["mask"].tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]
        orders.append([s for b in batches for s in b["subject"]])
    assert orders[0] != orders[1]
    # the epochs drew augmentation: not every plan is the identity
    assert sum(tb.transform.plan(i, e) != ttf.AugmentPlan()
               for i in range(12) for e in (0, 1)) >= 6


def test_padding_rows_repeat_their_sources_plans(adni_dir):
    recs = ADNIManifest(adni_dir["label_file"], adni_dir["mri_dir"], verbose=False).data_dict
    tb = tpipe.VolumeBatcher(recs, batch_size=5, num_threads=2,
                             transform=ttf.VolumeTransform(augment=True, seed=7))
    first, *_, last = list(tb)
    tt = ttf.VolumeTransform(augment=True, seed=7)
    assert first["plan"] == [tt.plan(i, 0) for i in range(5)]
    # 12 in order: the last batch is rows 10, 11 and the padding rows 0, 1, 2
    assert last["plan"] == [tt.plan(i, 0) for i in (10, 11, 0, 1, 2)]
    assert "plan" not in next(iter(tpipe.VolumeBatcher(recs, batch_size=5, num_threads=2)))


RAND_CASES = [("rand_flip", {}), ("rand_flip", {"prob": 1.0, "axis": 2}),
              ("rand_rotate", {}), ("rand_rotate", {"prob": 1.0, "range_x": 0.3}),
              ("rand_zoom", {}), ("rand_zoom", {"prob": 1.0, "min_zoom": 0.8, "max_zoom": 1.2})]


@pytest.mark.parametrize("name,kw", RAND_CASES,
                         ids=[f"{n}-{'default' if not kw else 'p1'}" for n, kw in RAND_CASES])
def test_rand_function_matches_jax(name, kw):
    """The host call form: the same draws (the generator's state equal
    afterwards) and the same volume within 1e-6, taken and skipped."""
    taken = 0
    for seed in range(16):
        vol = jtf.scale_intensity(_volume(seed))
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = getattr(jtf, name)(vol, rj, **kw)
        out = getattr(ttf, name)(vol, rt, **kw)
        assert rt.bit_generator.state == rj.bit_generator.state
        assert out.shape == ref.shape and out.dtype == ref.dtype
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        taken += out is not vol
    assert 0 < taken and (taken < 16 or kw)


def test_chained_rand_functions_draw_what_plan_draws():
    for seed in range(40):
        rng, plan_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        ttf.rand_zoom(ttf.rand_rotate(ttf.rand_flip(_volume(seed), rng), rng), rng)
        ttf.plan_augmentation(plan_rng)
        assert rng.bit_generator.state == plan_rng.bit_generator.state


@pytest.mark.parametrize("normalizer", ["scale_intensity", "adaptive_normal"])
def test_volume_transform_call_matches_jax(normalizer):
    """`VolumeTransform(augment, normalizer, seed)(vol, sample_idx, epoch)`
    against the JAX transform over every kind of draw, and the evaluation
    transform of `make_transforms`: within 1e-6."""
    jt = jtf.VolumeTransform(augment=True, normalizer=normalizer, seed=7)
    tt = ttf.VolumeTransform(augment=True, normalizer=normalizer, seed=7)
    for _, epoch, idx in CASES:
        vol = _volume(idx) - 90  # negatives, which adaptive_normal leaves out
        out = tt(vol, sample_idx=idx, epoch=epoch)
        assert out.shape == vol.shape + (1,) and out.dtype == np.float32
        np.testing.assert_allclose(out, jt(vol, sample_idx=idx, epoch=epoch), rtol=0, atol=1e-6)
    _, t_eval = ttf.make_transforms(augment=True, seed=7, normalizer=normalizer)
    _, j_eval = jtf.make_transforms(augment=True, seed=7, normalizer=normalizer)
    assert t_eval.normalizer == normalizer and not t_eval.augment
    vol = _volume(3) - 90
    np.testing.assert_allclose(t_eval(vol, 3, 1), j_eval(vol, 3, 1), rtol=0, atol=1e-6)
    with pytest.raises(KeyError):
        ttf.VolumeTransform(normalizer="zscore")
