"""Measure the port's parity errors against the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_parity_cpu.py

Runs the comparisons of tests/test_torch_port_*.py on the same seeded
inputs and prints the largest absolute difference of each, one line per
comparison, so PERF.md can quote measured errors rather than the tests'
bounds. Needs both jax and torch; runs in about a minute.
"""

from __future__ import annotations

import csv
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

from multimodal_ad_tpu.data.transforms import scale_intensity as host_scale  # noqa: E402
from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D  # noqa: E402
from multimodal_ad_tpu.models.resnet3d import generate_model as jgen  # noqa: E402
from multimodal_ad_tpu.ops import fused_gather as jfg  # noqa: E402
from multimodal_ad_tpu.ops import normalize as jnorm  # noqa: E402
from multimodal_ad_tpu.data.synthetic import make_adni_dir, make_atlas  # noqa: E402
from multimodal_ad_tpu.data.adni import ADNIManifest  # noqa: E402
from multimodal_ad_tpu.eval.features import \
    extract_unet_features as jax_extract  # noqa: E402
from multimodal_ad_tpu.models.unet3d import UNet3D as JaxUNet3D  # noqa: E402
from multimodal_ad_tpu.models.unet3d import unet_forward_with_features  # noqa: E402
from multimodal_ad_tpu.ops.roi_pool import roi_pool_pallas, roi_pool_xla  # noqa: E402
from multimodal_ad_tpu.parallel.mesh import make_mesh  # noqa: E402
from multimodal_ad_tpu.serve import EnsemblePredictor as JaxPredictor  # noqa: E402
from multimodal_ad_tpu_torch.data.synthetic import make_volume  # noqa: E402
from multimodal_ad_tpu_torch.eval.features import extract_unet_features  # noqa: E402
from multimodal_ad_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from multimodal_ad_tpu_torch.ops import roi_pool as trp  # noqa: E402
from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D, generate_model  # noqa: E402
from multimodal_ad_tpu_torch.ops import fused_gather as tfg  # noqa: E402
from multimodal_ad_tpu_torch.ops import normalize as tnorm  # noqa: E402
from multimodal_ad_tpu_torch.serve import EnsemblePredictor  # noqa: E402
from multimodal_ad_tpu_torch.utils.torch_weights import (  # noqa: E402
    state_dict_from_flax, unet3d_state_dict_from_flax)


def random_flax_variables(model, shape, seed):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape), jnp.float32),
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


def report(name, a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    print(f"{name:58s} max|d| {np.abs(a - b).max():.3e}", flush=True)


def main():
    rng = np.random.default_rng(42)
    # K1 plain version vs the Pallas kernel (interpret) and the XLA twin
    vols = rng.integers(-50, 4096, (5, 9, 11, 10, 1)).astype(np.int16)
    corpus, vox = jfg.flatten_corpus(vols)
    idx = np.array([3, 0, 4, 4], np.int32)
    for jdt, tdt, tag in ((jnp.float32, torch.float32, "f32"),
                          (jnp.bfloat16, torch.bfloat16, "bf16")):
        ours = tfg.gather_normalize_plain(torch.from_numpy(vols),
                                          torch.from_numpy(idx), tdt)
        ours = ours.float().numpy().reshape(4, -1)
        pallas = np.asarray(jfg.gather_normalize_pallas(
            jnp.asarray(corpus), idx, vox, interpret=True, out_dtype=jdt),
            np.float32).reshape(4, -1)[:, :vox]
        xla = np.asarray(jfg.gather_normalize_xla(
            jnp.asarray(corpus), idx, vox, out_dtype=jdt),
            np.float32).reshape(4, -1)[:, :vox]
        report(f"K1 plain vs gather_normalize_pallas(interpret) {tag}", ours, pallas)
        report(f"K1 plain vs gather_normalize_xla {tag}", ours, xla)
    f = rng.normal(20, 7, size=(3, 9, 10, 8)).astype(np.float32)
    ours = tnorm.scale_intensity(torch.from_numpy(f[..., None])).numpy()[..., 0]
    report("scale_intensity vs JAX scale_intensity",
           ours, np.asarray(jnorm.scale_intensity(jnp.asarray(f[..., None])))[..., 0])
    report("scale_intensity vs host transforms.scale_intensity",
           ours, np.stack([host_scale(v) for v in f]))
    a = np.abs(rng.normal(100, 30, size=(3, 11, 9, 10, 1))).astype(np.float32)
    report("adaptive_normal vs JAX adaptive_normal",
           tnorm.adaptive_normal(torch.from_numpy(a)).numpy(),
           np.asarray(jnorm.adaptive_normal(jnp.asarray(a))))

    # ResNet forward parity (the test cases)
    cases = [(10, "B", "classifier", (16, 16, 16, 1)),
             (10, "A", "none", (15, 17, 15, 1)),
             (18, "B", "classifier", (15, 17, 15, 1)),
             (18, "A", "pool", (16, 18, 16, 1)),
             (18, "B", "none", (17, 15, 13, 2)),
             (50, "B", "classifier", (12, 13, 12, 1))]
    for depth, sc, head, shape in cases:
        jm = JaxResNet3D(depth=depth, head=head, shortcut_type=sc,
                         in_channels=shape[-1], dtype=jnp.float32)
        v = random_flax_variables(jm, shape, seed=depth)
        x = np.random.default_rng(1).normal(size=(2, *shape)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            v, jnp.asarray(x)))
        tm = ResNet3D(depth=depth, head=head, shortcut_type=sc,
                      in_channels=shape[-1], compute_dtype=torch.float32).eval()
        tm.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, v), depth, sc))
        with torch.no_grad():
            ours = tm(torch.from_numpy(x)).numpy()
        report(f"ResNet3D depth {depth} shortcut {sc} head {head} "
               f"{'x'.join(map(str, shape[:3]))}", ours, ref)

    # slice: 2-fold depth-10 ensemble, 6 volumes at batch 4
    shape = (16, 20, 16)
    jm = jgen(model_depth=10, nb_class=2, compute_dtype=jnp.float32)
    fold_vars = [random_flax_variables(jm, (*shape, 1), s) for s in (1, 2)]
    sds = [state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B")
           for v in fold_vars]
    vrng = np.random.default_rng(0)
    vols = np.stack([make_volume(vrng, shape, label=i % 2) for i in range(6)])
    ref = JaxPredictor(jm, fold_vars, batch_size=4).predict_proba(vols)
    port = EnsemblePredictor(generate_model(model_depth=10,
                                            compute_dtype=torch.float32),
                             sds, batch_size=4, device="cpu")
    ours = port.predict_proba(vols)
    report("EnsemblePredictor.predict_proba (2 folds, 6 vols, bs 4)", ours, ref)
    print(f"prob_1 port {np.round(ours[:, 1], 4).tolist()}")

    # K2 plain version vs roi_pool_xla / roi_pool_pallas(interpret)
    shape = (12, 14, 12)
    labels = make_atlas(shape, n_rois=5, seed=1)
    feats = np.random.default_rng(0).normal(size=(2, *shape, 8)).astype(np.float32)
    ours = trp.roi_pool_plain(torch.from_numpy(feats), torch.from_numpy(labels), 5)
    report("K2 plain vs roi_pool_xla", ours,
           roi_pool_xla(jnp.asarray(feats), jnp.asarray(labels), 5))
    report("K2 plain vs roi_pool_pallas(tile_n=512, interpret)", ours,
           roi_pool_pallas(jnp.asarray(feats), jnp.asarray(labels), 5, tile_n=512,
                           interpret=True))

    # UNet3D (8, 16, 32)/64, fp32, randomized BN statistics: output and tap
    narrow = dict(level_channels=(8, 16, 32), bottleneck_channel=64)
    for shape in ((15, 17, 13), (20, 24, 20)):
        jm = JaxUNet3D(dtype=jnp.float32, **narrow)
        v = random_flax_variables(jm, (*shape, 1), seed=sum(shape))
        x = np.random.default_rng(1).normal(size=(2, *shape, 1)).astype(np.float32)
        out, tap = jax.jit(lambda v, x: unet_forward_with_features(jm, v, x))(
            v, jnp.asarray(x))
        tm = UNet3D(**narrow).eval()
        tm.load_state_dict(unet3d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v)))
        with torch.no_grad():
            o, t = tm(torch.from_numpy(x), return_features=True)
        tag = "x".join(map(str, shape))
        report(f"UNet3D output {tag}", o.numpy(), out)
        report(f"UNet3D 64-ch tap (8 ch here) {tag}", t.numpy(), tap)

    # slice: extract_unet_features on 5 subjects, converted weights
    with tempfile.TemporaryDirectory() as root:
        shape = (20, 24, 20)
        csv_path, mri = make_adni_dir(root, n_per_class=6, shape=shape, seed=0)
        records = ADNIManifest(csv_path, mri, "ADCN", verbose=False).data_dict[:5]
        labels = make_atlas(shape, n_rois=3, seed=0)
        jm = JaxUNet3D(dtype=jnp.float32, **narrow)
        v = random_flax_variables(jm, (*shape, 1), seed=11)
        tm = UNet3D(**narrow)
        tm.load_state_dict(unet3d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v)))
        ref = jax_extract(records, labels, ["A", "B", "C"], os.path.join(root, "jax"),
                          model=jm, variables=v, batch_size=8,
                          mesh=make_mesh({"data": -1}), num_threads=2)
        ours = extract_unet_features(records, labels, ["A", "B", "C"],
                                     os.path.join(root, "port"), model=tm, batch_size=2,
                                     num_threads=2, device="cpu")
        for name, a, b in zip(("features.csv", "roi_features.csv"), ours, ref):
            rows_a, rows_b = (list(csv.reader(open(p))) for p in (a, b))
            assert rows_a[0] == rows_b[0] and [r[0] for r in rows_a] == [r[0] for r in rows_b]
            report(f"extract_unet_features {name} (5 subjects)",
                   np.asarray([r[1:] for r in rows_a[1:]], float),
                   np.asarray([r[1:] for r in rows_b[1:]], float))

    training_parity()


def training_parity():
    """The training slice: 3 fp32 train steps of ResNet-10 (both
    shortcuts), precise-BN, the schedule, the augmentation geometry and the
    epoch iterator, each against the JAX package."""
    from multimodal_ad_tpu.data import device_cache as jdc
    from multimodal_ad_tpu.ops import augment as jaug
    from multimodal_ad_tpu.train import loop as jloop
    from multimodal_ad_tpu_torch.data import device_cache as tdc
    from multimodal_ad_tpu_torch.ops import augment as taug
    from multimodal_ad_tpu_torch.train import loop as tloop

    shape, lr, cw = (16, 20, 16, 1), 1e-3, np.array([0.3, 0.7], np.float32)
    brng = np.random.default_rng(8)
    batches = [{"image": (brng.normal(size=(4, *shape)) * 2 + 1).astype(np.float32),
                "label": np.array([0, 1, 1, 0], np.int32),
                "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(3)]
    for sc in ("A", "B"):
        jm = jgen(model_depth=10, resnet_shortcut=sc, dropout_rate=0.0,
                  compute_dtype=jnp.float32)
        v = random_flax_variables(jm, shape, seed=7)
        tx = jloop.make_optimizer(jloop.make_epoch_schedule(lr, 20), 1e-4, 1.0, "adam")
        js = jloop.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]),
                              epoch=jnp.zeros((), jnp.int32), tx=tx, apply_fn=jm.apply)
        tm = generate_model(model_depth=10, resnet_shortcut=sc, dropout_rate=0.0,
                            compute_dtype=torch.float32)
        tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, sc))
        ts = tloop.create_train_state(tm, tloop.make_epoch_schedule(lr, 20))
        step = jloop.make_train_step(2)
        rel = 0.0
        for b in batches:
            js, jl, _ = step(js, {k: jnp.asarray(x) for k, x in b.items()},
                             jnp.asarray(cw), jax.random.PRNGKey(0))
            tl, _ = tloop.train_step(ts, {k: torch.from_numpy(x) for k, x in b.items()},
                                     torch.from_numpy(cw))
            rel = max(rel, abs(float(tl) - float(jl)) / abs(float(jl)))
        ref = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": js.params, "batch_stats": js.batch_stats}), 10, sc)
        ours = tm.state_dict()
        stats = max(float((ours[k] - x).abs().max()) for k, x in ref.items() if ".running_" in k)
        d = torch.cat([(ours[k] - x).abs().flatten() for k, x in ref.items()
                       if ".running_" not in k and "num_batches" not in k])
        print(f"{'3 fp32 train steps ResNet-10 ' + sc + ': loss max rel':58s} {rel:.3e}")
        print(f"{'  BN running stats':58s} max|d| {stats:.3e}")
        print(f"{'  parameters':58s} max|d| {float(d.max()):.3e}, "
              f"{float((d <= 1e-5).float().mean()):.7f} within 1e-5")
        if sc == "B":
            pb = [{k: x for k, x in b.items()} for b in batches[:2]]
            js = jloop.recompute_batch_stats(js, [{k: jnp.asarray(x) for k, x in b.items()}
                                                  for b in pb])
            tloop.recompute_batch_stats(ts, [{k: torch.from_numpy(x) for k, x in b.items()}
                                             for b in pb])
            ref = state_dict_from_flax(jax.tree_util.tree_map(
                np.asarray, {"params": js.params, "batch_stats": js.batch_stats}), 10, sc)
            stats = max(float((tm.state_dict()[k] - x).abs().max())
                        for k, x in ref.items() if ".running_" in k)
            print(f"{'precise-BN (2 batches) running stats':58s} max|d| {stats:.3e}")

    for epochs in (5, 20, 100):
        js = jloop.make_epoch_schedule(lr, epochs)
        tsch = tloop.make_epoch_schedule(lr, epochs)
        rel = max(abs(tsch(k) - float(js(k))) / float(js(k)) for k in range(31))
        print(f"{f'schedule, updates 0-30, {epochs} epochs: max rel':58s} {rel:.3e}")

    vol = np.random.default_rng(2).random((9, 11, 8, 2)).astype(np.float32)
    worst = 0.0
    for angle, zoom in ((0.05, 1.0), (-0.04, 0.96), (0.6, 0.8), (1.3, 1.25)):
        ref = np.asarray(jaug.rotate_zoom_volume(jnp.asarray(vol), jnp.float32(angle),
                                                 jnp.float32(zoom)))
        ours = taug.rotate_zoom_volume(torch.from_numpy(vol), angle, zoom).numpy()
        worst = max(worst, float(np.abs(ours - ref).max()))
    print(f"{'rotate_zoom_volume, 4 angle/zoom pairs':58s} max|d| {worst:.3e}")

    vols = (np.random.default_rng(5).normal(size=(11, 6, 7, 5, 1)) * 40 + 100).astype(np.float32)
    labels = (np.arange(11) % 2).astype(np.int32)
    plan, worst = [9, 3, 0, 4, 7, 1, 10], 0.0
    for norm in ("scale_intensity", "adaptive_normal"):
        kw = dict(batch_size=3, shuffle=True, seed=4, normalizer=norm)
        jit = jdc.DeviceEpochIterator(jdc.DeviceDataset(vols, labels), plan, **kw)
        tit = tdc.DeviceEpochIterator(tdc.DeviceDataset(vols, labels, device="cpu"), plan, **kw)
        for a, b in zip([x for _ in range(2) for x in jit], [x for _ in range(2) for x in tit]):
            assert a["subject"] == b["subject"]
            worst = max(worst, float(np.abs(b["image"].numpy() - np.asarray(a["image"])).max()))
    print(f"{'DeviceEpochIterator images, 2 epochs, both normalizers':58s} max|d| {worst:.3e}")


if __name__ == "__main__":
    main()
