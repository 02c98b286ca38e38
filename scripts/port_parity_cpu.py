"""Measure the port's parity errors against the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_parity_cpu.py

Runs the comparisons of tests/test_torch_port_*.py on the same seeded
inputs and prints the largest absolute difference of each, one line per
comparison, so PERF.md can quote measured errors rather than the tests'
bounds. Needs both jax and torch; runs in a few minutes. `--only int8`
runs the int8 serving slice's comparisons alone; `--only densenet`,
`--only encoder` and `--only hypergraph` those of the DenseNet (and its
trainer's BN statistics), of the encoder features with the seg head and
the stage taps, and of MSHyper; `--only tabular` those of the tabular
in-context slice (the msgpack reader, the loaders, the sklearn
replacements, the networks, the classifier, regressor and embedder).
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
    only = {"int8": int8_parity, "densenet": densenet_parity, "encoder": encoder_parity,
            "hypergraph": hypergraph_parity, "tabular": tabular_parity}
    if sys.argv[1:2] == ["--only"]:
        if len(sys.argv) != 3 or sys.argv[2] not in only:
            raise SystemExit(f"usage: port_parity_cpu.py [--only {'|'.join(only)}]")
        only[sys.argv[2]]()
        return
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
    unet_training_parity()
    int8_parity()
    densenet_parity()
    encoder_parity()
    hypergraph_parity()


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


def unet_training_parity():
    """The U-Net training slice: host-planned augmentation and its batcher,
    the classifier forward, UNet3D train-mode BN statistics, three AdamW
    steps of the classifier, one autoencoder step on JAX's mask, the
    cosine schedule; each against the JAX package."""
    import optax

    from multimodal_ad_tpu.data import pipeline as jpipe
    from multimodal_ad_tpu.data import transforms as jtf
    from multimodal_ad_tpu.models.unet3d import UNet3DClassifier as JaxClassifier
    from multimodal_ad_tpu.train import autoencoder as jae
    from multimodal_ad_tpu.train import loop as jloop
    from multimodal_ad_tpu_torch.data import pipeline as tpipe
    from multimodal_ad_tpu_torch.data import transforms as ttf
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest as TManifest
    from multimodal_ad_tpu_torch.models.unet3d import UNet3DClassifier
    from multimodal_ad_tpu_torch.train import autoencoder as tae
    from multimodal_ad_tpu_torch.train import loop as tloop
    from multimodal_ad_tpu_torch.train.cv import _device_batches
    from multimodal_ad_tpu_torch.utils.torch_weights import (
        unet3d_classifier_state_dict_from_flax)

    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jt, tt = jtf.VolumeTransform(augment=True, seed=7), ttf.VolumeTransform(augment=True, seed=7)
    worst, exact = 0.0, True
    for idx in range(60):
        vol = (np.random.default_rng(idx).normal(size=(13, 17, 11)) * 40 + 100).astype(np.float32)
        ref = jt(vol, sample_idx=idx, epoch=idx % 3)
        plan = [tt.plan(idx, idx % 3)]
        ours = ttf.apply_plans(tnorm.scale_intensity(torch.from_numpy(vol)[None, ..., None]), plan)
        worst = max(worst, float(np.abs(ours[0].numpy() - ref).max()))
        host = ttf.apply_plans(torch.from_numpy(host_scale(vol))[None, ..., None], plan)
        exact &= bool(np.array_equal(host[0].numpy(), ref))
    report("host augmentation, 60 volumes: K1 plain + apply_plans", [worst], [0.0])
    print(f"{'  from the host normalize: bit-equal':58s} {exact}")

    with tempfile.TemporaryDirectory() as root:
        csv_path, mri = make_adni_dir(root, n_per_class=6, shape=(20, 24, 20), seed=0)
        recs = TManifest(csv_path, mri, verbose=False).data_dict
        jb = jpipe.VolumeBatcher(recs, jt, batch_size=5, shuffle=True, seed=3, num_threads=2)
        tb = tpipe.VolumeBatcher(recs, batch_size=5, shuffle=True, seed=3, num_threads=2,
                                 transform=tt)
        worst = 0.0
        for _ in range(2):
            for a, b in zip(jb, _device_batches(tb, "cpu", "scale_intensity", 2)):
                assert a["subject"] == b["subject"]
                worst = max(worst, float(np.abs(b["image"].numpy() - a["image"]).max()))
        report("VolumeBatcher + transform, 12 subjects, 2 epochs", [worst], [0.0])

    shape = (19, 23, 27)
    jm = JaxClassifier(num_classes=2, base_ch=4, dtype=jnp.float32)
    v = random_flax_variables(jm, (*shape, 1), seed=0)
    x = np.random.default_rng(1).normal(size=(2, *shape, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    tm = UNet3DClassifier(base_ch=4, compute_dtype=torch.float32).eval()
    tm.load_state_dict(unet3d_classifier_state_dict_from_flax(np_(v)))
    with torch.no_grad():
        report("UNet3DClassifier base 4, 19x23x27, eval logits", tm(torch.from_numpy(x)).numpy(),
               ref)

    narrow = dict(level_channels=(8, 16, 32), bottleneck_channel=64)
    shape = (12, 14, 10)
    ju = JaxUNet3D(dtype=jnp.float32, **narrow)
    v = random_flax_variables(ju, (*shape, 1), seed=3)
    x = np.random.default_rng(2).normal(size=(2, *shape, 1)).astype(np.float32) * 2 + 1
    _, upd = jax.jit(lambda v, x: ju.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    tu = UNet3D(**narrow).train()
    tu.load_state_dict(unet3d_state_dict_from_flax(np_(v)))
    tu(torch.from_numpy(x))
    ref = unet3d_state_dict_from_flax(np_({"params": v["params"],
                                           "batch_stats": upd["batch_stats"]}))
    report("UNet3D train-mode BN running statistics (28 buffers)",
           np.concatenate([tu.state_dict()[k].numpy() for k in ref if ".running_" in k]),
           np.concatenate([ref[k].numpy() for k in ref if ".running_" in k]))

    rel = max(abs(tloop.cosine_decay_schedule(1e-3, n)(k)
                  - float(optax.cosine_decay_schedule(1e-3, n)(jnp.int32(k)))) / 1e-3
              for n in (1, 2, 15) for k in range(31))
    print(f"{'cosine_decay_schedule, 1/2/15 steps, updates 0-30: max |d|/lr':58s} {rel:.3e}")

    # three AdamW steps of the classifier (16^3, B = 4 with a padded row)
    shape = (16, 16, 16)
    jm = JaxClassifier(num_classes=2, base_ch=4, dtype=jnp.float32)
    v = random_flax_variables(jm, (*shape, 1), seed=4)
    tx = jloop.make_optimizer(optax.cosine_decay_schedule(1e-3, 4), 1e-4, 0.0, "adamw")
    js = jloop.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), epoch=jnp.zeros((), jnp.int32),
                          tx=tx, apply_fn=jm.apply)
    tm = UNet3DClassifier(base_ch=4, compute_dtype=torch.float32)
    tm.load_state_dict(unet3d_classifier_state_dict_from_flax(np_(v)))
    ts = tloop.create_train_state(tm, tloop.cosine_decay_schedule(1e-3, 4), 1e-4, 0.0, "adamw")
    step = jloop.make_train_step(2)
    brng = np.random.default_rng(5)
    for i in range(3):
        b = {"image": brng.random((4, *shape, 1)).astype(np.float32),
             "label": np.array([0, 1, 1, 0], np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)}
        js, jl, _ = step(js, {k: jnp.asarray(x) for k, x in b.items()}, jnp.ones(2),
                         jax.random.PRNGKey(0))
        tl, _ = tloop.train_step(ts, {k: torch.from_numpy(x) for k, x in b.items()},
                                 torch.ones(2))
        ref = unet3d_classifier_state_dict_from_flax(
            np_({"params": js.params, "batch_stats": js.batch_stats}))
        d = torch.cat([(tm.state_dict()[k] - x).abs().flatten() for k, x in ref.items()
                       if ".running_" not in k and "num_batches" not in k
                       and not (k.endswith(".bias") and ".conv" in k)])
        print(f"{f'classifier AdamW step {i + 1}: loss rel, params max, share <= 1e-5':58s} "
              f"{abs(float(tl) / float(jl) - 1):.3e}, {float(d.max()):.3e}, "
              f"{float((d <= 1e-5).float().mean()):.5f}")

    # one autoencoder step on the JAX package's own keep mask
    shape = (12, 12, 12)
    ju = JaxUNet3D(dtype=jnp.float32, **narrow)
    v = random_flax_variables(ju, (*shape, 1), seed=9)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(1e-3, 2)))
    js = jloop.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), epoch=jnp.zeros((), jnp.int32),
                          tx=tx, apply_fn=ju.apply)
    b = {"image": np.random.default_rng(6).random((4, *shape, 1)).astype(np.float32),
         "mask": np.array([1, 1, 1, 0], np.float32)}
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.8, b["image"].shape))
    js, jl = jae.make_ae_steps(ju, 0.2)[0](js, {k: jnp.asarray(x) for k, x in b.items()}, key)
    tu = UNet3D(**narrow)
    tu.load_state_dict(unet3d_state_dict_from_flax(np_(v)))
    ts = tloop.create_train_state(tu, tloop.cosine_decay_schedule(1e-3, 2), tae.WEIGHT_DECAY,
                                  1.0, "adamw")
    tl = tae.make_ae_steps(0.2)[0](ts, {k: torch.from_numpy(x) for k, x in b.items()},
                                   keep=torch.from_numpy(keep.copy()))
    ref = unet3d_state_dict_from_flax(np_({"params": js.params, "batch_stats": js.batch_stats}))
    d = torch.cat([(tu.state_dict()[k] - x).abs().flatten() for k, x in ref.items()
                   if ".running_" not in k and "num_batches" not in k
                   and not (k.endswith(".bias") and ".conv" in k)])
    print(f"{'autoencoder step on JAX mask: loss rel, params max, share <= 1e-5':58s} "
          f"{abs(float(tl) / float(jl) - 1):.3e}, {float(d.max()):.3e}, "
          f"{float((d <= 1e-5).float().mean()):.5f}")


def int8_parity():
    """The int8 serving slice: K3's plain version and epilogues, the export,
    the blocks from the JAX package's stem output, whole forwards and
    calibration, the .npz format both ways, quantize_int8 on two folds, the
    folded forward against the eval-mode model, and a trained model's AUC;
    each against the JAX package (tests/test_torch_port_int8.py's inputs)."""
    from multimodal_ad_tpu.models import resnet3d_int8 as jq8
    from multimodal_ad_tpu_torch.models import resnet3d_int8 as tq8
    from multimodal_ad_tpu_torch.ops import int8_conv as k3

    worst = 0
    for ksize, stride, dil in ((3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (3, 2, 2),
                               (1, 1, 1), (1, 2, 1)):
        for c_in in (32, 64):
            r = np.random.default_rng(ksize * 100 + stride * 10 + dil + c_in)
            x = r.integers(-127, 128, (2, 7, 9, 5, c_in), dtype=np.int8)
            w = r.integers(-127, 128, (ksize,) * 3 + (c_in, 24), dtype=np.int8)
            ref = np.asarray(jq8._conv_i8(jnp.asarray(x), jnp.asarray(w), stride, dil, ksize))
            ours = k3.conv_i8(torch.from_numpy(x), k3.relayout_weight(torch.from_numpy(w)),
                              stride, dil).numpy()
            worst = max(worst, int(np.abs(ours.astype(np.int64) - ref).max()))
    print(f"{'K3 plain vs _conv_i8, 14 shapes: max |d| (int32)':58s} {worst}")

    shape = (16, 20, 16)
    for depth, sc, seed in ((10, "B", 21), (10, "A", 22), (50, "B", 23)):
        jm = JaxResNet3D(depth=depth, num_classes=2, shortcut_type=sc, dropout_rate=0.0)
        v = random_flax_variables(jm, (*shape, 1), seed)
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), depth, sc)
        tag = f"depth {depth} {sc}"
        jqp, tqp = jq8.export_int8(v, depth, sc), tq8.export_int8(sd, depth, sc)
        diff = max(float(np.abs(np.asarray(tqp["blocks"][i][n][k], np.float64)
                                - np.asarray(b[n][k], np.float64)).max())
                   for i, b in enumerate(jqp["blocks"])
                   for n in ("conv1", "conv2", "conv3", "down") if isinstance(b.get(n), dict)
                   for k in ("wq", "s", "b", "w_fp"))
        print(f"{'export_int8 ' + tag + ': wq/s/b/w_fp max |d|':58s} {diff:.3e}")
        rr = np.random.default_rng
        cal = rr(seed + 1).normal(size=(2, *shape, 1)).astype(np.float32)
        x = rr(seed + 2).normal(size=(2, *shape, 1)).astype(np.float32)
        jsc = jq8.calibrate_int8(jqp, [cal])
        tsc = tq8.calibrate_int8(tqp, [torch.from_numpy(cal)])
        rel = max(abs(tsc[k] / jsc[k] - 1) for k in jsc)
        print(f"{'calibrate_int8 ' + tag + ': scales max rel':58s} {rel:.3e}")
        stem = np.asarray(jq8._stem_bf16(jqp, jnp.asarray(x)), np.float32)
        jint8 = np.asarray(jq8.resnet3d_int8_apply(jqp, jsc, jnp.asarray(x)), np.float32)
        net = tq8.ResNet3DInt8(tqp, jsc)
        with torch.inference_mode():
            tstem = net.stem(torch.from_numpy(x)).float().numpy()
            h, _ = net.blocks_forward(torch.from_numpy(stem).to(torch.bfloat16))
            from_stem = net.head(h).numpy()
            full = net(torch.from_numpy(x)).numpy()
            folded = net(torch.from_numpy(x), quantized=False).numpy()
        jfold = np.asarray(jq8.resnet3d_folded_apply(jqp, jnp.asarray(x)), np.float32)
        spread = np.abs(jint8).max()
        print(f"{'  s2d bf16 stem output: share of elements that differ':58s} "
              f"{(tstem != stem).mean():.3e}")
        report(f"  int8 logits from the JAX stem output ({tag})", from_stem, jint8)
        print(f"{'  int8 logits from the input: max |d| / spread':58s} "
              f"{np.abs(full - jint8).max() / spread:.3e}")
        print(f"{'  folded logits from the input: max |d| / spread':58s} "
              f"{np.abs(folded - jfold).max() / np.abs(jfold).max():.3e}")

    jm = JaxResNet3D(depth=10, num_classes=2, dropout_rate=0.0)
    fold_vars = [random_flax_variables(jm, (*shape, 1), s) for s in (31, 32)]
    sds = [state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B")
           for v in fold_vars]
    r = np.random.default_rng(33)
    cal = r.normal(100, 30, size=(3, *shape)).astype(np.float32)
    vols = r.normal(100, 30, size=(5, *shape)).astype(np.float32)
    ref = JaxPredictor(jm, fold_vars, batch_size=4).quantize_int8(cal).predict_proba(vols)
    port = EnsemblePredictor(generate_model(model_depth=10), sds, batch_size=4,
                             device="cpu").quantize_int8(cal)
    report("EnsemblePredictor.quantize_int8 (2 folds, 5 vols, bs 4)",
           port.predict_proba(vols), ref)



def densenet_parity():
    """The DenseNet: eval-mode logits in 3-D, 2-D and at odd widths, and one
    train-mode forward's BN statistics (tests/test_torch_port_densenet.py's
    inputs)."""
    from multimodal_ad_tpu.models.densenet import DilatedDenseNet as JaxDenseNet
    from multimodal_ad_tpu_torch.models.densenet import DilatedDenseNet
    from multimodal_ad_tpu_torch.utils.torch_weights import densenet_state_dict_from_flax

    small = dict(growth=4, block_config=(2, 2), dilations=(1, 2), init_features=8)
    cases = {"3d 16^3": (dict(small, spatial_dims=3, in_channels=1), (16, 16, 16, 1)),
             "2d 32^2": (dict(small, spatial_dims=2, in_channels=3, num_classes=3),
                         (32, 32, 3)),
             "odd widths (g 6, init 10)": (dict(growth=6, block_config=(3,), dilations=(1,),
                                                init_features=10, spatial_dims=3,
                                                in_channels=1), (16, 16, 16, 1))}
    for tag, (kw, shape) in cases.items():
        jm = JaxDenseNet(dtype=jnp.float32, **kw)
        v = random_flax_variables(jm, shape, seed=0)
        tm = DilatedDenseNet(compute_dtype=torch.float32, **kw)
        tm.load_state_dict(densenet_state_dict_from_flax(v, kw["block_config"]))
        x = np.random.default_rng(1).normal(size=(2, *shape)).astype(np.float32)
        ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
        with torch.no_grad():
            report(f"DenseNet logits, {tag}", tm.eval()(torch.from_numpy(x)).numpy(), ref)
        if tag.startswith("3d"):
            xb = np.random.default_rng(2).normal(size=(4, *shape)).astype(np.float32)
            _, upd = jm.apply(v, jnp.asarray(xb), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
            tm.train()(torch.from_numpy(xb))
            sd = {k: t.numpy() for k, t in tm.state_dict().items()}
            ours = densenet_state_dict_from_flax({"params": v["params"], **upd},
                                                 kw["block_config"])
            rel = max(float(np.abs(sd[k] / ours[k].numpy() - 1).max())
                      for k in ours if ".running_" in k)
            print(f"{'DenseNet train-mode BN statistics, 3d: max rel':58s} {rel:.3e}")


def encoder_parity():
    """Encoder features (heads none and pool), the stage taps and the seg
    head (float32; bf16 relative to the output's largest magnitude)
    (tests/test_torch_port_encoder.py's inputs)."""
    from multimodal_ad_tpu.eval.features import extract_encoder_features as jax_enc
    from multimodal_ad_tpu_torch.eval.features import extract_encoder_features

    shape = (20, 24, 20)
    with tempfile.TemporaryDirectory() as root:
        csv_path, mri_dir = make_adni_dir(root, n_per_class=6, classes=("AD", "CN"),
                                          shape=shape, seed=0)
        records = ADNIManifest(csv_path, mri_dir, "ADCN", verbose=False).data_dict[:5]
        v = random_flax_variables(JaxResNet3D(depth=10, head="none", dtype=jnp.float32),
                                  (*shape, 1), seed=5)
        for head in ("none", "pool"):
            ref_f, ref_s = jax_enc(records, os.path.join(root, f"jax_{head}"), depth=10,
                                   global_pool=head == "pool", variables=v, batch_size=8,
                                   mesh=make_mesh({"data": -1}), num_threads=2,
                                   input_shape=shape)
            tm = ResNet3D(depth=10, head=head, compute_dtype=torch.float32)
            tm.load_state_dict(state_dict_from_flax(v, 10))
            f, s_path = extract_encoder_features(records, os.path.join(root, f"port_{head}"),
                                                 model=tm, batch_size=8, num_threads=2,
                                                 device="cpu")
            rows_a, rows_b = (list(csv.reader(open(p))) for p in (f, ref_f))
            assert rows_a[0] == rows_b[0] and [r[0] for r in rows_a] == [r[0] for r in rows_b]
            assert open(s_path).read() == open(ref_s).read()
            report(f"adni_features.csv, head {head} (5 subjects)",
                   np.asarray([r[1:-1] for r in rows_a[1:]], float),
                   np.asarray([r[1:-1] for r in rows_b[1:]], float))
    x = np.random.default_rng(1).normal(size=(2, *shape, 1)).astype(np.float32)
    v = random_flax_variables(JaxResNet3D(depth=10, head="seg", num_seg_classes=2,
                                          dtype=jnp.float32), (*shape, 1), seed=4)
    for jdt, tdt, tag in ((jnp.float32, torch.float32, "float32"),
                          (jnp.bfloat16, torch.bfloat16, "bf16")):
        jm = JaxResNet3D(depth=10, head="seg", num_seg_classes=2, dtype=jdt)
        ref, inter = jm.apply(v, jnp.asarray(x), mutable=["intermediates"])
        ref = np.asarray(ref.astype(jnp.float32))
        tm = ResNet3D(depth=10, head="seg", num_seg_classes=2, compute_dtype=tdt).eval()
        tm.load_state_dict(state_dict_from_flax(v, 10, head="seg"))
        with torch.no_grad():
            out, taps = tm(torch.from_numpy(x), return_taps=True)
        out = out.float().numpy()
        report(f"seg head output {tag} (2, 6, 6, 6, 2)", out, ref)
        print(f"{'  max |d| / the output largest magnitude':58s} "
              f"{np.abs(out - ref).max() / np.abs(ref).max():.3e}")
        if tag == "float32":
            for i, (a, b) in enumerate(zip(taps, jax.tree_util.tree_leaves(
                    inter["intermediates"]))):
                report(f"  stage {i + 1} tap {tuple(b.shape)}", a.numpy(), b)


def hypergraph_parity():
    """MSHyper: the incidence matrix, hypergraph_conv with and without
    attention scores, and forwards with and without attention at the
    tests' size and at the JAX defaults (seq 96, pred 24, 7 channels)."""
    from multimodal_ad_tpu.models import hypergraph as jhg
    from multimodal_ad_tpu_torch.models import hypergraph as thg
    from multimodal_ad_tpu_torch.utils.torch_weights import mshyper_state_dict_from_flax

    H = jhg.build_pyramid_incidence(96, (4, 4), 3)
    print(f"{'incidence (96, (4, 4), 3): equal':58s} "
          f"{np.array_equal(H, thg.build_pyramid_incidence(96, (4, 4), 3))}")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H.shape[0], 5)).astype(np.float32)
    sc = rng.uniform(size=(2, *H.shape)).astype(np.float32)
    for tag, scores in (("plain", None), ("attention scores", sc)):
        ref = jhg.hypergraph_conv(jnp.asarray(x), jnp.asarray(H),
                                  None if scores is None else jnp.asarray(scores))
        ours = thg.hypergraph_conv(torch.from_numpy(x), torch.from_numpy(H),
                                   None if scores is None else torch.from_numpy(scores))
        report(f"hypergraph_conv, {tag}", ours.numpy(), ref)
    for seq, pred, ch, d_model, batch in ((16, 4, 3, 8, 2), (96, 24, 7, 64, 4)):
        for att in (False, True):
            kw = dict(seq_len=seq, pred_len=pred, channels=ch, d_model=d_model,
                      use_attention=att)
            jm = jhg.MSHyperModel(**kw)
            xs = (rng.normal(size=(batch, seq, ch)) * 3 + 1).astype(np.float32)
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(xs))
            v = jax.tree_util.tree_map(
                lambda s: (rng.normal(size=s.shape) / np.sqrt(max(int(np.prod(s.shape[:-1])),
                                                                  1))).astype(np.float32),
                shapes)
            tm = thg.MSHyperModel(**kw)
            tm.load_state_dict(mshyper_state_dict_from_flax(v, 2, att))
            with torch.no_grad():
                report(f"MSHyper seq {seq} d_model {d_model} attention {att}",
                       tm(torch.from_numpy(xs)).numpy(), jm.apply(v, jnp.asarray(xs)))



def tabular_parity():
    """The tabular slice: the msgpack reader against flax on the three
    assets, the table loaders, the sklearn replacements against sklearn,
    the networks (tiny config on random weights; the full-width classifier
    asset on a 64-row bucket), ICLClassifier per preprocess (probabilities
    and every embedding kind), ICLRegressor, and tabel_encoder_multi's CSVs
    against the JAX package, on the tests' seeded inputs."""
    import warnings

    from flax import serialization
    from sklearn import feature_selection as skfs
    from sklearn import preprocessing as skpre

    from multimodal_ad_tpu.data import tabular as jtab
    from multimodal_ad_tpu.data.synthetic import make_table as jax_make_table
    from multimodal_ad_tpu.tabular import icl as jicl
    from multimodal_ad_tpu.tabular import pipeline as jpipe
    from multimodal_ad_tpu.tabular.regression import ICLRegressor as JaxRegressor
    from multimodal_ad_tpu_torch.data import tabular as ttab
    from multimodal_ad_tpu_torch.tabular import estimator as est
    from multimodal_ad_tpu_torch.tabular import icl as ticl
    from multimodal_ad_tpu_torch.tabular import pipeline as tpipe
    from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state, tree_leaves
    from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor
    from multimodal_ad_tpu_torch.utils.torch_weights import icl_state_dict_from_flax

    warnings.simplefilter("ignore")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("icl_default", "icl_embedder", "icl_regression_default"):
        path = os.path.join(root, "multimodal_ad_tpu_torch", "assets", f"{name}.msgpack")
        with open(path, "rb") as f:
            ref = tree_leaves(serialization.msgpack_restore(f.read()))
        ours = tree_leaves(read_state(path))
        same = all(p == q and a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for (p, a), (q, b) in zip(ours, ref)) and len(ours) == len(ref)
        print(f"{'msgpack reader vs flax, ' + name + ': bit-equal':58s} {same}")
    with tempfile.TemporaryDirectory() as d:
        df = jax_make_table(n=70, classes=("CN", "MCI", "AD", "SMCI", "PMCI"), seed=5)
        rng = np.random.default_rng(5)
        df.loc[rng.random(70) < 0.2, "feat3"] = np.nan
        df.loc[rng.random(70) < 0.3, "cat1"] = None
        df.to_csv(os.path.join(d, "t.csv"), index=False)
        a = jtab.load_adni_data_quadclass(os.path.join(d, "t.csv"), 14)
        b = ttab.load_adni_data_quadclass(os.path.join(d, "t.csv"), 14)
        print(f"{'quadclass loader vs pandas loader: X and y equal':58s} "
              f"{np.array_equal(a[0], b[0], equal_nan=True) and np.array_equal(a[1], b[1])}")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(90, 7)).astype(np.float32)
    X[:, 3] = rng.integers(0, 3, 90)
    y = rng.integers(0, 3, 90)
    report("f_classif vs sklearn (90 x 7, float32, ties)", est.f_classif(X, y)[0],
           skfs.f_classif(X, y)[0])
    yr = X[:, 0] * 2.0 + rng.normal(size=90)
    report("f_regression vs sklearn", est.f_regression(X, yr)[0], skfs.f_regression(X, yr)[0])
    for n in (12, 90):
        kw = dict(n_quantiles=min(64, n), output_distribution="normal", random_state=0)
        report(f"QuantileTransformer vs sklearn (n {n})",
               est.QuantileTransformer(**kw).fit(X[:n]).transform(X),
               skpre.QuantileTransformer(**kw).fit(X[:n]).transform(X))

    cfg = ticl.ICLConfig()
    tree = read_state(ticl.default_asset_path())
    params = jicl._load_params_file(jicl.ICLConfig(), jicl.default_asset_path())
    tm = ticl.ICLTransformer(cfg).eval()
    tm.load_state_dict(icl_state_dict_from_flax(tree, cfg))
    rng = np.random.default_rng(2)
    x_ctx = np.zeros((2, 64, 192), np.float32)
    x_ctx[:, :50, :30] = rng.normal(size=(2, 50, 30))
    y_ctx = rng.integers(0, 4, (2, 64)).astype(np.int32)
    mask = np.zeros((2, 64), np.float32)
    mask[:, :50] = 1
    x_qry = np.zeros((2, 16, 192), np.float32)
    x_qry[:, :, :30] = rng.normal(size=(2, 16, 30))
    cat = np.zeros((2, 192), np.float32)
    cat[:, [2, 5]] = 1
    xc, xq = jicl._zscore_by_ctx(x_ctx, x_qry, mask)
    (lo, q, c), inter = jicl.ICLTransformer(jicl.ICLConfig()).apply(
        params, xc, y_ctx, mask, xq, cat, mutable=["intermediates"])
    with torch.no_grad():
        txc, txq = ticl._zscore_by_ctx(torch.from_numpy(x_ctx), torch.from_numpy(x_qry),
                                       torch.from_numpy(mask))
        out = tm(txc, torch.from_numpy(y_ctx), torch.from_numpy(mask), txq,
                 torch.from_numpy(cat), return_penult=True)
    for name, a, b in zip(("logits", "qry_emb", "ctx_emb", "h_penult"), out,
                          (lo, q, c, inter["intermediates"]["h_penult"][0])):
        report(f"full-width classifier asset, 64-row bucket: {name}", a.numpy(), b)

    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 12)).astype(np.float32)
    y = rng.integers(0, 3, 80)
    X[:, 0] += y
    X[:, 1] = rng.integers(0, 3, 80)
    X[:, 2] = X[:, 3] * X[:, 4] + 0.5 * y
    X[:60][rng.random((60, 12)) < 0.05] = np.nan
    X, y, Xt = X[:60], y[:60], X[60:]
    for pp in (None, "whiten", "quantile", "pairs", "onehot", "auto"):
        j = jicl.ICLClassifier(preprocess=pp).fit(X, y)
        t = ticl.ICLClassifier(preprocess=pp, device="cpu").fit(X, y)
        report(f"ICLClassifier({pp!r}) predict_proba [{t.preprocess_} / {j.preprocess_}]",
               t.predict_proba(Xt), j.predict_proba(Xt))
        for kind in ("rich", "rich2", "compact", "hidden"):
            j.embedding_kind = t.embedding_kind = kind
            report(f"ICLClassifier({pp!r}) get_embeddings {kind}", t.get_embeddings(Xt),
                   j.get_embeddings(Xt))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(75, 8)).astype(np.float32)
    yr = 2.0 * X[:, 0] - X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=75)
    j = JaxRegressor().fit(X[:60], yr[:60])
    t = ICLRegressor(device="cpu").fit(X[:60], yr[:60])
    spread = float(yr[:60].max() - yr[:60].min())
    for kind in ("mean", "median"):
        d = np.abs(t.predict(X[60:], kind) - j.predict(X[60:], kind)).max()
        print(f"{'ICLRegressor() ' + kind + ' / target spread':58s} max|d| {d / spread:.3e}")
    d = max(np.abs(a - b).max() for a, b in zip(t.predict(X[60:], "quantiles"),
                                                j.predict(X[60:], "quantiles")))
    print(f"{'ICLRegressor() quantiles / target spread':58s} max|d| {d / spread:.3e}")
    with tempfile.TemporaryDirectory() as d:
        jax_make_table(n=80, n_features=14, classes=("CN", "SMCI", "PMCI", "AD"), seed=7,
                       n_categorical=2).to_csv(os.path.join(d, "t.csv"), index=False)
        kw = dict(start_col=14, label_col="Group", classes=["CN", "SMCI", "PMCI", "AD"],
                  n_fold=3, test_size=0.25)
        jpipe.tabel_encoder_multi(os.path.join(d, "t.csv"), train_out=d + "/j_tr.csv",
                                  test_out=d + "/j_te.csv", **kw)
        tpipe.tabel_encoder_multi(os.path.join(d, "t.csv"), train_out=d + "/t_tr.csv",
                                  test_out=d + "/t_te.csv", device="cpu", **kw)
        for part in ("tr", "te"):
            a = np.loadtxt(f"{d}/t_{part}.csv", delimiter=",", skiprows=1,
                           usecols=range(1, 1777))
            b = np.loadtxt(f"{d}/j_{part}.csv", delimiter=",", skiprows=1,
                           usecols=range(1, 1777))
            report(f"tabel_encoder_multi, ensemble embedder: {part} CSV", a, b)


if __name__ == "__main__":
    main()
