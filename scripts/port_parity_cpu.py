"""Measure the port's parity errors against the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_parity_cpu.py

Runs the comparisons of tests/test_torch_port_*.py on the same seeded
inputs and prints the largest absolute difference of each, one line per
comparison, so PERF.md can quote measured errors rather than the tests'
bounds. Needs both jax and torch; runs in about a minute.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

from multimodal_ad_tpu.data.transforms import scale_intensity as host_scale  # noqa: E402
from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D  # noqa: E402
from multimodal_ad_tpu.models.resnet3d import generate_model as jgen  # noqa: E402
from multimodal_ad_tpu.ops import fused_gather as jfg  # noqa: E402
from multimodal_ad_tpu.ops import normalize as jnorm  # noqa: E402
from multimodal_ad_tpu.serve import EnsemblePredictor as JaxPredictor  # noqa: E402
from multimodal_ad_tpu_torch.data.synthetic import make_volume  # noqa: E402
from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D, generate_model  # noqa: E402
from multimodal_ad_tpu_torch.ops import fused_gather as tfg  # noqa: E402
from multimodal_ad_tpu_torch.ops import normalize as tnorm  # noqa: E402
from multimodal_ad_tpu_torch.serve import EnsemblePredictor  # noqa: E402
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax  # noqa: E402


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


if __name__ == "__main__":
    main()
