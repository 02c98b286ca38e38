"""Port parity on the CPU: the dilated DenseNet and its CV trainer.

The JAX DilatedDenseNet (float32) gets seeded numpy variables with
randomized BatchNorm statistics; `densenet_state_dict_from_flax` carries
them into the port's model. Eval-mode logits match within atol 1e-4 in
3-D and 2-D (growth 4, blocks (2, 2), 16^3 / 32^2) and in the odd-width
case of tests/test_densenet.py; one train-mode forward updates the
running statistics as flax does (biased variance, momentum 0.9; rtol
1e-5). `cli.train_densenet --device cpu` trains end to end and writes the
19-column cv_results.csv; `train_cv`'s factory-built models start each
fold from weights that depend on seed + fold alone, while the default
ResNet route keeps its draws."""

import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models.densenet import DilatedDenseNet as JaxDenseNet
from multimodal_ad_tpu_torch.core.config import Config
from multimodal_ad_tpu_torch.models.densenet import (DilatedDenseNet, densenet_2d,
                                                     densenet_3d)
from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.train.cv import _make_model
from multimodal_ad_tpu_torch.utils.torch_weights import (densenet_name_map,
                                                         densenet_state_dict_from_flax)
from test_torch_port_models import random_flax_variables
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SMALL = dict(growth=4, block_config=(2, 2), dilations=(1, 2), init_features=8)
CASES = {
    "3d": (dict(SMALL, spatial_dims=3, in_channels=1), (16, 16, 16, 1)),
    "2d": (dict(SMALL, spatial_dims=2, in_channels=3, num_classes=3), (32, 32, 3)),
    "odd_inplanes": (dict(growth=6, block_config=(3,), dilations=(1,), init_features=10,
                          spatial_dims=3, in_channels=1), (16, 16, 16, 1)),
}


def _pair(case, seed=0):
    kw, shape = CASES[case]
    jm = JaxDenseNet(dtype=jnp.float32, **kw)
    variables = random_flax_variables(jm, shape, seed=seed)
    tm = DilatedDenseNet(compute_dtype=torch.float32, **kw)
    tm.load_state_dict(densenet_state_dict_from_flax(variables, kw["block_config"]))
    return jm, variables, tm, shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jm, variables, tm, shape = _pair(case)
    x = np.random.default_rng(1).normal(size=(2, *shape)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_train_mode_batch_stats_match_jax():
    jm, variables, tm, shape = _pair("3d", seed=3)
    x = np.random.default_rng(2).normal(size=(4, *shape)).astype(np.float32)
    ref, updated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
    tm.train()(torch.from_numpy(x))
    ours = tm.state_dict()
    rows = [r for r in densenet_name_map(SMALL["block_config"]) if r[1] == "batch_stats"]
    assert len(rows) == 2 * (2 + 2 * 4 + 1)  # stem, 4 layers x 2, transition, final
    for tname, _, fpath, _ in rows:
        want = updated["batch_stats"]
        for p in fpath:
            want = want[p]
        np.testing.assert_allclose(ours[tname].numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=tname)


def test_bf16_autocast_close_to_fp32_and_factories():
    torch.manual_seed(0)
    m32 = densenet_3d(compute_dtype=torch.float32, **SMALL).eval()
    m16 = densenet_3d(compute_dtype=torch.bfloat16, **SMALL).eval()
    m16.load_state_dict(m32.state_dict())
    x = torch.rand(2, 16, 16, 16, 1)
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05, atol=0.05)
    assert densenet_2d().in_channels == 3 and densenet_2d().spatial_dims == 2
    with pytest.raises(ValueError, match="channels"):
        m32(torch.rand(1, 16, 16, 16, 2))
    with pytest.raises(ValueError):
        DilatedDenseNet(spatial_dims=1)


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    """As on the card's machine: no tensorboard (the logger writes the CSV
    only) and no matplotlib (no ROC plot)."""
    from multimodal_ad_tpu_torch.cli.train_densenet import main
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir

    for name in ("tensorboard", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)

    csv_path, mri = make_adni_dir(str(tmp_path), n_per_class=5, shape=(12, 12, 12))
    ckpt = tmp_path / "ckpt"
    results = main([f"label_file={csv_path}", f"mri_dir={mri}", "num_epochs=1",
                    "batch_size=4", "n_splits=2", "compute_dtype=float32",
                    "loader_threads=2", "hbm_cache=true", "augment=true",
                    f"checkpoint_dir={ckpt}", "--device", "cpu", "--growth", "4",
                    "--blocks", "2", "2"])
    with open(ckpt / "cv_results.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 1 + 2 and all(len(r) == 19 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    for k in (1, 2):
        assert (ckpt / f"best_fold{k}" / "model.pt").is_file()
        assert (ckpt / f"model_fold{k}_final" / "model.pt").is_file()
    assert set(results["avg"]) >= {"ACC", "AUC", "MCC"}
    from multimodal_ad_tpu_torch.train import checkpoint

    weights, _ = checkpoint.restore_state(str(ckpt / "best_fold1"))
    assert "block1.1.conv2.weight" in weights  # a DenseNet checkpoint


def test_factory_models_depend_on_the_fold_seed_alone():
    """Two runs with one seed start each fold from the same weights, whatever
    the global RNG did before; other seeds give other weights; the global
    stream is left as it was. The default ResNet route keeps its draws."""
    cfg = Config(seed=7, model_depth=10)

    def factory():
        return DilatedDenseNet(compute_dtype=torch.float32, **SMALL)

    torch.manual_seed(123)
    a = _make_model(cfg, factory, cfg.seed + 1).state_dict()
    torch.rand(1000)  # the global stream moves on between runs
    state = torch.random.get_rng_state()
    b = _make_model(cfg, factory, cfg.seed + 1).state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    c = _make_model(cfg, factory, cfg.seed + 2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0.weight"], c["conv0.weight"])

    ours = _make_model(cfg, None, 5).state_dict()
    ref = generate_model(model_depth=10, generator=torch.Generator().manual_seed(5)
                         ).state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
