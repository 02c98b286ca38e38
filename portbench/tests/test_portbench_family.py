"""A model family other than the ResNet runs through the harness as new
files alone: the toy family in `families/toy_cnn.py` beside this file (a
plain 3-D CNN with no BatchNorm) is found by its configuration's
`model_type`, served in bf16 through the port's `EnsemblePredictor` and
trained through `create_train_state` / `cv._run_epoch`, both judged by
the cells' own limits, on the CPU at a small size. And no generic file of
the harness knows the ResNet."""

import re
from pathlib import Path

import pytest
import torch

import portbench_tiny
from portbench import run
from portbench.lib import family

pytestmark = pytest.mark.filterwarnings("ignore")

TOY_FAMILIES = Path(__file__).resolve().parent / "families"
RESNET_KEYS = ("model_depth", "resnet_shortcut", "s2d_stem", "param_dtype", "widths")
SEED = 2 ** 31 + 211


@pytest.fixture
def toy(monkeypatch):
    """The toy family's configuration, its directory the lookup's root."""
    monkeypatch.setattr(family, "FAMILIES", TOY_FAMILIES)
    cfg = portbench_tiny.config("resnet18_adni", model_type="toy_cnn", width=8)
    return {k: v for k, v in cfg.items() if k not in RESNET_KEYS}


def _run(cell_name, cfg):
    cell = portbench_tiny.cell(cell_name)
    mix = portbench_tiny.mix(cell["traffic"])
    return run.run_cell(portbench_tiny.manifest(), cell, SEED, 1.5, False, "cpu", cfg=cfg,
                        mix=mix)


def _perturb_one_weight(monkeypatch):
    """Every copy of the program's toy model gets one weight moved after its
    weights are loaded, the first class's bias by 0.25; the reference's
    are untouched."""
    toy_cnn = family.load("toy_cnn")
    orig = toy_cnn.ToyCNN.load_state_dict

    def load(self, sd, *args, **kw):
        out = orig(self, sd, *args, **kw)
        with torch.no_grad():
            self.fc.bias[0] += 0.25
        return out

    monkeypatch.setattr(toy_cnn.ToyCNN, "load_state_dict", load)


@pytest.mark.parametrize("cell", ["r18_serve_bf16", "r50_train"])
def test_the_toy_family_runs_correct(toy, cell):
    out, checks = _run(cell, toy)
    assert out["correct"] and out["attempted"] > 0, checks
    assert family.of(toy).describe(toy)["type"] == "toy_cnn"


@pytest.mark.parametrize("cell", ["r18_serve_bf16", "r50_train"])
def test_the_toy_family_with_one_weight_moved_is_not_correct(toy, cell, monkeypatch):
    _perturb_one_weight(monkeypatch)
    out, checks = _run(cell, toy)
    assert out["attempted"] > 0 and not out["correct"], checks


def test_a_precision_the_family_lacks_is_refused_by_name(toy):
    with pytest.raises(ValueError, match=r"'toy_cnn' serves bf16, not 'int8'"):
        _run("r18_serve_int8", toy)


def test_an_unknown_family_is_refused_by_name(toy):
    with pytest.raises(ValueError, match="no model family 'mamba3d'"):
        _run("r18_serve_bf16", {**toy, "model_type": "mamba3d"})


GENERIC = ["run.py", "calibrate.py", "reference/train.py", "reference/data.py"]
GENERIC += [f"lib/{p.name}" for p in sorted((portbench_tiny.ROOT / "portbench" / "lib").glob(
    "*.py"))]
GENERIC += [f"metrics/{p.name}" for p in sorted(
    (portbench_tiny.ROOT / "portbench" / "metrics").glob("*.py")) if p.stem != "k3_roofline"]


@pytest.mark.parametrize("path", GENERIC)
def test_only_the_family_file_knows_the_resnet(path):
    """Only `families/resnet.py` (and `metrics/k3_roofline.py`, which reads
    the int8 ResNet's K3 launches) names a depth or the ResNet reference."""
    text = (portbench_tiny.ROOT / "portbench" / path).read_text()
    found = re.findall(r'model_depth|reference\.resnet3d|"resnet"|ref\.forward', text)
    assert not found, (path, found)
