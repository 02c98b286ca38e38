"""Nothing the benchmark loads is JAX, a JAX library or the JAX package:
each loaded module's top-level name compared whole (the port's own name
begins with the JAX package's). The probe loads every module of the
harness, every reader and every model family, and builds each family's
program model."""

import subprocess
import sys

from portbench_tiny import ROOT

PROBE = r"""
import importlib, json, pathlib, sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import portbench.run as run
for mod in ("portbench.lib.serve", "portbench.lib.train", "portbench.lib.trace",
            "portbench.lib.work", "portbench.lib.check", "portbench.lib.traffic",
            "portbench.lib.inputs", "portbench.lib.family", "portbench.reference.resnet3d",
            "portbench.reference.int8", "portbench.reference.train",
            "portbench.reference.data", "portbench.reference.lowp", "portbench.calibrate"):
    importlib.import_module(mod)
for path in sorted(pathlib.Path({root!r}, "portbench", "metrics").glob("*.py")):
    run.reader(path.stem)
from portbench.lib import family, serve, train
serve._program(); train._program()
configs = [json.loads(p.read_text())
           for p in sorted(pathlib.Path({root!r}, "portbench", "configs").glob("*.json"))]
for path in sorted(pathlib.Path({root!r}, "portbench", "families").glob("*.py")):
    fam = family.load(path.stem)
    for cfg in configs:
        if cfg["model_type"] == path.stem:  # the port's model, through the family
            fam.program_model({{**cfg, "input_shape": [8, 8, 8]}}, "cpu")
            break
print("found=" + ",".join(run.forbidden_modules()))
"""


def test_no_jax_in_what_a_run_loads():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "found="


def test_the_check_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    import portbench.run as run
    saved = dict(sys.modules)
    try:
        sys.modules["multimodal_ad_tpu_torch_probe.serve"] = sys
        assert "multimodal_ad_tpu" not in run.forbidden_modules()
        sys.modules["multimodal_ad_tpu.core"] = sys
        sys.modules["jax.numpy"] = sys
        assert {"jax", "multimodal_ad_tpu"} <= set(run.forbidden_modules())
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
