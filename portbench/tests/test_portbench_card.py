"""On the card: one short run of each kind through the benchmark's own
command. Skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from portbench_tiny import ROOT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [("r18_serve_bf16", 0), ("r50_train", 1)])
def test_a_short_run_is_correct_and_names_the_card(cuda, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(cuda)
    assert list(result)[-1] == "checks"
    if trace:
        assert result["device"]["busy_s"] > 0 and "breakdown" in result
