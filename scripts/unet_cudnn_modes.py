"""Time the full-width UNet3D forward of the extraction path under cuDNN's
algorithm-selection modes, on one NVIDIA GPU.

    python3 scripts/unet_cudnn_modes.py

UNet3D (64/128/256, bottleneck 512), float32 with TF32 off, a batch of 8
volumes of 91x109x91, as `eval/features.py::extract_unet_features` runs
it. Each mode runs in a process of its own (PyTorch caches the chosen
algorithms per process, whatever chose them): the path's mode (heuristics,
deterministic algorithms) twice, heuristics without deterministic
algorithms, and benchmarking with and without them. For each it prints
the first call's wall time (algorithm selection included), the median of
three more forwards, the peak memory, and whether the pre-head tap's bytes
equal those of the first process. Prints the card's name and power limit
first. Takes a few minutes.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ((False, True), (False, True), (False, False), (True, True), (True, False))


def measure(benchmark: bool, deterministic: bool) -> None:
    """One mode, in this process: prints one line ending in the tap's hash."""
    sys.path.insert(0, ROOT)
    import torch

    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models.unet3d import UNet3D

    dev = resolve_device("cuda")  # raises without a card; TF32 off
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.deterministic = deterministic
    model = UNet3D(generator=torch.Generator().manual_seed(0)).eval().to(dev)
    x = torch.rand((8, 91, 109, 91, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    times = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.time()
            _, tap = model(x, return_features=True)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        digest = hashlib.sha256(tap.contiguous().cpu().numpy().tobytes()).hexdigest()
    print(f"benchmark={benchmark} deterministic={deterministic}: first call "
          f"{times[0]:.2f} s, then {statistics.median(times[1:]) * 1e3:.1f} ms "
          f"(median of 3), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"tap {digest}", flush=True)


def main() -> int:
    if len(sys.argv) == 3:
        measure(sys.argv[1] == "1", sys.argv[2] == "1")
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    first = None
    for benchmark, deterministic in MODES:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              str(int(benchmark)), str(int(deterministic))],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        body, digest = line.rsplit(" tap ", 1)
        first = first or digest
        print(f"{body}, tap bytes equal to the first process's: {digest == first}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
