"""Time the first and later train steps of the two full-width U-Net trainers
with cuDNN benchmarking off and on, on one NVIDIA GPU.

    python3 scripts/unet_train_cudnn_modes.py

The U-Net classifier (`UNet3DClassifier`, base 32, AdamW, no clip) and the
denoising autoencoder (`UNet3D` 64/128/256/512, clip 1.0 + AdamW), both in
bf16 autocast over fp32 parameters, a batch of 8 random volumes of
91x109x91 in [0, 1], a constant rate of 1e-3, as
`train/single_split.py` and `train/autoencoder.py` step them. Each
(trainer, mode) runs in a process of its own (PyTorch caches the chosen
algorithms per process): 7 steps, each synchronized. Prints the card's name
and power limit first, then one line a run: the first step's wall time
(algorithm selection included), the median of the last 6, the peak memory
and the losses. Takes about three minutes.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("cls", False), ("ae", False), ("cls", True), ("ae", True))


def measure(kind: str, benchmark: bool) -> None:
    """One run, in this process: prints one JSON line."""
    sys.path.insert(0, ROOT)
    import torch

    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models.unet3d import UNet3D, UNet3DClassifier
    from multimodal_ad_tpu_torch.train import autoencoder, loop

    dev = resolve_device("cuda")  # raises without a card; TF32 off
    torch.backends.cudnn.benchmark = benchmark
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((8, 91, 109, 91, 1), device=dev, generator=gen)
    batch = {"image": image, "label": torch.tensor([0, 1] * 4, device=dev),
             "mask": torch.ones(8, device=dev)}
    if kind == "cls":
        model = UNet3DClassifier(generator=torch.Generator().manual_seed(0)).to(dev)
        state = loop.create_train_state(model, lambda _: 1e-3, 1e-4, grad_clip_norm=0.0,
                                        optimizer="adamw")
        ones = torch.ones(2, device=dev)

        def step():
            return loop.train_step(state, batch, ones)[0]
    else:
        model = UNet3D(compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        state = loop.create_train_state(model, lambda _: 1e-3, autoencoder.WEIGHT_DECAY,
                                        grad_clip_norm=1.0, optimizer="adamw")
        ae_step, _ = autoencoder.make_ae_steps(0.2, gen)

        def step():
            return ae_step(state, batch)

    walls, losses = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(step()))
        walls.append(time.time() - t0)
    print(json.dumps({"kind": kind, "benchmark": "on" if benchmark else "off",
                      "first_s": walls[0], "median_s": statistics.median(walls[1:]),
                      "walls": walls, "losses": losses,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def main() -> int:
    if len(sys.argv) == 3:
        measure(sys.argv[1], sys.argv[2] == "1")
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    for kind, benchmark in RUNS:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), kind,
                              str(int(benchmark))], capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
