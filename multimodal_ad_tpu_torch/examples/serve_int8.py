"""Example: train a tiny fold ensemble, serve it, quantize to int8, and
persist/reload the quantized artifact (SERVING.md tells the deployment
story; the int8 block convolutions run K3 on the card).

Run:  python -m multimodal_ad_tpu_torch.examples.serve_int8 [--device cpu]
"""

import os
import tempfile

import numpy as np
import torch

from ..core.config import Config
from ..data.synthetic import make_adni_dir, make_volume
from ..models.resnet3d_int8 import (calibrate_int8, export_int8, load_int8,
                                    resnet3d_int8_apply, save_int8)
from ..serve import EnsemblePredictor
from ..train.cv import train_cv
from . import device_arg

SHAPE = (16, 20, 16)


def main(device="cuda"):
    root = tempfile.mkdtemp(prefix="serve_int8_example_")
    label_csv, mri_dir = make_adni_dir(root, n_per_class=6, classes=("AD", "CN"),
                                       shape=SHAPE, seed=0)
    cfg = Config(label_file=label_csv, mri_dir=mri_dir, task="ADCN",
                 num_epochs=2, batch_size=8, lr=1e-3, n_splits=2,
                 model_depth=10, checkpoint_dir=os.path.join(root, "ckpt"),
                 compute_dtype="float32", loader_threads=2,
                 input_W=SHAPE[0], input_H=SHAPE[1], input_D=SHAPE[2])
    train_cv(cfg, device=device)

    rng = np.random.default_rng(0)
    volumes = np.stack([make_volume(rng, SHAPE, label=i % 2) for i in range(6)])

    pred = EnsemblePredictor.from_checkpoint_dir(cfg.checkpoint_dir, batch_size=8,
                                                 device=device)
    bf16 = pred.predict_proba(volumes)
    pred.quantize_int8(volumes[:2])  # calibrate on representative volumes
    q8 = pred.predict_proba(volumes)
    agree = float((q8.argmax(1) == bf16.argmax(1)).mean())
    print(f"bf16 vs int8 argmax agreement: {agree:.2f}")

    # persist ONE fold's quantized graph and reload it standalone
    qp = export_int8(pred.folds[0].state_dict(), depth=cfg.model_depth)

    def prep(v):  # the predictor's preprocessing of a chunk (K1 on the card)
        return pred._prep(torch.from_numpy(np.ascontiguousarray(v)).to(pred.device), True)

    scales = calibrate_int8(qp, [prep(volumes[:2])])
    path = save_int8(os.path.join(root, "fold0_int8.npz"), qp, scales)
    qp2, scales2 = load_int8(path)
    logits = resnet3d_int8_apply(qp2, scales2, prep(volumes))[:len(volumes)]
    print(f"reloaded artifact ({os.path.getsize(path) / 1e6:.1f} MB) "
          f"logits shape: {tuple(logits.shape)}")
    return {"agreement": agree, "artifact": path}


if __name__ == "__main__":
    main(device_arg(__doc__))
