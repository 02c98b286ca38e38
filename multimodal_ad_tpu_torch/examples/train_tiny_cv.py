"""Example: end-to-end K-fold CV training on a synthetic miniature ADNI set.

Run:  python -m multimodal_ad_tpu_torch.examples.train_tiny_cv [--device cpu]
"""

import os
import tempfile

from ..core.config import Config
from ..data.synthetic import make_adni_dir
from ..train.cv import train_cv
from . import device_arg


def main(device="cuda"):
    root = tempfile.mkdtemp(prefix="adni_example_")
    label_csv, mri_dir = make_adni_dir(root, n_per_class=6, classes=("AD", "CN"),
                                       shape=(24, 28, 24), seed=0)
    cfg = Config(label_file=label_csv, mri_dir=mri_dir, task="ADCN",
                 num_epochs=2, batch_size=8, lr=1e-3, n_splits=2,
                 model_depth=10, checkpoint_dir=os.path.join(root, "ckpt"),
                 loader_threads=2)
    results, ckpt_dir = train_cv(cfg, device=device)
    print("\ntest ACC:", round(results["avg"]["ACC"], 4),
          "AUC:", round(results["avg"]["AUC"], 4))
    print("checkpoints:", ckpt_dir)
    return results


if __name__ == "__main__":
    main(device_arg(__doc__))
