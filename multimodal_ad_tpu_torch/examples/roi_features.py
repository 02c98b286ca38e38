"""Example: atlas ROI feature extraction (features.csv + roi_features.csv).

Run:  python -m multimodal_ad_tpu_torch.examples.roi_features [--device cpu]
"""

import os
import tempfile

import numpy as np
import torch

from ..data.adni import ADNIManifest
from ..data.synthetic import make_adni_dir, make_atlas
from ..eval.features import extract_unet_features
from ..models.unet3d import UNet3D
from ..utils import nifti
from . import device_arg


def main(device="cuda"):
    root = tempfile.mkdtemp(prefix="roi_example_")
    label_csv, mri_dir = make_adni_dir(root, n_per_class=3, classes=("AD", "CN"),
                                       shape=(24, 28, 24), seed=1)
    atlas = make_atlas((24, 28, 24), n_rois=8, seed=0)
    nifti.save(os.path.join(root, "atlas.nii"), atlas.astype(np.int16))

    records = ADNIManifest(label_csv, mri_dir, "ADCN", verbose=False).data_dict
    model = UNet3D(level_channels=(8, 16, 32), bottleneck_channel=64,
                   compute_dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    fpath, rpath = extract_unet_features(
        records, atlas, [f"Region{i}" for i in range(1, 9)],
        os.path.join(root, "out"), model=model, batch_size=8, num_threads=2,
        device=device)
    print("voxel CSV:", fpath)
    print("ROI   CSV:", rpath)
    return rpath


if __name__ == "__main__":
    main(device_arg(__doc__))
