"""Host volume decode (the `load_volume` part of the TPU package's
data/pipeline.py).

The pure-Python NIfTI reader only: the native C++ decoder and the threaded
batcher come with the host data-layer slice.
"""

from __future__ import annotations

import numpy as np

from ..utils import nifti


def load_volume(path: str) -> np.ndarray:
    """Decode one NIfTI volume as float32 [x, y, z]; accepts the path with
    or without a trailing '.gz'."""
    return nifti.load(nifti.exists_with_ext(path) or path)
