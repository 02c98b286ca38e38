"""Data layer exports (the TPU package's data/__init__.py surface; the
normalizers `adaptive_normal` and `scale_intensity` live in
ops/normalize.py here, where K1 runs them)."""

from ..ops.normalize import adaptive_normal, scale_intensity
from .adni import TASK_GROUPS, ADNIManifest
from .device_cache import DeviceDataset, DeviceEpochIterator, build_device_dataset
from .pipeline import VolumeBatcher, device_prefetch, load_volume
from .splits import stratified_kfold, stratified_test_split
from .tabular import (load_adni_data_binary, load_adni_data_quadclass,
                      load_adni_data_triclass, load_adni_table)
from .transforms import VolumeTransform, make_transforms

__all__ = [
    "ADNIManifest", "TASK_GROUPS", "VolumeBatcher", "device_prefetch",
    "load_volume", "DeviceDataset", "DeviceEpochIterator",
    "build_device_dataset", "stratified_kfold", "stratified_test_split",
    "load_adni_data_binary", "load_adni_data_triclass",
    "load_adni_data_quadclass", "load_adni_table", "VolumeTransform",
    "adaptive_normal", "scale_intensity", "make_transforms",
]
