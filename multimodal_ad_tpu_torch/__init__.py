"""multimodal_ad_tpu_torch — the PyTorch/CUDA port of the TPU package.

The port runs on one NVIDIA H100 (Hopper, sm_90a). It mirrors the TPU
package's module names so each counterpart is easy to find, keeps its
channels-last (B, X, Y, Z, C) layout at public functions, and imports
nothing of that package or of its framework.

Every Pallas kernel on a ported path becomes a hand-written CUDA kernel
under `csrc/`, built with nvcc at first use (ops/_build.py) and bound with
ctypes. Each kernel keeps a plain PyTorch version beside it: the wrapper
takes that version only for tensors that lie on the CPU.

Entry points default to ``device="cuda"`` and raise when no card is
present (core/device.py); tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
