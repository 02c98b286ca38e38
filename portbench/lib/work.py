"""The yardstick: published peaks of the card, and the operations and bytes
the kernels need, counted from shapes; each model family
(`portbench/families/`) counts its network's operations with these.

Peaks are NVIDIA's H100 SXM data sheet, dense: bf16 989 TFLOP/s, int8
1,979 TOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM 3.35 TB/s.

Convolution work counts only the (output voxel, tap) pairs whose tap lands
inside the volume (a tap in the zero padding multiplies nothing), as
`k3_work` below, copied from chip_smoke.py, does."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
PEAKS = {"bf16": BF16_OPS_PER_S, "int8": INT8_OPS_PER_S, "f32": F32_OPS_PER_S}
K1_OPS_PER_VOXEL = 4  # min, max, subtract, multiply


def out_size(n: int, k: int, stride: int, dil: int) -> int:
    pad = dil * (k - 1) // 2
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def k3_work(batch, grid, c_in, c_out, ksize, stride, dil):
    """(operations, input bytes) the convolution needs: 2 C_in C_out per
    (output voxel, tap) pair whose tap lands inside the volume (taps in the
    padding multiply zeros), and the input voxels some tap reads (a strided
    1^3 conv reads one in stride^3). Copied from chip_smoke.py."""
    pad = dil * (ksize - 1) // 2
    pairs, read = 1, 1
    for s in grid:
        n_out = (s + 2 * pad - dil * (ksize - 1) - 1) // stride + 1
        pos = [o * stride - pad + t * dil for o in range(n_out) for t in range(ksize)]
        inside = [q for q in pos if 0 <= q < s]
        pairs *= len(inside)
        read *= len(set(inside))
    return 2.0 * batch * pairs * c_in * c_out, batch * read * c_in


def least_forward_s(ops: dict, blocks_dtype: str = "bf16", fc_dtype: str = "bf16") -> float:
    """Least seconds of one forward's products at the peaks of the types
    they run in (the stem always bf16)."""
    return (ops["stem"] / PEAKS["bf16"] + ops["blocks"] / PEAKS[blocks_dtype]
            + ops["fc"] / PEAKS[fc_dtype])


def least_train_s(ops: dict) -> float:
    """Least seconds of one volume's training step in bf16: the forward and
    two backward products (input and weight gradients) of every product,
    without the stem's input gradient."""
    return (2 * ops["stem"] + 3 * ops["blocks"] + 3 * ops["fc"]) / PEAKS["bf16"]


def k1_least_s(rows: int, distinct_rows: int, vox: int, src_bytes: int, out_bytes: int,
               idx_bytes: int) -> float:
    """Least time for one K1 launch: each distinct gathered voxel read once,
    each output written once, the indices read once; or its ~4 operations a
    voxel at the float32 rate, whichever is larger (chip_smoke.py's
    k1_bound_ms, per launch)."""
    moved = distinct_rows * vox * src_bytes + rows * vox * out_bytes + rows * idx_bytes
    return max(moved / HBM_BYTES_PER_S, rows * vox * K1_OPS_PER_VOXEL / F32_OPS_PER_S)


def k3_least_s(ops, in_bytes, m, n, k, out_bytes) -> float:
    """Least time for one K3 launch: the input voxels it needs, the weights
    and the epilogue vectors read once, `out_bytes` moved per (M, N)
    element; or `ops` at the int8 dense rate (chip_smoke.py's
    k3_bound_ms)."""
    moved = in_bytes + n * k + 8 * n + m * n * out_bytes
    return max(moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
