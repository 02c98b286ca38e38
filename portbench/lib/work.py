"""The yardstick: published peaks of the card, and the operations and bytes
the model and the kernels need, counted from shapes.

Peaks are NVIDIA's H100 SXM data sheet, dense: bf16 989 TFLOP/s, int8
1,979 TOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM 3.35 TB/s.

Convolution work counts only the (output voxel, tap) pairs whose tap lands
inside the volume (a tap in the zero padding multiplies nothing), as
`k3_work` below, copied from chip_smoke.py, does. The model's work is the
published architecture's: the plain 7^3 stem whatever stem the program
runs, so a change of implementation does not change the count."""

from __future__ import annotations

from portbench.reference import resnet3d as ref

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


def conv_plan(depth: int, shape, in_channels: int = 1) -> list[dict]:
    """Every convolution of the published network on one volume of
    `shape`, in forward order: name, input grid, channels, kernel, stride,
    dilation, the block's kind and whether it is the block's last conv."""
    convs = [{"name": "stem", "grid": tuple(shape), "c_in": in_channels, "c_out": 64,
              "k": 7, "stride": 2, "dil": 1, "pad": 3}]
    g = tuple(out_size(n, 7, 2, 1) for n in shape)
    g = tuple(out_size(n, 3, 2, 1) for n in g)  # the max pool
    for blk in ref.block_plan(depth):
        last = "conv2" if blk["kind"] == "basic" else "conv3"
        gin, gcur = g, g
        for name, cin, cout, k, stride, dil in blk["convs"]:
            src = gin if name in ("conv1", "down") else gcur
            convs.append({"name": f"{blk['prefix']}.{name}", "grid": src, "c_in": cin,
                          "c_out": cout, "k": k, "stride": stride, "dil": dil,
                          "kind": blk["kind"], "last": name == last,
                          "down": name == "down"})
            if name != "down":
                gcur = tuple(out_size(n, k, stride, dil) for n in src)
        g = gcur
    return convs


def forward_ops(depth: int, shape, in_channels: int = 1, num_classes: int = 2) -> dict:
    """Operations of one volume's forward: {'stem', 'blocks', 'fc'}."""
    ops = {"stem": 0.0, "blocks": 0.0, "fc": 2.0 * ref.fc_in(depth) * num_classes}
    for c in conv_plan(depth, shape, in_channels):
        if c["name"] == "stem":
            n = 1
            for s in c["grid"]:
                n *= sum(1 for o in range(out_size(s, 7, 2, 1)) for t in range(7)
                         if 0 <= o * 2 - 3 + t < s)
            ops["stem"] += 2.0 * n * c["c_in"] * c["c_out"]
        else:
            ops["blocks"] += k3_work(1, c["grid"], c["c_in"], c["c_out"], c["k"],
                                     c["stride"], c["dil"])[0]
    return ops


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


def k3_launches(depth: int, shape, batch: int) -> list[tuple]:
    """K3's launches in one int8 forward at `batch`: (operations, input
    bytes, M, N, K, output bytes per (M, N) element), in order. Epilogues:
    a block's inner convs write int8, its shortcut conv float32, its last
    conv reads the residual (float32 after a shortcut conv, else the bf16
    identity) and writes bf16 h and, but in the last block, the next int8
    quant point."""
    plan = [c for c in conv_plan(depth, shape) if c["name"] != "stem"]
    n_blocks = len(ref.block_plan(depth))
    out, block = [], -1
    has_down = {c["name"].rsplit(".", 1)[0] for c in plan if c["down"]}
    for c in plan:
        prefix = c["name"].rsplit(".", 1)[0]
        if c["name"].endswith("conv1"):
            block += 1
        ops, in_bytes = k3_work(batch, c["grid"], c["c_in"], c["c_out"], c["k"],
                                c["stride"], c["dil"])
        m = batch
        for s in c["grid"]:
            m *= out_size(s, c["k"], c["stride"], c["dil"])
        if c["down"]:
            per = 4
        elif c["last"]:
            per = (4 if prefix in has_down else 2) + 2 + (1 if block < n_blocks - 1 else 0)
        else:
            per = 1
        out.append((ops, in_bytes, m, c["c_out"], c["k"] ** 3 * c["c_in"], per))
    return out


def k3_least_s(ops, in_bytes, m, n, k, out_bytes) -> float:
    """Least time for one K3 launch: the input voxels it needs, the weights
    and the epilogue vectors read once, `out_bytes` moved per (M, N)
    element; or `ops` at the int8 dense rate (chip_smoke.py's
    k3_bound_ms)."""
    moved = in_bytes + n * k + 8 * n + m * n * out_bytes
    return max(moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
