"""The yardstick's counters against brute-force counts."""

from collections import Counter

import pytest
import torch
import torch.nn.functional as F

import portbench_tiny  # noqa: F401  (puts the repository on the path)
from portbench.lib import family, work
from portbench.reference import resnet3d as ref

RESNET = family.load("resnet")


def _resnet(depth, shape):
    return {"type": "resnet", "depth": depth, "shape": shape, "in_channels": 1,
            "num_classes": 2}


def _pairs_by_conv(grid, k, stride, dil):
    """(output voxel, tap) pairs whose tap lands inside the volume, counted
    by convolving ones with ones: each output sums its in-volume taps."""
    x = torch.ones((1, 1) + tuple(grid), dtype=torch.float64)
    w = torch.ones((1, 1, k, k, k), dtype=torch.float64)
    return float(F.conv3d(x, w, None, stride, dil * (k - 1) // 2, dil).sum())


@pytest.mark.parametrize("grid,k,stride,dil", [
    ((5, 6, 7), 3, 1, 1), ((5, 6, 7), 3, 2, 1), ((12, 14, 12), 3, 1, 2),
    ((12, 14, 12), 3, 1, 4), ((7, 5, 9), 1, 2, 1), ((9, 11, 9), 7, 2, 1)])
def test_k3_work_counts_in_volume_taps(grid, k, stride, dil):
    ops, _ = work.k3_work(2, grid, 3, 5, k, stride, dil)
    assert ops == 2.0 * 2 * 3 * 5 * _pairs_by_conv(grid, k, stride, dil)


def test_k3_work_input_bytes_of_a_strided_pointwise_conv():
    _, read = work.k3_work(1, (8, 8, 8), 4, 4, 1, 2, 1)
    assert read == 4 * 4 * 4 * 4  # one voxel in 2^3, 4 channels of one byte


def test_model_work_against_a_hand_count():
    """ResNet-10 on a 10^3 volume: every conv's pairs counted by convolving
    ones, walked through the network's shapes by hand."""
    shape = (10, 10, 10)
    ops = RESNET.forward_ops(_resnet(10, shape))
    stem = 2 * 1 * 64 * _pairs_by_conv(shape, 7, 2, 1)
    assert ops["stem"] == stem
    g = (5, 5, 5)          # stem: 10 -> 5
    g = (3, 3, 3)          # max pool 3/2/1: 5 -> 3
    blocks = 0.0
    # layer1: 64 -> 64 at 3^3, two convs
    blocks += 2 * 2 * 64 * 64 * _pairs_by_conv(g, 3, 1, 1)
    # layer2: conv1 stride 2 (3 -> 2), conv2, 1^3 shortcut stride 2
    blocks += 2 * 64 * 128 * _pairs_by_conv(g, 3, 2, 1)
    g2 = (2, 2, 2)
    blocks += 2 * 128 * 128 * _pairs_by_conv(g2, 3, 1, 1)
    blocks += 2 * 64 * 128 * _pairs_by_conv(g, 1, 2, 1)
    # layer3 (dilation 2) and layer4 (dilation 4) on the 2^3 grid, with shortcuts
    for cin, cout, dil in ((128, 256, 2), (256, 512, 4)):
        blocks += 2 * cin * cout * _pairs_by_conv(g2, 3, 1, dil)
        blocks += 2 * cout * cout * _pairs_by_conv(g2, 3, 1, dil)
        blocks += 2 * cin * cout * _pairs_by_conv(g2, 1, 1, 1)
    assert ops["blocks"] == blocks
    assert ops["fc"] == 2 * 512 * 2


def test_training_counts_two_backward_products_and_no_stem_input_gradient():
    ops = {"stem": 3.0, "blocks": 5.0, "fc": 7.0}
    assert work.least_train_s(ops) * work.BF16_OPS_PER_S == pytest.approx(2 * 3 + 3 * 5 + 3 * 7)


@pytest.mark.parametrize("depth", [18, 50])
def test_k3_launches_are_the_int8_forwards_convs(depth):
    launches = RESNET.k3_launches(depth, (91, 109, 91), 8)
    convs = sum(len(b["convs"]) for b in ref.block_plan(depth))
    assert len(launches) == convs == (19 if depth == 18 else 16 * 3 + 4)


def test_k3_epilogue_bytes_of_resnet18():
    """Bytes per output element: inner convs write int8 (1); shortcut convs
    float32 (4); a last conv reads its residual (float32 after a shortcut,
    else bf16), writes bf16 h and, but in the last block, the int8 quant
    point."""
    per = Counter(ln[5] for ln in RESNET.k3_launches(18, (91, 109, 91), 8))
    assert per == {1: 8, 4: 3 + 1, 5: 4, 7: 3}


def test_a_roofline_share_never_passes_its_bound():
    """The least times are lower bounds: a kernel at the peak reads 100 %."""
    t = work.k1_least_s(8, 5, 1000, 4, 2, 8)
    assert t == max((5 * 1000 * 4 + 8 * 1000 * 2 + 64) / work.HBM_BYTES_PER_S,
                    8 * 1000 * 4 / work.F32_OPS_PER_S)


def _reader(name):
    from portbench import run
    return run.reader(name)


def test_readers_take_their_work_from_the_shapes_the_drivers_pass():
    """Each reader works out its own least time from the traced work's
    shapes: a kernel at exactly its least time reads 100 %."""
    model = _resnet(18, (20, 24, 20))
    vox = 20 * 24 * 20
    k1 = [(8, 5, 4, 2), (8, 8, 4, 2)]
    k1_s = sum(work.k1_least_s(r, d, vox, s, o, 8) for r, d, s, o in k1)
    k3_s = 3 * sum(work.k3_least_s(*launch)
                   for launch in RESNET.k3_launches(18, (20, 24, 20), 8))
    ops = RESNET.forward_ops(model)
    ctx = {"kind": "serve", "model": model, "batch": 8, "precision": "int8", "forwards": 3,
           "k1_launches": k1, "volumes_forward": 13, "request_s": 13 * work.least_forward_s(
               ops, "int8", "f32"),
           "kernel_s": {"gather_normalize_kernel": k1_s, "conv_i8_kernel<256, 3>": k3_s},
           "kernel_n": {"gather_normalize_kernel": 2,
                        "conv_i8_kernel<256, 3>": 3 * len(RESNET.k3_launches(18, (20, 24, 20), 1))}}
    assert _reader("k1_roofline")(ctx) == pytest.approx(100.0)
    assert _reader("k3_roofline")(ctx) == pytest.approx(100.0)
    assert _reader("serve_mfu")(ctx) == pytest.approx(100.0)
    assert _reader("k3_roofline")({**ctx, "precision": "bf16"}) is None
    assert _reader("k1_roofline")({**ctx, "k1_launches": k1[:1]}) is None
    train = {"kind": "train", "model": model, "volumes_trained": 4, "volumes_evaluated": 2,
             "window_s": 4 * work.least_train_s(ops) + 2 * work.least_forward_s(ops)}
    assert _reader("train_mfu")(train) == pytest.approx(100.0)
