"""The work counts and the per-layer readers pinned to the numbers the
harness gave before the model family became a file of its own: the
ResNet's operations, K3 launches and least times for both configurations,
and every reader's value on a fixed synthetic `ctx`, each to the last bit
(constants read from the tree before the change)."""

import hashlib

import pytest

import portbench_tiny
from portbench import run
from portbench.lib import family, work

SHAPE = (91, 109, 91)
RESNET = family.load("resnet")
# depth: (forward_ops, least_forward_s bf16, int8, least_train_s, K3 launches,
#         their operations, input bytes, least time, sha256 of their repr)
PINNED = {
    18: ({"stem": 4757848576.0, "blocks": 84842512384.0, "fc": 2048.0},
         9.059692922952477e-05, 4.768220353483125e-05, 0.00026698002067542973,
         19, 678740099072.0, 94689280, 0.0003624844622624724,
         "012f691af72907e1a4115f58689daaafe404331fce999034fdfee3db12dea9c0"),
    50: ({"stem": 4757848576.0, "blocks": 140033277952.0, "fc": 8192.0},
         0.00014640155178968656, 7.557050421459566e-05, 0.0004343938883559151,
         52, 1120266223616.0, 507465728, 0.001148385040250873,
         "83cb89568d74ff3011f4ad9b36266e9e96f2e997172f793126720a8b73d988ea"),
}
TOTALS = {"spans": {"predict.request": (100, 3.2), "predict.upload": (110, 0.31),
                    "predict.normalize": (110, 0.2), "predict.fold": (550, 2.1),
                    "predict.fetch": (110, 0.4)},
          "counters": {"predict.rows_real": 558, "predict.rows_padded": 28}}
R18 = {"type": "resnet", "depth": 18, "shape": SHAPE, "in_channels": 1, "num_classes": 2}
REALS = (1, 3, 8, 8, 5, 1, 2, 8)
SERVE = {"kind": "serve", "model": R18, "batch": 8, "precision": "int8",
         "k1_launches": [(8, r, 4, 2) for r in REALS], "forwards": 5 * len(REALS),
         "volumes_forward": 5 * sum(REALS),
         "kernel_s": {"gather_normalize_kernel": 0.0123, "conv_i8_kernel<256, 3>": 1.5,
                      "conv_i8_kernel<256, 1>": 0.7, "sm90_xmma_fprop": 0.9},
         "kernel_n": {"gather_normalize_kernel": 8, "conv_i8_kernel<256, 3>": 500,
                      "conv_i8_kernel<256, 1>": 260, "sm90_xmma_fprop": 40},
         "busy_s": 4.1, "window_s": 5.03, "request_s": 4.6, "request_busy_s": 3.9}
TRAIN = {"kind": "train", "model": {**R18, "depth": 50}, "batch": 8,
         "k1_launches": [(8, 8, 1, 4)] * 90, "volumes_trained": 578, "volumes_evaluated": 144,
         "kernel_s": {"gather_normalize_kernel": 0.05},
         "kernel_n": {"gather_normalize_kernel": 90},
         "busy_s": 2.4, "window_s": 6.2, "request_s": 0.0, "request_busy_s": 0.0}
PREDICT = {"predict_fetch_share": 12.5, "predict_launch_share": 71.875,
           "predict_pad_share": 4.778156996587031, "predict_upload_share": 9.6875}
NO_PREDICT = dict.fromkeys(PREDICT)
READ = {
    "serve_int8": (SERVE, {"idle_share": 15.217391304347816, "k1_roofline": 0.5958393398859362,
                           "k3_roofline": 0.6590626586590407, **PREDICT,
                           "serve_mfu": 0.18658253557107882, "train_mfu": None}),
    "serve_bf16": ({**SERVE, "precision": "bf16"},
                   {"idle_share": 15.217391304347816, "k1_roofline": 0.5958393398859362,
                    "k3_roofline": None, **PREDICT, "serve_mfu": 0.3545097230720535,
                    "train_mfu": None}),
    "train": (TRAIN, {"idle_share": 61.29032258064516, "k1_roofline": 1.9399821850746264,
                      "k3_roofline": None, **NO_PREDICT, "serve_mfu": None,
                      "train_mfu": 4.389701466571513}),
}


@pytest.mark.parametrize("config,depth", [("resnet18_adni", 18), ("resnet50_adni", 50)])
def test_work_counts_of_both_configurations(config, depth):
    cfg = portbench_tiny.config(config, input_shape=list(SHAPE))
    model = RESNET.describe(cfg)
    assert model == {"type": "resnet", "depth": depth, "shape": SHAPE, "in_channels": 1,
                     "num_classes": 2}
    ops, bf16, int8, train, n, k3_ops, k3_in, k3_least, digest = PINNED[depth]
    got = RESNET.forward_ops(model)
    assert got == ops
    assert work.least_forward_s(got) == bf16
    assert work.least_forward_s(got, "int8", "f32") == int8
    assert work.least_train_s(got) == train
    k3 = RESNET.k3_launches(depth, SHAPE, 8)
    assert (len(k3), sum(c[0] for c in k3), sum(c[1] for c in k3)) == (n, k3_ops, k3_in)
    assert sum(work.k3_least_s(*c) for c in k3) == k3_least
    assert hashlib.sha256(repr(k3).encode()).hexdigest() == digest


@pytest.mark.parametrize("label", list(READ))
def test_every_reader_on_a_fixed_ctx(label, monkeypatch):
    from multimodal_ad_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    ctx, want = READ[label]
    names = sorted(p.stem for p in (portbench_tiny.ROOT / "portbench" / "metrics").glob("*.py"))
    assert names == sorted(want)
    assert {n: run.reader(n)(ctx) for n in names} == want
