"""The plain reference against the port's CPU path at a small size, at
float32 where the port can run it: the same weights, inputs and draws give
the same numbers."""

import numpy as np
import pytest
import torch

import portbench_tiny
from portbench.lib import family, inputs
from portbench.reference import data as ref_data
from portbench.reference import int8 as ref_int8
from portbench.reference import resnet3d as ref


def _program_model(depth, sd, compute=torch.float32, s2d=True):
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    m = generate_model(model_depth=depth, compute_dtype=compute, s2d_stem=s2d)
    m.load_state_dict(sd)
    return m


RESNET = family.load("resnet")


def _init(depth, seed):
    return RESNET.init_weights({"model_depth": depth, "in_channels": 1, "nb_class": 2}, seed,
                               "cpu")


def _serving_weights(depth, seed=1, shape=(20, 24, 20)):
    sd = _init(depth, seed)
    RESNET.trained_affine(sd, seed + 1, "cpu")
    x = torch.from_numpy(inputs.brain_volumes(4, shape, seed + 2, "cpu"))
    return RESNET.calibrate_batchnorm(sd, ref_data.normalize(x).unsqueeze(1), depth), x


@pytest.mark.parametrize("depth,s2d", [(18, True), (18, False), (50, True)])
def test_eval_forward_matches_the_program(depth, s2d):
    sd, x = _serving_weights(depth)
    xn = ref_data.normalize(x)
    with torch.no_grad():
        want = ref.forward(sd, xn.unsqueeze(1), depth)
        got = _program_model(depth, sd, s2d=s2d).eval()(xn.unsqueeze(-1))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_train_forward_with_dropout_matches_the_program():
    from multimodal_ad_tpu_torch.models.resnet3d import set_dropout_generator
    sd = _init(18, 3)
    x = ref_data.normalize(torch.from_numpy(inputs.brain_volumes(4, (20, 24, 20), 4, "cpu")))
    model = _program_model(18, sd).train()
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    keep = torch.rand((4, 512), generator=torch.Generator().manual_seed(9)) >= 0.5
    with torch.no_grad():
        got = model(x.unsqueeze(-1))
        want = ref.forward(sd, x.unsqueeze(1), 18, train=True, dropout_keep=keep)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_first_steps_and_eval_match_the_program_in_float32():
    """The training driver's check at float32 (the port's fp32 path): the
    epoch order, augmentation draws, dropout, loss, clip, Adam, rate and
    eval step all agree to float32 rounding.

    At four torch threads. The BatchNorm scales' and shifts' gradient norms
    at this small size magnify float32 rounding about a thousandfold, and
    the CPU's channels-last BatchNorm, which the program's layout runs,
    sums per thread: at 1 or 2 threads the program's first gradient lies
    2.9e-3 / 3.4e-3 from a float64 reference in those leaves, at 4 threads
    9.8e-5, as near as the float32 reference's own 1.0e-4 (which no thread
    count moves)."""
    from portbench.lib.train import Train
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        t = Train(portbench_tiny.config(compute_dtype="float32"),
                  portbench_tiny.mix("cv_fold_epochs"), 2 ** 31 + 5, "cpu")
        t.close()
        r = t.readings(t.reference())
    finally:
        torch.set_num_threads(before)
    assert r["loss_gap"] < 1e-5 and r["eval_gap"] < 1e-5
    assert r["grad_gap"] < 1e-3 and r["change_gap"] < 1e-3


def test_normalisation_and_uint8_store_match_the_program():
    from multimodal_ad_tpu_torch.data.device_cache import quantize_uint8
    from multimodal_ad_tpu_torch.ops.fused_gather import gather_normalize_plain
    vols = inputs.brain_volumes(3, (10, 12, 10), 5, "cpu", dtype=torch.int16)
    q = quantize_uint8(vols[..., None])[..., 0]
    assert np.array_equal(q, np.stack([ref_data.to_uint8(v) for v in vols]))
    src = torch.from_numpy(q)
    got = gather_normalize_plain(src, torch.tensor([2, 0, 2]))
    want = ref_data.normalize(src[[2, 0, 2]])
    assert torch.allclose(got, want, atol=2e-7)


def test_augmentation_replay_matches_the_program():
    from multimodal_ad_tpu_torch.ops.augment import augment_batch
    x = ref_data.normalize(torch.from_numpy(inputs.brain_volumes(8, (12, 14, 12), 6, "cpu")))
    draws = ref_data.AugmentDraws(11)
    g = torch.Generator().manual_seed(11)
    for _ in range(3):  # three batches: the draws stay in step
        got = augment_batch(x.unsqueeze(-1), g)[..., 0]
        want = ref_data.augment(x, draws.next(8))
        assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("depth", [18, 50])
def test_int8_reference_matches_the_programs_int8_path(depth):
    """The same folded, quantized weights. With the reference's activation
    scales in the program, its logits lie nearer the int8 reference's than
    the 4-bit reference's: the program's bf16 stem and bf16 block outputs
    move some values across a rounding boundary, so the two int8 forwards
    differ by single quantization steps (at this small grid the pool
    averages few voxels, so those steps show), not by a bit width."""
    from multimodal_ad_tpu_torch.models import resnet3d_int8 as q8
    sd, x = _serving_weights(depth)
    xn = ref_data.normalize(x).unsqueeze(1)
    qp_ref = ref_int8.export(sd, depth)
    scales = ref_int8.scales(ref_int8.observe(qp_ref, xn, depth))
    qp = q8.export_int8(sd, depth=depth)
    for blk, plan in zip(qp["blocks"], ref.block_plan(depth)):
        for name, *_ in plan["convs"]:
            _, wq, s, b = qp_ref["convs"][(plan["prefix"], name)]
            assert np.allclose(blk[name]["s"], s.numpy(), rtol=1e-6)
            mine = np.transpose(wq.numpy(), (2, 3, 4, 1, 0))
            assert np.mean(mine != blk[name]["wq"]) < 1e-3
    net = q8.ResNet3DInt8(q8.strip_fp(qp), scales)
    qp4 = ref_int8.export(sd, depth, levels=7)
    with torch.no_grad():
        got = net(ref_data.normalize(x).unsqueeze(-1))
        want = ref_int8.forward(qp_ref, scales, xn, depth)
        four = ref_int8.forward(qp4, ref_int8.scales(ref_int8.observe(qp4, xn, depth), 7),
                                xn, depth, levels=7)
    assert float((got - want).abs().mean()) < 0.5 * float((got - four).abs().mean())
