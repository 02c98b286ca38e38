"""The check of `correct` against a broken timed path, and against each
cell's control, driven on the CPU at a small size.

Each fault test skips the harness's look for a card and drives the rest of
a run (`run.run_cell`) with the program broken underneath; the check has to
come out false. The controls put the lower precision in the program's
place: for bf16 serving the program's own int8 path, for int8 serving the
4-bit reference, for training the reference in fp8."""

import numpy as np
import pytest

import portbench_tiny
from portbench import run
from portbench.lib import check

pytestmark = pytest.mark.filterwarnings("ignore")


def _run(cell_name, seed=2 ** 31 + 101, seconds=1.5, **mix_changes):
    cell = portbench_tiny.cell(cell_name)
    cfg = portbench_tiny.config(
        next(c for c in portbench_tiny.manifest()["configs"]
             if c["name"] == cell["config"])["name"])
    mix = portbench_tiny.mix(cell["traffic"], **mix_changes)
    return run.run_cell(portbench_tiny.manifest(), cell, seed, seconds, False, "cpu",
                        cfg=cfg, mix=mix)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from multimodal_ad_tpu_torch import serve
    orig = serve.EnsemblePredictor.predict_proba

    def altered(self, volumes, preprocess=True):
        p = orig(self, volumes, preprocess)
        p[-1] = p[-1, ::-1]  # one answer's classes swapped where it is produced
        return p

    monkeypatch.setattr(serve.EnsemblePredictor, "predict_proba", altered)
    out, checks = _run("r18_serve_bf16")
    assert out["attempted"] > 0 and not out["correct"], checks


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from multimodal_ad_tpu_torch.train import loop
    monkeypatch.setattr(loop, "apply_gradients", lambda state: None)
    out, checks = _run("r50_train")
    assert not out["correct"] and checks["change_gap"]["value"] >= 0.99, checks
    assert checks["epoch_faults"]["value"] >= 1, checks


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from multimodal_ad_tpu_torch.train import loop
    orig = loop.forward_backward

    def half(state, batch, class_weights):
        mask = batch["mask"].clone()
        mask[mask.shape[0] // 2:] = 0  # the mean taken over the first half
        return orig(state, {**batch, "mask": mask}, class_weights)

    monkeypatch.setattr(loop, "forward_backward", half)
    out, checks = _run("r50_train")
    assert not out["correct"], checks


def test_bf16_serving_control_the_programs_int8_path_is_refused():
    from portbench.lib.serve import Serve
    s = Serve(portbench_tiny.config(), portbench_tiny.mix("clinic_study_mix_int8"), 7, "cpu")
    s.window(1.0)
    s.close()
    readings = s.readings(s.reference_proba(None))
    ok, checks = check.judge(readings, check.load_limits("r18_serve_bf16"))
    assert not ok, checks


def test_int8_serving_control_the_4bit_reference_is_refused():
    from portbench.lib.serve import Serve
    s = Serve(portbench_tiny.config(), portbench_tiny.mix("clinic_study_mix_int8"), 8, "cpu")
    s.close()
    gap = check.prob_gap(s.reference_proba(7), s.reference_proba(127))
    ok, checks = check.judge({"prob_gap": gap}, check.load_limits("r18_serve_int8"))
    assert not ok, checks


def test_training_control_the_fp8_reference_is_refused():
    from portbench.lib.train import Train
    from portbench.reference import lowp
    t = Train(portbench_tiny.config("resnet50_adni"), portbench_tiny.mix("cv_fold_epochs"), 9,
              "cpu")
    t.close()
    ref = t.reference()
    ok, checks = check.judge(t.readings(ref, t.reference(quant=lowp.fp8)),
                             check.load_limits("r50_train"))
    assert not ok, checks


def test_an_epoch_that_skips_a_batch_is_not_correct(monkeypatch):
    from multimodal_ad_tpu_torch.train import cv
    orig = cv._run_epoch

    class Short:
        """The train split with its last batch left out."""
        device_resident = True

        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            return iter(list(self.loader)[:-1])

    def short(step_fn, state, loader, device, **kw):
        return orig(step_fn, state, Short(loader) if kw.get("train") else loader, device, **kw)

    monkeypatch.setattr(cv, "_run_epoch", short)
    out, checks = _run("r50_train")
    assert not out["correct"] and checks["epoch_faults"]["value"] >= 1, checks


def test_readings_are_judged_by_every_limit():
    ok, checks = check.judge({"a": 0.1}, {"a": 0.2, "b": 1.0})
    assert not ok and checks["b"]["value"] is None
    assert check.judge({"a": float("nan")}, {"a": 1.0})[0] is False
    assert check.judge({"a": 0.2}, {"a": 0.2})[0] is True
    assert np.isclose(check.prob_gap([[0.2, 0.8]], [[0.25, 0.75]]), 0.05)
