"""Driver of the training mixes (traffic files of kind "train"): one fold of
the cross-validation, epoch after epoch, through the program's resident
path (`DeviceDataset`, `DeviceEpochIterator` with device augmentation,
`train.loop.train_step` / `eval_step`, `train.cv._run_epoch`), and its check
against the plain reference.

Set-up makes the corpus, the labels, the split and the initial weights from
the seed, builds the program's dataset, iterators and train state, and runs
the fold's first epoch exactly as the window runs every later one, through
`_run_epoch` on the window's own iterators and state: that warms every shape
the window uses. Its first CHECKED_STEPS steps are recorded on their way
through (each loss, the first gradient as Adam holds it, the parameters'
change), then a validation pass through `_run_epoch` on the state they left
gives the eval probabilities: these are what the reference follows. The
window then runs whole epochs (the fold's train split, then its validation
split) until `--seconds` have passed; each epoch ends in the program's one
host fetch. Every epoch, set-up's and the window's, has to take one update
a batch and return a finite mean loss."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.lib import check, family, inputs, traffic
from portbench.lib.serve import _reference_precision
from portbench.reference import data as ref_data
from portbench.reference import train as ref_train

CHECKED_STEPS = 3


def _program():
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.train import cv, loop
    return DeviceDataset, DeviceEpochIterator, cv, loop


class Train:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.family = family.of(cfg)
        self.dev = torch.device(device)
        self.shape = tuple(cfg["input_shape"])
        self.bs = cfg["batch_size"]
        self.phases = [("start", time.perf_counter())]
        plan = traffic.train_corpus(mix, seed)
        self.labels, self.train_idx, self.val_idx = plan["labels"], plan["train"], plan["val"]
        corpus = inputs.brain_volumes(mix["corpus_volumes"], self.shape,
                                      inputs.sub_seed(seed, "volumes"), self.dev,
                                      dtype=torch.int16, ad=self.labels == 1)[..., None]
        self.iter_seed = inputs.sub_seed(seed, "epochs")
        self.dropout_seed = inputs.sub_seed(seed, "dropout")
        self.weight_seed = inputs.sub_seed(seed, "weights")
        sd0 = self.family.init_weights(cfg, self.weight_seed, self.dev)
        self.phases.append(("corpus and weights made", time.perf_counter()))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)

        dataset, epoch_iter, self.cv, self.loop = _program()
        ds = dataset(corpus, self.labels, device=self.dev, quantize=mix["quantize"])
        self.loader_tr = epoch_iter(ds, self.train_idx, self.bs, shuffle=True,
                                    seed=self.iter_seed, augment=mix["augment"],
                                    normalizer=cfg["normalizer"])
        self.loader_vl = epoch_iter(ds, self.val_idx, self.bs, normalizer=cfg["normalizer"])
        self.batches_per_epoch = len(self.loader_tr)
        self.phases.append(("DeviceDataset built", time.perf_counter()))
        model = self.family.program_model(cfg, self.dev)
        model.load_state_dict(sd0)
        del sd0
        self.phases.append(("model built", time.perf_counter()))
        self.schedule = self.loop.make_epoch_schedule(
            cfg["lr"], cfg["num_epochs"], cfg["warmup_frac"], cfg["min_lr_factor"])
        self.state = self.loop.create_train_state(
            model, self.schedule, cfg["weight_decay"], cfg["grad_clip_norm"], "adam",
            dropout_seed=self.dropout_seed)
        self.phases.append(("create_train_state", time.perf_counter()))
        self.cw_host = (1.0 / np.maximum(np.bincount(self.labels[self.train_idx],
                                                     minlength=cfg["nb_class"]), 1)
                        ).astype(np.float32)
        self.cw = torch.from_numpy(self.cw_host).to(self.dev)
        self.phases.append(("train state built", time.perf_counter()))
        self.epochs = []  # (updates, train mean loss, validation mean loss) of each epoch
        self._first_epoch()
        self.phases.append(("first epoch, checked steps and eval pass", time.perf_counter()))
        # the reference needs only the rows of the checked steps
        self.rows = {int(i): corpus[i, ..., 0] for i in self._checked_rows()}
        del corpus
        self.traced = None

    def _checked_rows(self):
        order = ref_data.epoch_order(self.train_idx, self.iter_seed, 0)
        return list(order[:CHECKED_STEPS * self.bs]) + list(self.val_idx[:self.bs])

    def _epoch(self, train_step=None, eval_step=None) -> None:
        """One epoch as the window runs it: the train split through
        `_run_epoch`, the validation split through `_run_epoch`, then
        `next_epoch`; records its updates and mean losses."""
        first = self.state.step
        with torch.profiler.record_function("portbench.train_epoch"):
            _, loss_tr, _ = self.cv._run_epoch(
                train_step or self.loop.train_step, self.state, self.loader_tr, self.dev,
                train=True, class_weights=self.cw, normalizer=self.cfg["normalizer"])
        with torch.profiler.record_function("portbench.eval_epoch"):
            _, loss_vl, _ = self.cv._run_epoch(
                eval_step or self.loop.eval_step, self.state, self.loader_vl, self.dev,
                train=False, normalizer=self.cfg["normalizer"])
        self.loop.next_epoch(self.state)
        self.epochs.append((self.state.step - first, loss_tr, loss_vl))

    def _first_epoch(self) -> None:
        """The fold's first epoch, with its first CHECKED_STEPS updates
        recorded as `_run_epoch` drives them, and a validation pass through
        `_run_epoch` on the state they leave: what the program reads for
        the check."""
        params = dict(self.state.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        losses, evals = [], []

        def recorded_eval(state, batch):
            loss, probs = self.loop.eval_step(state, batch)
            if not evals:
                evals.append(probs.float().cpu().numpy())
            return loss, probs

        def recorded_train(state, batch, class_weights):
            loss, probs = self.loop.train_step(state, batch, class_weights)
            losses.append(loss)
            if len(losses) == 1:
                beta1 = state.optimizer.param_groups[0]["betas"][0]
                # a parameter the step left without state got no gradient
                self.p_grad = check.leaf_norms(
                    {n: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                     / (1 - beta1) for n, p in params.items()})
            if len(losses) == CHECKED_STEPS:
                self.p_change = check.leaf_norms(
                    {n: p.detach() - p0[n] for n, p in params.items()})
                self.cv._run_epoch(recorded_eval, state, self.loader_vl, self.dev,
                                   train=False, normalizer=self.cfg["normalizer"])
            return loss, probs

        self._epoch(recorded_train)
        self.p_losses = [float(v) for v in losses[:CHECKED_STEPS]]
        self.p_eval = evals[0] if evals else np.full((self.bs, self.cfg["nb_class"]), np.nan)
        del p0, losses

    def window(self, seconds: float, trace_seconds: float | None = None) -> dict:
        """Whole epochs (train split, then validation) until `seconds` have
        passed; with `trace_seconds` the profiler records the epochs that
        start in the window's first `trace_seconds`."""
        prof = None
        if trace_seconds:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        epochs, end, epoch_s = 0, t0, []
        while end - t0 < seconds:
            start = end
            self._epoch()
            epochs += 1
            end = time.perf_counter()
            epoch_s.append(end - start)
            if prof is not None and end - t0 >= trace_seconds:
                prof.__exit__(None, None, None)
                self.traced, prof = (prof, epochs, end - t0), None
        if prof is not None:
            prof.__exit__(None, None, None)
            self.traced = (prof, epochs, end - t0)
        return {"epochs": epochs, "steps": epochs * self.batches_per_epoch,
                "volumes": epochs * len(self.train_idx), "window_s": end - t0,
                "epoch_s": epoch_s}

    def trace_context(self, summary: dict) -> dict:
        """What the per-layer readers take from a traced window: the trace's
        reduction and the shapes of the work the traced epochs gave the
        program (see portbench/README.md)."""
        _, epochs, _ = self.traced
        launches = epochs * (len(self.loader_tr) + len(self.loader_vl))
        return {**summary, "kind": "train", "model": self.family.describe(self.cfg),
                "batch": self.bs,
                # one K1 launch a batch: (rows, distinct source rows, source
                # bytes a voxel (the uint8 store), output bytes a voxel)
                "k1_launches": [(self.bs, self.bs, 1, 4)] * launches,
                "volumes_trained": epochs * len(self.train_idx),
                "volumes_evaluated": epochs * len(self.val_idx)}

    def close(self) -> None:
        del self.state, self.loader_tr, self.loader_vl
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------

    def reference(self, quant=None, half_batch: bool = False) -> dict:
        """The reference's first steps and eval step from the same initial
        weights, batches, augmentation and dropout draws: {'losses',
        'grad' (leaf norms of the first step's gradient as Adam gets it),
        'change' (leaf norms of the parameters' change over the steps),
        'eval' (probabilities)}. `quant` computes it in a lower precision
        (the control); `half_batch` leaves the second half of each batch out
        of the loss, its mean taken over the rest (a fault the check has to
        catch)."""
        cfg, dev = self.cfg, self.dev
        with _reference_precision():
            sd0 = self.family.init_weights(cfg, self.weight_seed, dev)
            rate = ref_train.epoch_schedule(cfg["lr"], cfg["num_epochs"], cfg["warmup_frac"],
                                            cfg["min_lr_factor"])
            trainer = ref_train.Trainer(sd0, self.family, cfg,
                                        torch.from_numpy(self.cw_host).to(dev), rate, quant)
            draws = ref_data.AugmentDraws(self.iter_seed)
            order = ref_data.epoch_order(self.train_idx, self.iter_seed, 0)
            drop = torch.Generator(device=dev).manual_seed(self.dropout_seed)
            losses, grad = [], None
            mask = torch.ones(self.bs, device=dev)
            if half_batch:
                mask[self.bs // 2:] = 0
            for k in range(CHECKED_STEPS):
                idx = order[k * self.bs:(k + 1) * self.bs]
                x = ref_data.augment(self._normalized(idx), draws.next(self.bs))
                keep = torch.rand((self.bs, self.family.dropout_width(cfg)), generator=drop,
                                  device=dev) >= cfg["dropout_rate"]
                y = torch.from_numpy(self.labels[idx]).to(dev)
                loss, g = trainer.step(x.unsqueeze(1), y, mask, keep)
                losses.append(loss)
                if k == 0:
                    grad = check.leaf_norms(g)
            change = check.leaf_norms({k: trainer.params[k].detach() - sd0[k]
                                       for k in trainer.params})
            vidx = self.val_idx[:self.bs]
            _, probs = trainer.evaluate(self._normalized(vidx).unsqueeze(1),
                                        torch.from_numpy(self.labels[vidx]).to(dev),
                                        torch.ones(self.bs, device=dev))
        return {"losses": losses, "grad": grad, "change": change,
                "eval": probs.double().cpu().numpy()}

    def _normalized(self, idx) -> torch.Tensor:
        vols = np.stack([ref_data.to_uint8(self.rows[int(i)]) for i in idx])
        return ref_data.normalize(torch.from_numpy(vols).to(self.dev))

    def check(self) -> dict:
        """The compared numbers against the float32 reference."""
        return self.readings(self.reference())

    def readings(self, reference: dict, program: dict | None = None) -> dict:
        """The compared numbers of `program` (the program's own readings by
        default, or a control's) against `reference`."""
        p = program or {"losses": self.p_losses, "grad": self.p_grad,
                        "change": self.p_change, "eval": self.p_eval}
        return {
            "loss_gap": max(abs(a - b) for a, b in zip(p["losses"], reference["losses"])),
            "grad_gap": check.worst_leaf_gap(p["grad"], reference["grad"], reference["grad"]),
            "change_gap": check.worst_leaf_gap(p["change"], reference["change"],
                                               reference["grad"]),
            "eval_gap": check.prob_gap(p["eval"], reference["eval"]),
            "epoch_faults": float(self.epoch_faults()),
        }

    def epoch_faults(self) -> int:
        """Epochs, set-up's and the window's, that did not take one update
        a batch of the train split or returned a mean loss that is not
        finite."""
        return sum(1 for updates, loss_tr, loss_vl in self.epochs
                   if updates != self.batches_per_epoch or not np.isfinite(loss_tr)
                   or not np.isfinite(loss_vl))
