"""Serving: load a trained fold ensemble and predict on volumes (port of
the TPU package's serve.py).

- every fold is its own eval-mode ResNet3D on the device; folds run in a
  Python loop and their softmax probabilities are averaged in float32 on
  the device; only the final (n, classes) array crosses back to the host,
- each request is cut into chunks of the batch size, and each chunk is
  forwarded at the smallest bucket that holds its rows: a power of two
  below the batch size, or the batch size itself ({1, 2, 4, 8} at 8).
  Rows up to the bucket repeat the chunk's last volume and are dropped
  after the forward. The first request of a volume shape through the
  current folds (bf16, or int8 after `quantize_int8`) also forwards every
  bucket once through one fold, so cuDNN has chosen each bucket's
  algorithms before later requests need them: its heuristics below the
  batch size, its autotune at the batch size (`_warm_buckets`),
- preprocessing runs on the device: each chunk is uploaded raw and K1
  (ops/fused_gather.py) gathers the padded batch and min-max normalizes it
  in one pass. Multi-channel volumes normalize per channel, as the host
  path does: (n, X, Y, Z, C) is viewed as n*C channel planes. K1 writes
  bf16 directly when the model computes in bf16 (the first convolution
  would round its input to bf16 anyway),
- `quantize_int8` turns the ensemble into int8 serving
  (models/resnet3d_int8.py): every fold is exported, calibrated on the
  same preprocessing and then served by its `ResNet3DInt8`, whose block
  convolutions run K3 (ops/int8_conv.py) on the card,
- under a mesh (parallel/mesh.py) every rank holds the folds and runs its
  contiguous rows of each chunk padded to the whole batch size: it
  uploads only them, K1 normalizes them and the bf16 or int8 folds
  forward them; the rows' probabilities are assembled on every rank
  (`gather_rows`), so `predict_proba` returns the whole result everywhere.
  The batch size must divide by the mesh's data axes (a 'space' axis
  replicates the rows over its ranks). Calibration (`quantize_int8`) runs
  the whole calibration set on every rank, so the scales are the single
  process's,
- while a `torch.profiler` session records, `predict_proba` keeps spans
  and counters (utils/profiling.py): `predict.request` around the call,
  per chunk `predict.upload` (the blocking pageable copy),
  `predict.normalize` (K1's launch), `predict.fold` per fold (its forward's
  launches) and `predict.fetch` (the wait for the device and the copy
  back), and the rows this process forwards, `predict.rows_real` and
  `predict.rows_padded` (rows up to the bucket; under a mesh, up to this
  rank's share of the batch). The spans are host time: a launch's span is
  its enqueue, not the device's work.

Usage:
    pred = EnsemblePredictor.from_checkpoint_dir("checkpoints/")
    proba = pred.predict_proba(volumes)   # (n, X, Y, Z[, C]) -> (n, C)
    pred.quantize_int8(calibration_volumes)   # later calls serve int8
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from .core.config import Config, torch_dtype
from .core.device import resolve_device
from .models.resnet3d import generate_model
from .ops.fused_gather import gather_normalize
from .ops.normalize import NORMALIZERS
from .parallel import mesh as pmesh
from .train import checkpoint as ckpt
from .train.metrics import _macro_ovr_auc, binary_auc
from .utils.profiling import annotate, count


def labels_from_proba(proba: np.ndarray) -> np.ndarray:
    """Argmax labels; binary uses the reference's prob > 0.5 rule."""
    if proba.shape[1] == 2:
        return (proba[:, 1] > 0.5).astype(np.int32)
    return np.argmax(proba, axis=1).astype(np.int32)


def bucket_sizes(batch_size: int) -> list[int]:
    """The batches a chunk is forwarded at: the powers of two below
    `batch_size`, then `batch_size`."""
    return [1 << k for k in range((batch_size - 1).bit_length())] + [batch_size]


def bucket(real: int, batch_size: int) -> int:
    """The smallest of `bucket_sizes(batch_size)` that holds `real` rows."""
    return min(batch_size, 1 << (real - 1).bit_length())


class EnsemblePredictor:
    """Fold-ensemble classifier over 3D volumes on one device.

    `model` is a ResNet3D template; each entry of `fold_state_dicts` is
    loaded into its own copy. With `mesh` each rank serves its rows of
    every chunk (`batch_size` must divide by the mesh's size)."""

    def __init__(self, model, fold_state_dicts: list, batch_size: int = 8,
                 normalizer: str = "scale_intensity",
                 device: str | torch.device = "cuda", mesh=None):
        self.device = resolve_device(device)
        if not fold_state_dicts:
            raise ValueError("no fold weights given")
        if normalizer not in NORMALIZERS:
            raise ValueError(f"unknown normalizer {normalizer!r}")
        self.mesh = mesh
        self.rows = (pmesh.local_rows(int(batch_size), mesh) if mesh is not None
                     else slice(0, int(batch_size)))
        self.model = model
        self.n_folds = len(fold_state_dicts)
        self.batch_size = int(batch_size)
        self.normalizer = normalizer
        self.input_dtype = model.compute_dtype
        self.folds = []
        for sd in fold_state_dicts:
            m = copy.deepcopy(model)
            m.load_state_dict(sd)
            self.folds.append(m.eval().requires_grad_(False).to(self.device))
        self.int8_folds = None  # set by quantize_int8
        self.warmed = set()  # (id of the fold list, volume shape) whose buckets have run

    # ---- construction -------------------------------------------------

    @classmethod
    def from_checkpoint_dir(cls, ckpt_dir: str, cfg: Config | None = None,
                            prefix: str = "best_fold",
                            batch_size: int | None = None,
                            device: str | torch.device = "cuda", mesh=None):
        """Load every `{prefix}{k}` checkpoint (k = 1..) of a CV output
        directory. The config comes from the checkpoints' meta.json unless
        `cfg` is given."""
        device = resolve_device(device)
        folds = []
        k = 1
        while os.path.isdir(os.path.join(ckpt_dir, f"{prefix}{k}")):
            folds.append(os.path.join(ckpt_dir, f"{prefix}{k}"))
            k += 1
        if not folds:
            raise FileNotFoundError(f"no {prefix}* checkpoints in {ckpt_dir}")

        if cfg is None:
            with open(os.path.join(folds[0], "meta.json")) as f:
                cfg = Config.from_dict(json.load(f).get("config", {}))

        model = generate_model(
            model_type=cfg.model_type, model_depth=cfg.model_depth,
            resnet_shortcut=cfg.resnet_shortcut, nb_class=cfg.nb_class,
            dropout_rate=cfg.dropout_rate, in_channels=cfg.in_channels,
            compute_dtype=torch_dtype(cfg.compute_dtype),
            param_dtype=torch_dtype(cfg.param_dtype))
        state_dicts = [ckpt.restore_state(path)[0] for path in folds]
        return cls(model, state_dicts, batch_size=batch_size or cfg.batch_size,
                   normalizer=cfg.normalizer, device=device, mesh=mesh)

    # ---- int8 serving ---------------------------------------------------

    @torch.inference_mode()
    def quantize_int8(self, calibration_volumes, preprocess: bool = True):
        """Convert the ensemble to int8 serving and return self.

        Every fold is exported (BN folded, per-channel int8 weights) and
        calibrated: `calibration_volumes`, a small representative set, pass
        through the same preprocessing as predict (K1, in chunks of the
        batch size) and the folded fp graph; each fold's activation scales
        are max|h| / 127 + 1e-12 over the set, in float32. Later `forward`
        and `predict_proba` calls run the int8 folds (softmax in float32,
        fold mean on the device). From this call on, preprocessing writes
        bf16, the int8 stem's input type. Supports every ResNet3D depth."""
        from .models import resnet3d_int8 as q8

        vols = np.asarray(calibration_volumes, np.float32)
        if vols.shape[0] == 0:
            raise ValueError("quantize_int8 got no calibration volumes")
        nets = []
        for m in self.folds:
            qp = q8.export_int8(m.state_dict(), depth=m.depth,
                                shortcut_type=m.shortcut_type)
            nets.append(q8.ResNet3DInt8(qp).to(self.device))
        self.input_dtype = torch.bfloat16
        maxes = None
        for i in range(0, vols.shape[0], self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(vols[i:i + self.batch_size]))
            x = self._prep(chunk.to(self.device), preprocess)
            obs = torch.stack([net.observe(x) for net in nets])  # (K, P)
            maxes = obs if maxes is None else torch.maximum(maxes, obs)
        # on the host in numpy float32, a true division as the TPU package's
        # (a CUDA division by a host scalar multiplies by its reciprocal)
        fold_scales = maxes.float().cpu().numpy() / np.float32(127.0) + np.float32(1e-12)
        for net, svec in zip(nets, fold_scales):
            net.set_scales(svec).strip_fp()
        self.int8_folds = nets
        return self

    # ---- inference -----------------------------------------------------

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized device batch (B, X, Y, Z, C) -> fold-mean
        probabilities (B, classes), float32, on the device; through the
        int8 folds after `quantize_int8`."""
        acc = None
        for m in self.int8_folds or self.folds:
            with annotate("predict.fold"):
                p = torch.softmax(m(x).float(), dim=-1)
                acc = p if acc is None else acc + p
        return acc / self.n_folds

    @torch.inference_mode()
    def _warm_buckets(self, x: torch.Tensor, used: int) -> None:
        """On the first chunk of a volume shape through the current folds
        (the bf16 ones, or the int8 ones after `quantize_int8`), forward its
        normalized batch `x` at every bucket through one fold and drop the
        result, so later chunks find each bucket's convolution algorithms
        chosen. The buckets below the batch size take cuDNN's heuristic
        choice: there the five folds' enqueue paces a chunk more than the
        device does, and autotuning would add ~0.7 s of set-up a bucket
        (bf16 ResNet-18 at 91x109x91 on an H100). The whole batch is
        autotuned, here unless this chunk (`used` rows) fills it.

        This rests on PyTorch's cuDNN plan cache, which is not a documented
        guarantee: it is keyed by the convolution's shape, dtype and layout,
        not by the weights (so one fold warms all five) nor by
        `cudnn.benchmark` (so a plan the heuristics chose here is reused
        once autotune is back on, and the bucket is never autotuned)."""
        folds = self.int8_folds or self.folds
        key = (id(folds), x.shape[1:])
        if key in self.warmed:
            return
        self.warmed.add(key)
        fold = folds[0]
        cudnn = torch.backends.cudnn
        tune, cudnn.benchmark = cudnn.benchmark, False
        try:
            for b in bucket_sizes(self.batch_size)[:-1]:
                fold(x[:b])
        finally:
            cudnn.benchmark = tune
        if used != self.batch_size:
            fold(x)

    def _prep(self, chunk: torch.Tensor, preprocess: bool,
              size: int | None = None) -> torch.Tensor:
        """Device chunk (real, X, Y, Z[, C]) float32 -> padded, normalized
        batch (size, X, Y, Z, C), size the batch size by default, in
        `input_dtype` (the model's compute type; bf16 once `quantize_int8`
        has begun)."""
        dtype = self.input_dtype
        if chunk.dim() == 4:
            chunk = chunk.unsqueeze(-1)
        real, *spatial, c = chunk.shape
        bs = self.batch_size if size is None else size
        rows = torch.arange(bs).clamp(max=real - 1)  # pad: repeat the last row
        if not preprocess:
            return chunk[rows.to(chunk.device)]
        planes = chunk.permute(0, 4, 1, 2, 3).contiguous().view(real * c, -1)
        plane_idx = (rows[:, None] * c + torch.arange(c)).reshape(-1)
        if self.normalizer == "scale_intensity":
            x = gather_normalize(planes, plane_idx, dtype)
        else:
            x = NORMALIZERS[self.normalizer](planes[plane_idx.to(chunk.device)]).to(dtype)
        # channel planes are NCDHW memory; hand the model its channels-last view
        return x.view(bs, c, *spatial).permute(0, 2, 3, 4, 1)

    def predict_proba(self, volumes, preprocess: bool = True) -> np.ndarray:
        """(n, X, Y, Z) or (n, X, Y, Z, C) host volumes -> (n, classes)
        fold-mean probabilities (on every rank under a mesh)."""
        with annotate("predict.request"):
            vols = np.asarray(volumes, np.float32)
            bs = self.batch_size
            own = self.rows.stop - self.rows.start
            out = []
            for i in range(0, vols.shape[0], bs):
                real = min(bs, vols.shape[0] - i)
                if self.mesh is None:
                    chunk = vols[i:i + real]
                else:  # upload only this rank's rows, the pad repeating the last
                    chunk = vols[i + np.minimum(np.arange(bs)[self.rows], real - 1)]
                with annotate("predict.upload"):
                    chunk = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                with annotate("predict.normalize"):
                    x = self._prep(chunk, preprocess, own)
                if self.mesh is None:  # forward a prefix of K1's batch: no copy
                    own_real, rows = real, bucket(real, bs)
                    self._warm_buckets(x, rows)
                    x = x[:rows]
                else:  # every rank forwards its whole share of the batch
                    own_real, rows = min(max(real - self.rows.start, 0), own), own
                probs = self.forward(x)
                with annotate("predict.fetch"):
                    out.append(pmesh.gather_rows(probs, self.mesh)[:real].cpu().numpy())
                count("predict.rows_real", own_real)
                count("predict.rows_padded", rows - own_real)
            return np.concatenate(out, axis=0)

    def predict(self, volumes, preprocess: bool = True) -> np.ndarray:
        """Argmax labels; binary uses the reference's prob > 0.5 rule."""
        return labels_from_proba(self.predict_proba(volumes, preprocess))


def evaluate_records(predictor: EnsemblePredictor, records) -> dict:
    """Held-out AUC/ACC of a fold-ensemble predictor on manifest records
    ({'MRI': path, 'label': int}), with the prob > 0.5 binary rule. AUC is
    sklearn's roc_auc_score (binary, or the macro one-vs-rest mean) and ACC
    its accuracy_score, computed in numpy (train/metrics.py): the card's
    machine has no sklearn."""
    from .data.pipeline import load_volume

    vols = np.stack([load_volume(r["MRI"]) for r in records])
    y = np.asarray([r["label"] for r in records])
    proba = predictor.predict_proba(vols)
    if proba.shape[1] == 2:
        auc = binary_auc(y, proba[:, 1])
    else:
        auc = _macro_ovr_auc(y, proba, proba.shape[1])
    return {"AUC": float(auc), "ACC": float(np.mean(y == labels_from_proba(proba)))}
