"""CSV + TensorBoard experiment logging (own copy of the TPU package's
utils/logging.py).

Per epoch: TensorBoard scalars fold{k}/{train,val}/{ACC,AUC,loss} and
fold{k}/lr, and one row of cv_results.csv, whose 19-column header matches
its rows (the reference's 9-column header did not). Values are written
with six decimals. TensorBoard is used only if torch's SummaryWriter
imports (it needs the `tensorboard` package); otherwise the writer does
nothing, since event files are observability, not training state.
"""

from __future__ import annotations

import csv
import os

CV_CSV_HEADER = [
    "fold", "epoch",
    "tr_acc", "tr_pre", "tr_sen", "tr_spe", "tr_f1", "tr_auc", "tr_mcc", "tr_loss",
    "vl_acc", "vl_pre", "vl_sen", "vl_spe", "vl_f1", "vl_auc", "vl_mcc", "vl_loss",
    "lr",
]
_KEYS = ("ACC", "PRE", "SEN", "SPE", "F1", "AUC", "MCC")


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def make_tb_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(log_dir)


class CVLogger:
    def __init__(self, checkpoint_dir: str, csv_name: str = "cv_results.csv",
                 tensorboard: bool = True):
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.csv_path = os.path.join(checkpoint_dir, csv_name)
        with open(self.csv_path, "w", newline="") as f:
            csv.writer(f).writerow(CV_CSV_HEADER)
        self.tb = make_tb_writer(checkpoint_dir) if tensorboard else _NullWriter()

    def log_epoch(self, fold, epoch, tr_metrics, tr_loss, vl_metrics, vl_loss, lr):
        for split, m, loss in (("train", tr_metrics, tr_loss), ("val", vl_metrics, vl_loss)):
            self.tb.add_scalar(f"fold{fold}/{split}/ACC", m["ACC"], epoch)
            self.tb.add_scalar(f"fold{fold}/{split}/AUC", m["AUC"], epoch)
            self.tb.add_scalar(f"fold{fold}/{split}/loss", loss, epoch)
        self.tb.add_scalar(f"fold{fold}/lr", lr, epoch)

        def six(x):
            return f"{x:.6f}"

        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [fold, epoch]
                + [six(tr_metrics[k]) for k in _KEYS] + [six(tr_loss)]
                + [six(vl_metrics[k]) for k in _KEYS] + [six(vl_loss), six(lr)])

    def close(self):
        self.tb.close()


class NullCVLogger:
    """A CVLogger that writes nothing: the logger of a rank other than the
    mesh's first, which alone writes the CSV."""

    def log_epoch(self, *args, **kwargs):
        pass

    def close(self):
        pass


def cv_logger(main: bool, checkpoint_dir: str, **kwargs):
    """`CVLogger(checkpoint_dir, **kwargs)` on the writing rank, else a
    `NullCVLogger`."""
    return CVLogger(checkpoint_dir, **kwargs) if main else NullCVLogger()
