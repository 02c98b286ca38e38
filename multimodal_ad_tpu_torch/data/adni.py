"""ADNI manifest: label CSV -> list of sample records (port of the TPU
package's data/adni.py).

- label CSV read with ISO-8859-1 encoding,
- task -> group list mapping with enumerate-order label ids (ADCN gives
  AD=0, CN=1),
- records of {'MRI': mri_dir/<Subject_ID>.nii, 'label': int, 'Subject': id}.

The CSV is read with the csv module rather than pandas; subject ids stay
the strings written in the file.
"""

from __future__ import annotations

import csv
import os
from collections import Counter

TASK_GROUPS = {
    "ADCN": ["AD", "CN"],
    "CNEMCI": ["CN", "EMCI"],
    "LMCIAD": ["LMCI", "AD"],
    "EMCILMCI": ["EMCI", "LMCI"],
    "SMCIPMCI": ["SMCI", "PMCI"],
    "ADCNSMCIPMCI": ["CN", "SMCI", "PMCI", "AD"],
}


class ADNIManifest:
    """Task-filtered list of ADNI samples (paths + integer labels)."""

    def __init__(self, label_file: str, mri_dir: str, task: str = "ADCN",
                 augment: bool = False, pet_dir: str | None = None,
                 verbose: bool = True):
        self.label_file = label_file
        self.mri_dir = mri_dir
        self.pet_dir = pet_dir
        self.task = task
        self.augment = augment

        t = task.upper()
        if t not in TASK_GROUPS:
            raise ValueError(f"Unsupported task: {task}")
        groups = TASK_GROUPS[t]
        self.label_dict = {g: i for i, g in enumerate(groups)}

        with open(label_file, newline="", encoding="ISO-8859-1") as f:
            rows = [r for r in csv.DictReader(f) if r["Group"] in groups]
        self.data_dict = []
        for r in rows:
            subject = r["Subject_ID"]
            rec = {
                "MRI": os.path.join(mri_dir, f"{subject}.nii"),
                "label": self.label_dict[r["Group"]],
                "Subject": subject,
            }
            if pet_dir is not None:
                rec["PET"] = os.path.join(pet_dir, f"{subject}.nii")
            self.data_dict.append(rec)

        if verbose:
            self._print_class_counts()

    @property
    def labels(self):
        return [d["label"] for d in self.data_dict]

    def _print_class_counts(self):
        inv = {v: k for k, v in self.label_dict.items()}
        cnt = Counter(self.labels)
        print(f"\n[ADNI Dataset: {self.task}] class counts:")
        for lbl, num in cnt.items():
            print(f"  {inv[lbl]} ({lbl}): {num}")
        print()

    def __len__(self):
        return len(self.data_dict)

    def __getitem__(self, idx):
        return self.data_dict[idx]
