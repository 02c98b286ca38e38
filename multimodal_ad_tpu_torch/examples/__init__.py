"""The TPU package's examples over the port's API (examples/*.py there).

Each module's ``main(device="cuda")`` runs end to end and returns its
result; ``python -m multimodal_ad_tpu_torch.examples.<name> [--device cpu]``
runs one. `train_tiny_cv`, `roi_features`, `serve_int8`,
`tabular_embeddings`, `tabular_regression` and `fusion_real_table` (which,
like the TPU package's, falls back to a synthetic clinical table when the
reference's ADNI_Tabel.csv is absent).
"""

import argparse

EXAMPLES = ("train_tiny_cv", "roi_features", "serve_int8", "tabular_embeddings",
            "tabular_regression", "fusion_real_table")


def device_arg(description: str) -> str:
    """The --device of an example's command line (default cuda)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args().device
