"""Paired significance test between two models' per-fold metrics (port of
the TPU package's cli/pvalue.py; prints the same lines). Runs on the host.

Mirrors `python utils/p-value.py` (reference utils/p-value.py:46-61).

Usage:
    python -m multimodal_ad_tpu_torch.cli.pvalue --a 0.91 0.88 0.92 --b 0.98 0.97 0.98
"""

from __future__ import annotations

import argparse

from ..eval.stats import compute_p_values


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--a", nargs="+", type=float, required=True,
                   help="per-fold metrics, model A")
    p.add_argument("--b", nargs="+", type=float, required=True,
                   help="per-fold metrics, model B")
    args = p.parse_args(argv)
    out = compute_p_values(args.a, args.b)
    print(f"paired t-test:  t={out['t_stat']:.4f}  p={out['t_p']:.6f}")
    print(f"wilcoxon:       W={out['wilcoxon_stat']:.4f}  p={out['wilcoxon_p']:.6f}")
    return out


if __name__ == "__main__":
    main()
