"""Generate tabular in-context embeddings + quick downstream eval.

Mirrors the TPU package's cli.tabular_embed (the reference's
`python tabel_test.py`, with the class name "SMCI", not "SCMI"): one
ICLClassifier embeds the table through the K-fold out-of-fold harness on
`--device`, and the CSVs are written; then a linear SVM scores them. The
SVM needs sklearn, which is host-only: on a machine without it the command
raises ImportError after the CSVs are written.

Usage:
    python -m multimodal_ad_tpu_torch.cli.tabular_embed --table ADNI_Tabel.csv \\
        --classes CN SMCI PMCI AD --n-fold 5 --test-size 0.2 --device cuda
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--table", required=True, help="clinical CSV")
    p.add_argument("--label-col", default="GROUP")
    p.add_argument("--classes", nargs="+", default=["CN", "SMCI", "PMCI", "AD"])
    p.add_argument("--start-col", type=int, default=14)
    p.add_argument("--n-fold", type=int, default=5)
    p.add_argument("--test-size", type=float, default=0.2)
    p.add_argument("--train-out", default="train_embeddings.csv")
    p.add_argument("--test-out", default="test_embeddings.csv")
    p.add_argument("--pretrain-steps", type=int, default=2000,
                   help="in-context learner meta-training steps (kept for the "
                        "TPU package's interface; the bundled asset applies)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..core.device import resolve_device
    from ..tabular.icl import ICLClassifier
    from ..tabular.pipeline import quick_eval_from_saved, tabel_encoder_multi

    resolve_device(args.device)  # no card: raise before any work
    print("embeddings.......")
    clf = ICLClassifier(pretrain_steps=args.pretrain_steps, device=args.device)
    tabel_encoder_multi(args.table, start_col=args.start_col,
                        label_col=args.label_col, classes=args.classes,
                        n_fold=args.n_fold, test_size=args.test_size,
                        train_out=args.train_out, test_out=args.test_out,
                        embedder=clf)
    print("test model......")
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"the quick eval (a linear SVM on {args.train_out} / {args.test_out}, "
            "written) needs sklearn, which this machine lacks: run "
            "tabular.pipeline.quick_eval_from_saved on a host that has it") from e
    return quick_eval_from_saved(args.train_out, args.test_out)


if __name__ == "__main__":
    main()
