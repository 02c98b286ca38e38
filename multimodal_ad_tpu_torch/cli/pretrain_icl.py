"""Meta-train the in-context tabular learner on the synthetic prior and
save its weights as flax msgpack state (port of the TPU package's
cli/pretrain_icl.py; the file loads in both packages). Runs on the card
unless told otherwise.

Usage:
    python -m multimodal_ad_tpu_torch.cli.pretrain_icl --steps 4500 --n-ctx 256 \
        --device-prior --out icl.msgpack [--device cuda|cpu]
    # long-context adaptation phase (warm start from the phase-1 weights):
    python -m multimodal_ad_tpu_torch.cli.pretrain_icl --steps 1200 --n-ctx 512 \
        --lr 1e-4 --resume-from icl.msgpack --out icl.msgpack
    # the bar-distribution regression network (tasks always on the device):
    python -m multimodal_ad_tpu_torch.cli.pretrain_icl --regression --out reg.msgpack

Tasks draw variable valid context lengths, so one run covers context
sizes up to --n-ctx.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n-ctx", type=int, default=128)
    p.add_argument("--n-qry", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--d-model", type=int, default=None,
                   help="override the config's d_model (default config if unset)")
    p.add_argument("--resume-from", default=None,
                   help="warm-start weights (msgpack from a previous phase)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--device-prior", action="store_true",
                   help="sample tasks on the device (icl_prior), --chunk steps "
                        "between reads of the loss; the default streams one "
                        "host-sampled task a step")
    p.add_argument("--chunk", type=int, default=100,
                   help="meta-steps between loss reads with --device-prior")
    p.add_argument("--regression", action="store_true",
                   help="meta-train the bar-distribution REGRESSION network "
                        "instead of the classifier; tasks always on the device")
    p.add_argument("--mix", default=None,
                   help="comma-separated 5 family weights (cluster,correlated,"
                        "pairwise,periodic,mlp) overriding the prior's mixture "
                        "(classifier only)")
    p.add_argument("--aux-embed", type=float, default=0.0,
                   help="weight of the supervised-contrastive loss on query "
                        "states (classifier only)")
    p.add_argument("--aux-tau", type=float, default=0.2,
                   help="temperature of the contrastive losses")
    p.add_argument("--aux-qc", type=float, default=0.0,
                   help="weight of the query->context contrastive loss "
                        "(classifier only)")
    p.add_argument("--cat-input", action="store_true",
                   help="train with the categorical pathway (cat_input=True; "
                        "classifier only)")
    p.add_argument("--save-dtype", default="float32", choices=["float32", "float16"],
                   help="weight dtype in the saved msgpack (loaders upcast)")
    p.add_argument("--out", required=True)
    return p


def main(argv=None):
    from ..tabular.flax_msgpack import tree_leaves, write_state

    args = build_parser().parse_args(argv)
    if args.regression:
        from ..tabular.icl_regression import (RegICLConfig, _load_reg_params_file,
                                              pretrain_icl_regression)

        cfg = RegICLConfig() if args.d_model is None else RegICLConfig(d_model=args.d_model)
        init_params = None
        if args.resume_from:
            # strict: every leaf present with its shape
            init_params = _load_reg_params_file(cfg, args.resume_from)
            print(f"warm start from {args.resume_from}")
        params, _ = pretrain_icl_regression(
            cfg, steps=args.steps, batch=args.batch, n_ctx=args.n_ctx, n_qry=args.n_qry,
            lr=args.lr, seed=args.seed, verbose=True, init_params=init_params,
            chunk=args.chunk, device=args.device)
    else:
        from ..tabular.icl import (ICLConfig, init_icl_params, merge_compatible_params,
                                   pretrain_icl)

        kw = {} if args.d_model is None else {"d_model": args.d_model}
        if args.cat_input:
            kw["cat_input"] = True
        cfg = ICLConfig(**kw)
        init_params = None
        if args.resume_from:
            # key intersection: tolerates architecture revisions
            init_params = merge_compatible_params(init_icl_params(cfg, 0), args.resume_from,
                                                  verbose=True)
            print(f"warm start from {args.resume_from}")
        mix = None if args.mix is None else tuple(float(w) for w in args.mix.split(","))
        params, _ = pretrain_icl(
            cfg, steps=args.steps, batch=args.batch, n_ctx=args.n_ctx, n_qry=args.n_qry,
            lr=args.lr, seed=args.seed, verbose=True, init_params=init_params,
            device_prior=args.device_prior, chunk=args.chunk, mix=mix,
            aux_embed=args.aux_embed, aux_tau=args.aux_tau, aux_qc=args.aux_qc,
            device=args.device)
    if args.save_dtype == "float16":
        params = _cast(params, np.float16)
    n = write_state(args.out, params)
    print(f"saved {n / 1e6:.2f} MB -> {args.out} ({len(tree_leaves(params))} leaves)")
    return params


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return np.asarray(tree, dtype)


if __name__ == "__main__":
    main()
