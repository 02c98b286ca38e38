"""train_mfu: the least time at the card's published bf16 peak of the
traced epochs' work (each training row's forward and two backward products,
without the stem's input gradient, and each validation row's forward, the
products as the model family counts them), over the traced window, in %."""

from portbench.lib import family, work


def read(ctx: dict):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0 or not ctx.get("volumes_trained"):
        return None
    m = ctx["model"]
    ops = family.load(m["type"]).forward_ops(m)
    least = (ctx["volumes_trained"] * work.least_train_s(ops)
             + ctx["volumes_evaluated"] * work.least_forward_s(ops))
    return 100.0 * least / ctx["window_s"]
