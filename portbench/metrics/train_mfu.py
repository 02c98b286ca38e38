"""train_mfu: the least time at the card's published bf16 peak of the
traced epochs' work (each training row's forward and two backward products,
without the stem's input gradient, and each validation row's forward), over
the traced window, in %."""

from portbench.lib import work


def read(ctx: dict):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0 or not ctx.get("volumes_trained"):
        return None
    m = ctx["model"]
    ops = work.forward_ops(m["depth"], m["shape"], m["in_channels"], m["num_classes"])
    least = (ctx["volumes_trained"] * work.least_train_s(ops)
             + ctx["volumes_evaluated"] * work.least_forward_s(ops))
    return 100.0 * least / ctx["window_s"]
