"""k1_roofline.<kind>: K1's (the fused gather and min-max normalisation)
least time for its traced launches, each from its shape (distinct input
volumes read once, the batch written once, or 4 float32 operations a voxel),
over its device time, in %. Nothing when the trace's K1 launches are not
the ones the harness issued."""

import math

from portbench.lib import work
from portbench.lib.trace import kernel_time

KERNEL = "gather_normalize"
INDEX_BYTES = 8  # one int64 row index a row


def read(ctx: dict):
    seconds, launches = kernel_time(ctx, KERNEL)
    calls = ctx.get("k1_launches") or []
    if launches == 0 or launches != len(calls) or seconds <= 0:
        return None
    vox = math.prod(ctx["model"]["shape"])
    least = sum(work.k1_least_s(rows, distinct, vox, src, out, INDEX_BYTES)
                for rows, distinct, src, out in calls)
    return 100.0 * least / seconds
