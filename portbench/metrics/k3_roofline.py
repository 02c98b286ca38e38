"""k3_roofline: K3's (the int8 convolution with its fused epilogue) least
time for its traced launches, each from its shape (operations of the taps
inside the volume at the int8 peak, or the input voxels read, weights,
epilogue vectors and outputs at HBM's rate), over its device time, in %.
The launches are the int8 ResNet's (its family's `k3_launches`, by depth):
the one family the port serves in int8. Nothing when the cell serves no
int8 model, or when the trace's K3 launches are not the forwards the
harness issued."""

from portbench.lib import family, work
from portbench.lib.trace import kernel_time

KERNEL = "conv_i8_kernel"


def read(ctx: dict):
    if ctx.get("precision") != "int8":
        return None
    seconds, launches = kernel_time(ctx, KERNEL)
    m = ctx["model"]
    per_forward = family.load(m["type"]).k3_launches(m["depth"], m["shape"], ctx["batch"])
    if seconds <= 0 or launches != ctx["forwards"] * len(per_forward):
        return None
    least = sum(work.k3_least_s(*launch) for launch in per_forward)
    return 100.0 * ctx["forwards"] * least / seconds
