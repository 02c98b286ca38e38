"""serve_mfu: the least time the served volumes' forwards need at the
card's published peaks (every fold's products as the model family counts
them, `forward_ops`: for the ResNet its convolutions and Linear, taps in
the padding left out, the plain 7^3 stem; each product at the peak of the
type it runs in: an int8 model's block convolutions int8, its head
float32), over the traced requests' time from call to answer, in %."""

from portbench.lib import family, work


def read(ctx: dict):
    if ctx["kind"] != "serve" or ctx["request_s"] <= 0 or not ctx.get("volumes_forward"):
        return None
    m = ctx["model"]
    ops = family.load(m["type"]).forward_ops(m)
    int8 = ctx["precision"] == "int8"
    least = work.least_forward_s(ops, "int8" if int8 else "bf16", "f32" if int8 else "bf16")
    return 100.0 * ctx["volumes_forward"] * least / ctx["request_s"]
