"""predict_launch_share: the predictor's host time enqueuing device work
(the program's spans `predict.normalize`, each chunk's K1 launch and its
index handling, and `predict.fold`, each fold's forward, softmax and
accumulation) over its host time from call to answer (`predict.request`),
in %. A launch's span is its enqueue, not the device's work. Host-clock
totals that the program keeps while the profiler records
(`multimodal_ad_tpu_torch/utils/profiling.py::totals`). Nothing outside
serving, or where the program keeps no such totals."""

LAUNCHES = ("predict.normalize", "predict.fold")


def read(ctx: dict):
    if ctx.get("kind") != "serve":
        return None
    try:
        from multimodal_ad_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    if "predict.request" not in spans or any(n not in spans for n in LAUNCHES):
        return None
    request_s = spans["predict.request"][1]
    launch_s = sum(spans[n][1] for n in LAUNCHES)
    return 100.0 * launch_s / request_s if request_s > 0 else None
