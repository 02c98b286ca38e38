"""predict_fetch_share: the predictor's host time blocked on the device
(the program's span `predict.fetch`: each chunk's `.cpu()` of its answer,
which waits until the chunk's folds are done, and the small copy back)
over its host time from call to answer (`predict.request`), in %. A
host-side gain can raise it: the device then sets the pace. Host-clock
totals that the program keeps while the profiler records
(`multimodal_ad_tpu_torch/utils/profiling.py::totals`). Nothing outside
serving, or where the program keeps no such totals."""


def read(ctx: dict):
    if ctx.get("kind") != "serve":
        return None
    try:
        from multimodal_ad_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    if "predict.request" not in spans or "predict.fetch" not in spans:
        return None
    request_s = spans["predict.request"][1]
    return 100.0 * spans["predict.fetch"][1] / request_s if request_s > 0 else None
