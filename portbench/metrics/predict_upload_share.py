"""predict_upload_share: the predictor's host time staging its uploads
(the program's span `predict.upload`: each chunk's `ascontiguousarray`,
`from_numpy` and blocking pageable `.to(device)`) over its host time from
call to answer (`predict.request`), in %. Both are host-clock totals that
the program keeps while the profiler records
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
    if "predict.request" not in spans or "predict.upload" not in spans:
        return None
    request_s = spans["predict.request"][1]
    return 100.0 * spans["predict.upload"][1] / request_s if request_s > 0 else None
