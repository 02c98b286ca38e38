"""predict_pad_share: the share of the rows the predictor forwards that
repeat a row as padding of a ragged last chunk (the program's counters
`predict.rows_padded` and `predict.rows_real`), in %. Counted by the
program while the profiler records
(`multimodal_ad_tpu_torch/utils/profiling.py::totals`). Nothing outside
serving, or where the program keeps no such counters."""


def read(ctx: dict):
    if ctx.get("kind") != "serve":
        return None
    try:
        from multimodal_ad_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    counters = totals()["counters"]
    if "predict.rows_real" not in counters or "predict.rows_padded" not in counters:
        return None
    padded = counters["predict.rows_padded"]
    rows = counters["predict.rows_real"] + padded
    return 100.0 * padded / rows if rows > 0 else None
