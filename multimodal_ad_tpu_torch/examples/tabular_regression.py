"""Example: in-context tabular regression with bar-distribution decoding.

The TabPFNRegressor-equivalent surface: fit stores the context, predict
decodes the bar distribution as mean / median / quantiles, with no
gradients at inference.

Run:  python -m multimodal_ad_tpu_torch.examples.tabular_regression [--device cpu]
"""

import numpy as np

from ..tabular import ICLRegressor, RegICLConfig, pretrain_icl_regression
from . import device_arg


def main(device="cuda"):
    # a tiny network meta-trained on the fly so the example runs anywhere;
    # real use relies on the bundled asset (assets/icl_regression_default)
    cfg = RegICLConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                       max_features=16, max_context=128, n_bins=16)
    params, _ = pretrain_icl_regression(cfg, steps=300, batch=16, n_ctx=64,
                                        n_qry=16, seed=0, device=device)

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 5)).astype(np.float32)
    w = rng.normal(size=5)
    y = X @ w + 0.1 * rng.normal(size=200)

    reg = ICLRegressor(params=params, cfg=cfg, device=device)
    reg.fit(X[:140], y[:140])
    pred = reg.predict(X[140:])
    mse = float(np.mean((pred - y[140:]) ** 2))
    base = float(np.mean((y[:140].mean() - y[140:]) ** 2))
    print(f"selected preprocess: {reg.preprocess_}")
    print(f"mse {mse:.3f} vs mean-baseline {base:.3f}")

    q10, q50, q90 = reg.predict(X[140:145], output_type="quantiles",
                                quantiles=[0.1, 0.5, 0.9])
    for i in range(5):
        print(f"row {i}: q10={q10[i]:+.2f} median={q50[i]:+.2f} "
              f"q90={q90[i]:+.2f} true={y[140 + i]:+.2f}")
    assert mse < base
    return {"mse": mse, "baseline": base}


if __name__ == "__main__":
    main(device_arg(__doc__))
