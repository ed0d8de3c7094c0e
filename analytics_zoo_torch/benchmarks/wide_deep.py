"""Wide&Deep Census training benchmark via the NNFrames estimator (port
of the JAX package's ``benchmarks/wide_deep.py``; BASELINE.md config 2:
"Wide&Deep on Census/Criteo via the NNFrames-equivalent estimator";
reference model models/recommendation/WideAndDeep.scala:101, estimator
path pipeline/nnframes/NNEstimator.scala:198).

The measured path is the USER path: a pandas DataFrame with a packed
``features`` column → ``SplitColumns`` preprocessing → multi-input
WideAndDeep → ``NNClassifier.fit``.  Throughput comes from the fitted
estimator's per-epoch history with the first epoch excluded (it pays the
kernel builds and the CUDA-graph captures); the headline is the median
steady-state epoch.
"""

from __future__ import annotations

import time


def census_wide_deep(rows: int):
    """The bench's seeded census-like columns (numpy seed 0) and its
    WideAndDeep: returns the model, the packed float32 feature rows, the
    per-input column sizes ``SplitColumns`` takes, and the labels."""
    import numpy as np

    from analytics_zoo_torch.models.recommendation import (
        ColumnFeatureInfo, WideAndDeep)

    info = ColumnFeatureInfo(
        wide_base_cols=["gender", "age_bucket", "education"],
        wide_base_dims=[3, 10, 16],
        wide_cross_cols=["gender_age", "edu_age"],
        wide_cross_dims=[30, 160],
        embed_cols=["occupation", "relationship"],
        embed_in_dims=[48, 8], embed_out_dims=[16, 8],
        continuous_cols=["hours_per_week", "capital_gain"])

    rs = np.random.RandomState(0)
    gender = rs.randint(0, 3, rows)
    age = rs.randint(0, 10, rows)
    edu = rs.randint(0, 16, rows)
    occ = rs.randint(0, 48, rows)
    rel = rs.randint(0, 8, rows)
    hours = rs.rand(rows).astype(np.float32)
    gain = rs.rand(rows).astype(np.float32)
    cols = {"gender": gender, "age_bucket": age, "education": edu,
            "gender_age": gender * 10 + age, "edu_age": edu * 10 + age,
            "occupation": occ, "relationship": rel,
            "hours_per_week": hours, "capital_gain": gain}
    logit = (((gender == 1) & (age >= 5)) * 1.2
             + np.sin(occ / 48 * np.pi) + hours + gain - 1.8)
    label = (logit + 0.3 * rs.randn(rows) > 0).astype(np.int64)

    model = WideAndDeep(2, info, model_type="wide_n_deep",
                        hidden_layers=(64, 32, 16))
    feats = model.features_from_columns(cols)
    sizes = [f.shape[1] for f in feats]
    packed = np.concatenate(
        [f.astype(np.float32) for f in feats], axis=1)
    return model, packed, sizes, label


def run_wide_deep_bench(device, rows: int = 1 << 19,
                        batch_size: int = 8192, timed_epochs: int = 3,
                        warm_epochs: int = 1):
    import numpy as np
    import pandas as pd

    from analytics_zoo_torch.feature.common import SplitColumns
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.nnframes import NNClassifier
    from analytics_zoo_torch.benchmarks.inception import device_kind

    kind = device_kind(device)
    model, packed, sizes, label = census_wide_deep(rows)
    df = pd.DataFrame({"features": list(packed), "label": label})

    clf = (NNClassifier(model.model,
                        "sparse_categorical_crossentropy_with_logits",
                        feature_preprocessing=SplitColumns(sizes))
           .set_batch_size(batch_size)
           .set_max_epoch(warm_epochs + timed_epochs)
           .set_optim_method(Adam(lr=1e-3)))
    t0 = time.time()
    nn_model = clf.fit(df)
    fit_wall = time.time() - t0

    steps_per_epoch = rows // batch_size
    epoch_samples = steps_per_epoch * batch_size
    # per-epoch history; epoch 1 pays the builds and captures — exclude it
    history = clf.fitted_estimator.history
    steady = sorted(r["throughput"] for r in history[warm_epochs:])
    tput = steady[len(steady) // 2]

    # the Transformer half: one batched inference pass over the frame
    t0 = time.time()
    out = nn_model.transform(df)
    infer_wall = time.time() - t0
    acc = float(np.mean(out["prediction"].to_numpy() == label))

    return {
        "metric": "wide_deep_census_train_throughput",
        "value": round(tput, 1),
        "unit": "samples/sec/chip",
        "vs_baseline": None,
        "workload": "wide_deep",
        "rows": rows,
        "batch_size": batch_size,
        "timed_epochs": timed_epochs,
        "epoch_time_s": round(epoch_samples / tput, 3),
        "fit_wall_s": round(fit_wall, 2),
        "epoch_throughputs": [round(r["throughput"], 1)
                              for r in history],
        "transform_rps": round(rows / infer_wall, 1),
        "train_accuracy": round(acc, 4),
        "device": str(device),
        "device_kind": kind,
    }
