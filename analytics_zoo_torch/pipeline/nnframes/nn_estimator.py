"""NNFrames: ML-pipeline estimators over DataFrames (port of
``pipeline/nnframes/nn_estimator.py``).

Reference: zoo/pipeline/nnframes/NNEstimator.scala:198 — a Spark ML
``Estimator`` whose ``fit`` runs the distributed optimizer on
DataFrame columns through ``Preprocessing`` converters, returning an
``NNModel`` transformer that appends a prediction column; NNClassifier
(NNClassifier.scala) is the classification sugar.

The frame is duck-typed as the reference reads it: ``df[col]`` with
``.iloc[0]``, iteration and ``.to_numpy()``, ``df.columns``, ``df.copy()``
and item assignment, so a pandas DataFrame serves and pandas is never
imported here.  ``fit`` lowers to the port's ``Estimator``.  The
param-setter surface (setBatchSize, setMaxEpoch, setLearningRate,
setCachingSample...) is the reference's.  ``save`` pickles the model
with its variables as CPU tensors, so a saved estimator or model loads
on a machine without a card; the live model keeps its device tensors.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from analytics_zoo_torch.common.triggers import EveryEpoch, MaxEpoch
from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.feature.feature_set import FeatureSet
from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
from analytics_zoo_torch.pipeline.estimator import Estimator


def _save_model_pickle(path: str, model, meta: dict, payload: dict) -> None:
    """Pickle ``payload`` (which holds ``model``) with the model's
    variables as CPU tensors and without its attributes that do not
    pickle (the captured inference programs, rebuilt on demand); the
    model's own variables are put back afterwards."""
    variables = model.get_variables()
    model.set_variables(tree_map(
        lambda a: a.detach().cpu() if isinstance(a, torch.Tensor) else a,
        variables))
    try:
        for k in list(vars(model)):
            try:
                pickle.dumps(vars(model)[k])
            except Exception:
                delattr(model, k)
        _save_pickle(path, meta, payload)
    finally:
        model.set_variables(variables)


def _save_pickle(path: str, meta: dict, payload: dict) -> None:
    """ML-persistence layout (ref NNEstimator.scala:808 write): a
    directory with human-readable metadata.json + payload.pkl."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(path, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)


def _load_pickle(path: str) -> tuple:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    return meta, payload


def _col_to_array(series) -> np.ndarray:
    first = series.iloc[0]
    if isinstance(first, (list, tuple, np.ndarray)):
        return np.stack([np.asarray(v, np.float32) for v in series])
    return series.to_numpy()


def _coerce_features(x, preprocessing):
    """Apply the feature preprocessing and coerce to model input(s).
    A preprocessing may split the feature column into a LIST of model
    inputs (multi-input models, e.g. WideAndDeep's [wide_indices,
    embed_ids, continuous]) — shared by the fit and transform paths so
    their coercion can never diverge."""
    if preprocessing is not None:
        x = preprocessing(x)
    if isinstance(x, (list, tuple)):
        return [np.asarray(a, np.float32) for a in x]
    return np.asarray(x, np.float32)


class NNEstimator:
    def __init__(self, model, criterion,
                 feature_preprocessing: Optional[Preprocessing] = None,
                 label_preprocessing: Optional[Preprocessing] = None):
        self.model = model
        self.criterion = criterion
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.features_col = "features"
        self.label_col = "label"
        self.batch_size = 32
        self.max_epoch = 10
        self.optim_method = None
        self.learning_rate = 1e-3
        self.caching_sample = True
        self.checkpoint_path = None
        self.validation = None          # (trigger, df, methods, batch)
        self._clip = None
        self._tb = None
        self.fitted_estimator = None    # set by fit(); per-epoch history

    # ----------------------------------------------- Spark-ML-style setters
    def set_features_col(self, name):
        self.features_col = name
        return self

    setFeaturesCol = set_features_col

    def set_label_col(self, name):
        self.label_col = name
        return self

    setLabelCol = set_label_col

    def set_batch_size(self, bs):
        self.batch_size = int(bs)
        return self

    setBatchSize = set_batch_size

    def set_max_epoch(self, n):
        self.max_epoch = int(n)
        return self

    setMaxEpoch = set_max_epoch

    def set_learning_rate(self, lr):
        self.learning_rate = float(lr)
        return self

    setLearningRate = set_learning_rate

    def set_optim_method(self, method):
        self.optim_method = method
        return self

    setOptimMethod = set_optim_method

    def set_caching_sample(self, flag):
        self.caching_sample = bool(flag)
        return self

    setCachingSample = set_caching_sample

    def set_checkpoint(self, path):
        self.checkpoint_path = path
        return self

    def set_validation(self, trigger, df, methods, batch_size):
        self.validation = (trigger, df, methods, batch_size)
        return self

    setValidation = set_validation

    def set_constant_gradient_clipping(self, lo, hi):
        self._clip = ("const", lo, hi)
        return self

    def set_gradient_clipping_by_l2_norm(self, v):
        self._clip = ("l2", v)
        return self

    def set_tensorboard(self, log_dir, app_name):
        self._tb = (log_dir, app_name)
        return self

    # ------------------------------------------------------------------ fit
    def _extract(self, df, with_label: bool = True):
        x = _coerce_features(
            _col_to_array(df[self.features_col]),
            self.feature_preprocessing)
        y = None
        if with_label and self.label_col in df.columns:
            y = _col_to_array(df[self.label_col])
            if self.label_preprocessing is not None:
                y = self.label_preprocessing(y)
            y = np.asarray(y)
            if y.ndim == 1:
                y = y[:, None]
        return x, y

    def fit(self, df) -> "NNModel":
        from analytics_zoo_torch.pipeline.api.keras import optimizers as O
        x, y = self._extract(df)
        train = FeatureSet.from_ndarrays(x, y)
        optim = self.optim_method or O.Adam(lr=self.learning_rate)
        est = Estimator(self.model, optim_method=optim,
                        model_dir=self.checkpoint_path)
        if self._clip is not None:
            if self._clip[0] == "const":
                est.set_constant_gradient_clipping(*self._clip[1:])
            else:
                est.set_l2_norm_gradient_clipping(self._clip[1])
        if self._tb is not None:
            est.set_tensorboard(*self._tb)
        val_set = val_methods = None
        if self.validation is not None:
            _, vdf, val_methods, _vb = self.validation
            vx, vy = self._extract(vdf)
            val_set = FeatureSet.from_ndarrays(vx, vy, shuffle=False)
        est.train(train, self.criterion,
                  end_trigger=MaxEpoch(self.max_epoch),
                  checkpoint_trigger=EveryEpoch(),
                  validation_set=val_set, validation_method=val_methods,
                  batch_size=self.batch_size)
        # the trained Estimator (per-epoch history, summaries) stays
        # inspectable, like the Spark-ML model keeping its training
        # summary
        self.fitted_estimator = est
        return self._make_model()

    def _make_model(self) -> "NNModel":
        return NNModel(self.model,
                       feature_preprocessing=self.feature_preprocessing) \
            .set_features_col(self.features_col) \
            .set_batch_size(self.batch_size)

    # -------------------------------------------- ML persistence
    def save(self, path: str) -> None:
        """Persist the (possibly fitted) estimator: model architecture
        + current variables + preprocessing + params
        (ref NNEstimator.scala:808 NNEstimatorWriter)."""
        _save_model_pickle(path, self.model, {
            "class": type(self).__name__,
            "features_col": self.features_col,
            "label_col": self.label_col,
            "batch_size": self.batch_size,
            "max_epoch": self.max_epoch,
            "learning_rate": self.learning_rate,
        }, {
            "model": self.model,
            "criterion": self.criterion,
            "feature_preprocessing": self.feature_preprocessing,
            "label_preprocessing": self.label_preprocessing,
            "optim_method": self.optim_method,
            "clip": self._clip,
            "caching_sample": self.caching_sample,
            "checkpoint_path": self.checkpoint_path,
        })

    @classmethod
    def load(cls, path: str) -> "NNEstimator":
        meta, payload = _load_pickle(path)
        klass = {"NNEstimator": NNEstimator,
                 "NNClassifier": NNClassifier}.get(meta["class"], cls)
        est = klass(payload["model"], payload["criterion"],
                    feature_preprocessing=payload["feature_preprocessing"],
                    label_preprocessing=payload["label_preprocessing"])
        est.features_col = meta["features_col"]
        est.label_col = meta["label_col"]
        est.batch_size = meta["batch_size"]
        est.max_epoch = meta["max_epoch"]
        est.learning_rate = meta["learning_rate"]
        est.optim_method = payload.get("optim_method")
        est._clip = payload.get("clip")
        est.caching_sample = payload.get("caching_sample", True)
        est.checkpoint_path = payload.get("checkpoint_path")
        return est


class NNModel:
    """Transformer: append a ``prediction`` column
    (NNEstimator.scala:635)."""

    def __init__(self, model, feature_preprocessing=None):
        self.model = model
        self.feature_preprocessing = feature_preprocessing
        self.features_col = "features"
        self.prediction_col = "prediction"
        self.batch_size = 256

    def set_features_col(self, name):
        self.features_col = name
        return self

    setFeaturesCol = set_features_col

    def set_prediction_col(self, name):
        self.prediction_col = name
        return self

    setPredictionCol = set_prediction_col

    def set_batch_size(self, bs):
        self.batch_size = int(bs)
        return self

    setBatchSize = set_batch_size

    def _extract_features(self, df):
        return _coerce_features(_col_to_array(df[self.features_col]),
                                self.feature_preprocessing)

    def transform(self, df):
        out = np.asarray(self.model.predict(
            self._extract_features(df), batch_size=self.batch_size))
        result = df.copy()
        result[self.prediction_col] = list(out)
        return result

    # -------------------------------------------- ML persistence
    def save(self, path: str) -> None:
        """Persist the transformer: trained variables + preprocessing +
        column config (ref NNEstimator.scala:865 NNModelWriter)."""
        _save_model_pickle(path, self.model, {
            "class": type(self).__name__,
            "features_col": self.features_col,
            "prediction_col": self.prediction_col,
            "batch_size": self.batch_size,
        }, {
            "model": self.model,
            "feature_preprocessing": self.feature_preprocessing,
        })

    @classmethod
    def load(cls, path: str) -> "NNModel":
        meta, payload = _load_pickle(path)
        klass = {"NNModel": NNModel,
                 "NNClassifierModel": NNClassifierModel}.get(
                     meta["class"], cls)
        m = klass(payload["model"],
                  feature_preprocessing=payload["feature_preprocessing"])
        m.features_col = meta["features_col"]
        m.prediction_col = meta["prediction_col"]
        m.batch_size = meta["batch_size"]
        return m


class NNClassifier(NNEstimator):
    """Label column is a class index; prediction is argmax
    (NNClassifier.scala)."""

    def fit(self, df) -> "NNClassifierModel":
        base = super().fit(df)
        return NNClassifierModel(
            base.model, feature_preprocessing=self.feature_preprocessing
        ).set_features_col(self.features_col) \
            .set_batch_size(self.batch_size)


class NNClassifierModel(NNModel):
    def transform(self, df):
        out = np.asarray(self.model.predict(
            self._extract_features(df), batch_size=self.batch_size))
        result = df.copy()
        result[self.prediction_col] = np.argmax(out, axis=-1).astype(
            np.int64)
        return result
