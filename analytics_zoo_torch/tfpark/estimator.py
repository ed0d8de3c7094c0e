"""TFEstimator: the tf.estimator-style model_fn API (port of the JAX
package's ``tfpark/estimator.py``).

``model_fn(features, labels, mode)`` builds a *native* model (once per
mode) and returns a spec naming the loss criterion and optimizer; the
estimator drives the shared engine.  ModeKeys and the
``train(input_fn, steps)`` surface match the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


class ModeKeys:
    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "infer"


@dataclass
class TFEstimatorSpec:
    """(ref TFEstimatorSpec in estimator.py — loss/train_op/predictions)"""
    mode: str
    predictions: Any = None        # native model producing predictions
    loss: Any = None               # criterion name or Objective
    optim_method: Any = None       # OptimMethod (the train_op analogue)
    metrics: Any = None


class TFEstimator:
    def __init__(self, model_fn: Callable, model_dir: Optional[str] = None):
        self.model_fn = model_fn
        self.model_dir = model_dir
        self._specs = {}

    def _spec(self, mode: str) -> TFEstimatorSpec:
        if mode not in self._specs:
            spec = self.model_fn(features=None, labels=None, mode=mode)
            if not isinstance(spec, TFEstimatorSpec):
                raise TypeError("model_fn must return TFEstimatorSpec")
            self._specs[mode] = spec
        return self._specs[mode]

    @staticmethod
    def _resolve(input_fn, training: bool):
        """input_fn | dataset → (FeatureSet, batch size)."""
        dataset = input_fn() if callable(input_fn) else input_fn
        from analytics_zoo_torch.tfpark.tf_optimizer import (
            _dataset_to_featureset)
        return _dataset_to_featureset(dataset, training=training)

    def train(self, input_fn, steps: Optional[int] = None,
              end_trigger=None, checkpoint_trigger=None):
        """(ref estimator.py train: builds TFOptimizer from the TRAIN
        spec and optimizes for ``steps``)."""
        from analytics_zoo_torch.common.triggers import MaxEpoch, MaxIteration
        from analytics_zoo_torch.pipeline.estimator.estimator import Estimator
        from analytics_zoo_torch.pipeline.api.keras import objectives
        spec = self._spec(ModeKeys.TRAIN)
        fs, batch = self._resolve(input_fn, training=True)
        est = Estimator(spec.predictions, optim_method=spec.optim_method,
                        model_dir=self.model_dir)
        if end_trigger is None:
            end_trigger = MaxIteration(steps) if steps else MaxEpoch(1)
        est.train(fs, objectives.get(spec.loss), end_trigger=end_trigger,
                  checkpoint_trigger=checkpoint_trigger, batch_size=batch)
        self._trained_model = spec.predictions
        return self

    def evaluate(self, input_fn, eval_methods=None, steps=None):
        """Returns {metric_name: value} (ref estimator.py evaluate)."""
        from analytics_zoo_torch.pipeline.estimator.estimator import Estimator
        from analytics_zoo_torch.pipeline.api.keras import objectives
        spec = self._spec(ModeKeys.EVAL)
        model = getattr(self, "_trained_model", None) or spec.predictions
        fs, batch = self._resolve(input_fn, training=False)
        est = Estimator(model)
        return est.evaluate(fs, criterion=objectives.get(spec.loss)
                            if spec.loss else None,
                            validation_method=eval_methods or spec.metrics,
                            batch_size=batch)

    def predict(self, input_fn, predict_keys=None):
        """Yields prediction arrays (ref estimator.py predict)."""
        spec = self._spec(ModeKeys.PREDICT)
        model = getattr(self, "_trained_model", None) or spec.predictions
        fs, batch = self._resolve(input_fn, training=False)
        xs = fs.x if hasattr(fs, "x") else fs
        return model.predict(xs, batch_size=batch)
