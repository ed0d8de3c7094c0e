"""TFOptimizer: the TFPark training driver (port of the JAX package's
``tfpark/tf_optimizer.py``).

``from_keras`` converts the tf.keras model to native layers
(``converter.py``), ``from_loss`` takes a native model and criterion
directly, and ``from_train_op`` recognizes a canonical TF1
``minimize``/``apply_gradients`` graph (``tf1_graph.py``; it needs
TensorFlow) and refuses anything else; ``optimize`` drives the same
Estimator the Keras API uses.
"""

from __future__ import annotations

from typing import Optional

from analytics_zoo_torch.common.triggers import MaxEpoch, Trigger
from analytics_zoo_torch.pipeline.estimator.estimator import Estimator


class TFOptimizer:
    def __init__(self, model, criterion, optim_method, train_set,
                 batch_size: int = 32, val_set=None, val_methods=None,
                 model_dir: Optional[str] = None):
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method
        self.train_set = train_set
        self.batch_size = batch_size
        self.val_set = val_set
        if val_set is not None and not val_methods:
            # default to tracking validation loss (Model.fit does the same)
            from analytics_zoo_torch.pipeline.api.keras.metrics import Loss
            from analytics_zoo_torch.pipeline.api.keras import objectives
            val_methods = [Loss(objectives.get(criterion))]
        self.val_methods = val_methods
        self.model_dir = model_dir
        self.estimator = Estimator(model, optim_method=optim_method,
                                   model_dir=model_dir)

    # ------------------------------------------------------------ factories
    @classmethod
    def from_keras(cls, keras_model, dataset, optim_method=None,
                   model_dir: Optional[str] = None, **kwargs
                   ) -> "TFOptimizer":
        """tf.keras model (compiled) + TFDataset → TFOptimizer.

        (ref tf_optimizer.py:537: exports loss graph from the compiled
        keras model; here the model converts to native layers and the
        compiled loss/optimizer map to zoo equivalents.)
        """
        from analytics_zoo_torch.tfpark.model import KerasModel
        if not isinstance(keras_model, KerasModel):
            keras_model = KerasModel(keras_model)
        zoo_model = keras_model.model
        assert zoo_model.loss is not None, \
            "compile() the keras model first (loss is required)"
        from analytics_zoo_torch.pipeline.api.keras import objectives
        criterion = objectives.get(zoo_model.loss)
        optim = optim_method or zoo_model.optim_method
        fs, batch = _dataset_to_featureset(dataset, training=True)
        return cls(zoo_model, criterion, optim, fs, batch_size=batch,
                   val_set=getattr(dataset, "val_set", None),
                   model_dir=model_dir, **kwargs)

    @classmethod
    def from_loss(cls, model, criterion, dataset, optim_method=None,
                  model_dir: Optional[str] = None, **kwargs
                  ) -> "TFOptimizer":
        """Native model + criterion (objective name or callable) +
        TFDataset → TFOptimizer (ref tf_optimizer.py:467, where 'loss'
        is a TF scalar tensor; the functional equivalent is the
        criterion applied to the model's output)."""
        from analytics_zoo_torch.pipeline.api.keras import (objectives,
                                                          optimizers)
        criterion = objectives.get(criterion)
        optim = optimizers.get(optim_method) if optim_method else None
        fs, batch = _dataset_to_featureset(dataset, training=True)
        return cls(model, criterion, optim, fs, batch_size=batch,
                   val_set=getattr(dataset, "val_set", None),
                   model_dir=model_dir, **kwargs)

    @classmethod
    def from_train_op(cls, train_op, loss, sess=None, dataset=None,
                      metrics=None, updates=None, tensor_with_value=None,
                      model_dir: Optional[str] = None, **kwargs
                      ) -> "TFOptimizer":
        """TF1 ``train_op`` + loss tensor → TFOptimizer, for the
        CANONICAL ``Optimizer.minimize``/``apply_gradients`` graph
        shapes only (ref tf_optimizer.py:430).

        The reference keeps the in-graph update op alive
        (TFTrainingHelperV2 + FakeOptimMethod); there is no TF session
        in this runtime's hot loop, so instead the graph is RECOGNIZED:
        the ``Apply*`` training ops map onto the native OptimMethod
        with the same update rule and hyperparameters, the loss head
        (reduce_mean over softmax-CE / sparse-softmax-CE /
        squared_difference) maps onto the matching objective, and the
        logits subgraph recompiles op-by-op to PyTorch ops
        (tf1_graph.py).  Anything outside those shapes raises with the
        offending op named — substituting different update semantics
        silently is exactly what this entry point must never do.  For
        exotic graphs, migrate to ``from_loss`` (explicit optimizer)."""
        if updates is not None or tensor_with_value is not None:
            raise NotImplementedError(
                "from_train_op: 'updates' / 'tensor_with_value' carry "
                "in-graph side effects that do not survive "
                "recompilation; migrate them into the model or "
                "from_loss")
        if metrics is not None:
            raise NotImplementedError(
                "from_train_op: 'metrics' are TF tensors in the "
                "source graph and are not recompiled; pass native "
                "val_methods to optimize()/Estimator.evaluate instead "
                "of silently dropping them")
        if dataset is None:
            raise ValueError(
                "from_train_op requires dataset= (a TFDataset, "
                "FeatureSet or (x, y) tuple); the placeholder-feeding "
                "dataset cannot be recovered from the graph here")
        import tensorflow as tf

        from analytics_zoo_torch.pipeline.api.keras import (Sequential,
                                                          objectives)
        from analytics_zoo_torch.tfpark.tf1_graph import recompile_train_op
        if sess is None:
            sess = tf.compat.v1.get_default_session()
            if sess is None:
                raise ValueError(
                    "from_train_op needs the session holding the "
                    "variable values (pass sess=)")
        net, criterion, optim = recompile_train_op(train_op, loss, sess)
        model = Sequential()
        model.add(net)
        fs, batch = _dataset_to_featureset(dataset, training=True)
        return cls(model, objectives.get(criterion), optim, fs,
                   batch_size=batch,
                   val_set=getattr(dataset, "val_set", None),
                   model_dir=model_dir, **kwargs)

    # -------------------------------------------------------------- running
    def set_train_summary(self, log_dir: str, app_name: str):
        self.estimator.set_tensorboard(log_dir, app_name)
        return self

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.estimator.set_constant_gradient_clipping(min_value, max_value)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self.estimator.set_l2_norm_gradient_clipping(clip_norm)
        return self

    def optimize(self, end_trigger: Optional[Trigger] = None,
                 checkpoint_trigger: Optional[Trigger] = None):
        """Run distributed training (ref optimize(), tf_optimizer.py:645)."""
        end_trigger = end_trigger or MaxEpoch(1)
        self.estimator.train(
            self.train_set, self.criterion, end_trigger=end_trigger,
            checkpoint_trigger=checkpoint_trigger,
            validation_set=self.val_set,
            validation_method=self.val_methods,
            batch_size=self.batch_size)
        return self.estimator.history


def _dataset_to_featureset(dataset, training: bool):
    """TFDataset | FeatureSet | (x, y) → (FeatureSet, batch size)."""
    from analytics_zoo_torch.feature.feature_set import FeatureSet
    from analytics_zoo_torch.tfpark.tf_dataset import TFDataset
    if isinstance(dataset, TFDataset):
        batch = dataset.batch_size if training else dataset.batch_per_thread
        return dataset.feature_set, (batch if batch and batch > 0 else 32)
    if isinstance(dataset, FeatureSet):
        return dataset, 32
    if isinstance(dataset, tuple):
        x, y = dataset
        return FeatureSet.from_ndarrays(x, y), 32
    raise TypeError(f"unsupported dataset {type(dataset)}")
