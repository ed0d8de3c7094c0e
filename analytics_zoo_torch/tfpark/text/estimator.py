"""BERT estimators (port of ``tfpark/text/estimator.py``).

Fine-tuning heads over the native BERT encoder
(``pipeline/api/keras/layers/attention.py:BERT``) with the reference's
``train``/``evaluate``/``predict`` surface; inputs follow its feature
dict ``{input_ids, token_type_ids?, position_ids?, attention_mask?}``.
``train`` compiles ``AdamWeightDecay(lr=2e-5)`` unless given an
optimizer; the trainer's fused update declines it, as the reference's
does, so BERT fine-tuning runs the optimizer's own chain.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from analytics_zoo_torch.pipeline.api.keras import layers as L
from analytics_zoo_torch.pipeline.api.keras.layers.attention import BERT
from analytics_zoo_torch.pipeline.api.keras.topology import Model


class BERTBaseEstimator:
    """Feature-extraction base: the encoder's sequence and pooled outputs
    plus the shared train surface."""

    def __init__(self, bert: Optional[BERT] = None,
                 bert_checkpoint=None, **bert_kwargs):
        """``bert_checkpoint`` is a google BERT checkpoint directory or
        prefix (the encoder configured from its ``bert_config.json`` and
        initialised from its weights; TensorFlow reads it), or a HF
        ``BertModel`` or its state_dict (the encoder built from
        ``bert_kwargs``).  The heads stay randomly initialised."""
        from analytics_zoo_torch.tfpark.text import bert_checkpoint as bc
        if bert is None and isinstance(bert_checkpoint, (str, os.PathLike)):
            bert = bc.bert_for_checkpoint(bert_checkpoint, **bert_kwargs)
        self.bert = bert or BERT(**bert_kwargs)
        self.encoder = self.bert.build()
        self.cfg = self.bert.cfg
        self.model = self._build_model()
        if bert_checkpoint is not None:
            bc.load_bert_checkpoint(self.model, bert_checkpoint)
            if self.encoder is not self.model:
                # the head model and the bare encoder each hold their own
                # variable trees (layers are shared, variables are not):
                # the encoder's copies come from the loaded model
                mv = self.model.get_variables()
                ev = self.encoder.get_variables()
                for kind in ("params", "state"):
                    for lname in ev[kind]:
                        if lname in mv[kind]:
                            ev[kind][lname] = mv[kind][lname]
                self.encoder.set_variables(ev)

    def _build_model(self) -> Model:
        """Subclasses attach a head; the base serves raw features."""
        return self.encoder

    @staticmethod
    def _inputs(features: dict, seq_len: int):
        ids = np.asarray(features["input_ids"])
        seg = np.asarray(features.get("token_type_ids",
                                      np.zeros_like(ids)))
        pos = np.asarray(features.get(
            "position_ids",
            np.broadcast_to(np.arange(seq_len), ids.shape)))
        mask = np.asarray(features.get("attention_mask",
                                       np.ones_like(ids)))
        return [ids, seg, pos, mask]

    def train(self, features: dict, labels, loss: str,
              optim_method=None, batch_size: int = 8, epochs: int = 1):
        from analytics_zoo_torch.pipeline.api.keras.optimizers import (
            AdamWeightDecay)
        x = self._inputs(features, self.cfg["seq_len"])
        self.model.compile(optim_method or AdamWeightDecay(lr=2e-5), loss)
        # the per-epoch records of ``fit`` (loss, throughput, wall)
        self.history = self.model.fit(x, np.asarray(labels),
                                      batch_size=batch_size, nb_epoch=epochs)
        return self

    def evaluate(self, features: dict, labels, batch_size: int = 8):
        x = self._inputs(features, self.cfg["seq_len"])
        return self.model.evaluate(x, np.asarray(labels),
                                   batch_size=batch_size)

    def predict(self, features: dict, batch_size: int = 8):
        x = self._inputs(features, self.cfg["seq_len"])
        return self.model.predict(x, batch_size=batch_size)


class BERTClassifier(BERTBaseEstimator):
    """Sequence classification: dropout and a Dense over the pooled
    output, trained on logits."""

    def __init__(self, num_classes: int, dropout: float = 0.1,
                 **bert_kwargs):
        self.num_classes = num_classes
        self.dropout = dropout
        super().__init__(**bert_kwargs)

    def _build_model(self) -> Model:
        x = L.Dropout(self.dropout)(self.encoder.outputs[1])
        return Model(self.encoder.inputs, L.Dense(self.num_classes)(x))

    def train(self, features, labels, optim_method=None,
              batch_size: int = 8, epochs: int = 1):
        return super().train(
            features, labels,
            loss="sparse_categorical_crossentropy_with_logits",
            optim_method=optim_method, batch_size=batch_size,
            epochs=epochs)


class BERTNER(BERTBaseEstimator):
    """Token classification: dropout and a time-distributed Dense over
    the sequence output."""

    def __init__(self, num_entities: int, dropout: float = 0.1,
                 **bert_kwargs):
        self.num_entities = num_entities
        self.dropout = dropout
        super().__init__(**bert_kwargs)

    def _build_model(self) -> Model:
        x = L.Dropout(self.dropout)(self.encoder.outputs[0])
        logits = L.TimeDistributed(L.Dense(self.num_entities))(x)
        return Model(self.encoder.inputs, logits)

    def train(self, features, labels, optim_method=None,
              batch_size: int = 8, epochs: int = 1):
        return super().train(
            features, labels,
            loss="sparse_categorical_crossentropy_with_logits",
            optim_method=optim_method, batch_size=batch_size,
            epochs=epochs)


class BERTSQuAD(BERTBaseEstimator):
    """Span extraction: per-token start/end logits over the sequence
    output."""

    def _build_model(self) -> Model:
        span = L.TimeDistributed(L.Dense(2))(self.encoder.outputs[0])
        return Model(self.encoder.inputs, span)            # (B, T, 2)

    def predict_spans(self, features: dict, batch_size: int = 8):
        """(start_logits, end_logits), each (B, T)."""
        out = np.asarray(self.predict(features, batch_size=batch_size))
        return out[..., 0], out[..., 1]
