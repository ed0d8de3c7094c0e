"""Text classifier (port of ``models/textclassification/text_classifier.py``):
embedding (or pretrained ``WordEmbedding``) → encoder → dense head.

Encoders: ``cnn`` (a width-5 ``Convolution1D`` with ReLU, then a global
max-pool over time), ``lstm`` and ``gru`` (one recurrent layer of
``encoder_output_dim`` units whose last hidden state is the encoding;
``layers/recurrent.py``) and ``transformer`` (learned positions +
``n_block`` post-LN encoder blocks → max-pool → fused LayerNorm→GeLU →
Dense).

At BERT-base widths (``token_length=768``, ``n_head=12``,
``sequence_length=512``) each forward runs the flash-attention kernel and
the bias→GeLU kernel once per block and the LayerNorm→GeLU kernel once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_torch.models.common import ZooModel
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    GRU, LSTM, Convolution1D, Dense, Dropout, Embedding, GlobalMaxPooling1D,
    Lambda, LayerNorm, Merge, WordEmbedding, transformer_block,
)


def _position_ids(t: torch.Tensor) -> torch.Tensor:
    """(B, T) ids -> (B, T) positions 0..T-1."""
    return torch.arange(t.shape[1], device=t.device,
                        dtype=torch.int32)[None, :].expand(t.shape)


class TextClassifier(ZooModel):
    """encoder: "cnn" | "lstm" | "gru" (TextClassifier.scala encoder
    arg) | "transformer"; with optional pretrained embeddings.
    ``n_head``/``n_block`` apply to the transformer encoder only; its
    width is ``token_length`` (residual stream), the head keeps
    ``encoder_output_dim``."""

    def __init__(self, class_num: int, token_length: int = 200,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 max_words_num: int = 5000,
                 embedding_matrix: Optional[np.ndarray] = None,
                 n_head: int = 4, n_block: int = 1):
        self.class_num = int(class_num)
        self.token_length = int(token_length)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.max_words_num = int(max_words_num)
        self.embedding_matrix = embedding_matrix
        self.n_head = int(n_head)
        self.n_block = int(n_block)
        if self.encoder not in ("cnn", "lstm", "gru", "transformer"):
            raise ValueError(f"unknown encoder {self.encoder!r}; "
                             "use cnn|lstm|gru|transformer")
        if self.encoder == "transformer" and \
                self.token_length % self.n_head:
            raise ValueError(
                f"token_length {self.token_length} must divide into "
                f"n_head {self.n_head} heads")
        super().__init__()

    def build_model(self):
        inp = Input(shape=(self.sequence_length,))
        if self.embedding_matrix is not None:
            x = WordEmbedding(self.embedding_matrix, trainable=False)(inp)
        else:
            x = Embedding(self.max_words_num + 1, self.token_length,
                          init="uniform")(inp)
        if self.encoder == "cnn":
            x = Convolution1D(self.encoder_output_dim, 5,
                              activation="relu")(x)
            x = GlobalMaxPooling1D()(x)
        elif self.encoder == "lstm":
            x = LSTM(self.encoder_output_dim)(x)
        elif self.encoder == "gru":
            x = GRU(self.encoder_output_dim)(x)
        else:
            x = self._transformer_encoder(inp, x)
        x = Dropout(0.2)(x)
        x = Dense(128, activation="relu")(x)
        out = Dense(self.class_num)(x)
        return Model(inp, out)

    def _transformer_encoder(self, inp, x):
        d = self.token_length
        # position ids derived in-graph from the token input
        pos_ids = Lambda(_position_ids,
                         output_shape=(self.sequence_length,))(inp)
        pos_e = Embedding(self.sequence_length, d, init="normal")(pos_ids)
        x = Merge(mode="sum")([x, pos_e])
        for _ in range(self.n_block):
            x = transformer_block(x, None, d, self.n_head, 4 * d,
                                  dropout=0.1, causal=False)
        x = GlobalMaxPooling1D()(x)
        # fused LayerNorm→GeLU epilogue (ops/fused.py layernorm_act)
        x = LayerNorm(activation="gelu")(x)
        return Dense(self.encoder_output_dim, activation="relu")(x)
