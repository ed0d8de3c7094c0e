"""TFPark Keras-style text models (port of
``tfpark/text/keras_models.py``): the NLP-architect taggers and the joint
intent/entity net, assembled from the port's native layers (the
recurrent layers are eager loops over ``ops.dtypes.matmul``), with the
``fit``/``evaluate``/``predict``/``save_model`` surface of the graph
model they hold."""

from __future__ import annotations

from typing import Optional

from analytics_zoo_torch.pipeline.api.keras import layers as L
from analytics_zoo_torch.pipeline.api.keras.engine import Input
from analytics_zoo_torch.pipeline.api.keras.topology import Model


class TextKerasModel:
    """Holds a native graph model and forwards the training surface."""

    def __init__(self, model: Model):
        self.model = model

    def compile(self, optimizer, loss, metrics=None):
        self.model.compile(optimizer, loss, metrics)
        return self

    def fit(self, x, y, batch_size: int = 32, epochs: int = 1, **kwargs):
        return self.model.fit(x, y, batch_size=batch_size,
                              nb_epoch=epochs, **kwargs)

    def evaluate(self, x, y, batch_size: int = 32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 256, distributed: bool = False):
        return self.model.predict(x, batch_size=batch_size)

    def save_model(self, path: str, over_write: bool = True):
        self.model.save_model(path, over_write=over_write)

    def get_weights(self):
        return self.model.get_weights()


def _char_summary(chars, char_vocab_size: int, emb_dim: int):
    """Each word's characters embedded and summarised by a
    time-distributed BiLSTM: (B, T, W) -> (B, T, 2 * emb_dim)."""
    c = L.Embedding(char_vocab_size, emb_dim)(chars)
    return L.TimeDistributed(
        L.Bidirectional(L.LSTM(emb_dim, return_sequences=False)))(c)


class NER(TextKerasModel):
    """Named-entity recognizer: word + char embeddings, a char BiLSTM
    summarised per word, two stacked word BiLSTMs, and a per-token
    softmax tag head."""

    def __init__(self, num_entities: int, word_vocab_size: int,
                 char_vocab_size: int, word_length: int = 12,
                 seq_len: int = 50, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, tagger_lstm_dim: int = 100,
                 dropout: float = 0.5):
        words = Input(shape=(seq_len,))
        chars = Input(shape=(seq_len, word_length))
        w = L.Embedding(word_vocab_size, word_emb_dim)(words)
        c = _char_summary(chars, char_vocab_size, char_emb_dim)
        x = L.Merge(mode="concat", concat_axis=-1)([w, c])
        x = L.Dropout(dropout)(x)
        for _ in range(2):
            x = L.Bidirectional(L.LSTM(tagger_lstm_dim,
                                       return_sequences=True))(x)
        out = L.TimeDistributed(
            L.Dense(num_entities, activation="softmax"))(x)
        super().__init__(Model([words, chars], out))


class SequenceTagger(TextKerasModel):
    """Joint POS + chunk tagger: a shared word embedding/BiLSTM trunk
    (chars added when ``char_vocab_size``) and two softmax heads."""

    def __init__(self, num_pos_labels: int, num_chunk_labels: int,
                 word_vocab_size: int, char_vocab_size: Optional[int] = None,
                 word_length: int = 12, feature_size: int = 100,
                 classifier: str = "softmax", seq_len: int = 50,
                 dropout: float = 0.2):
        words = Input(shape=(seq_len,))
        inputs = [words]
        feats = L.Embedding(word_vocab_size, feature_size)(words)
        if char_vocab_size:
            chars = Input(shape=(seq_len, word_length))
            inputs.append(chars)
            c = _char_summary(chars, char_vocab_size, feature_size // 4)
            feats = L.Merge(mode="concat", concat_axis=-1)([feats, c])
        x = L.Dropout(dropout)(feats)
        x = L.Bidirectional(L.LSTM(feature_size, return_sequences=True))(x)
        pos = L.TimeDistributed(
            L.Dense(num_pos_labels, activation="softmax"))(x)
        chunk = L.TimeDistributed(
            L.Dense(num_chunk_labels, activation="softmax"))(x)
        super().__init__(Model(inputs, [pos, chunk]))


class IntentEntity(TextKerasModel):
    """Joint intent classification + slot filling: a char-enriched BiLSTM
    encoder, an intent head over its max-pooled states and a per-token
    entity head."""

    def __init__(self, num_intents: int, num_entities: int,
                 word_vocab_size: int, char_vocab_size: int,
                 word_length: int = 12, seq_len: int = 50,
                 token_emb_size: int = 100, char_emb_size: int = 30,
                 tagger_lstm_dim: int = 100, dropout: float = 0.2):
        words = Input(shape=(seq_len,))
        chars = Input(shape=(seq_len, word_length))
        w = L.Embedding(word_vocab_size, token_emb_size)(words)
        c = _char_summary(chars, char_vocab_size, char_emb_size)
        x = L.Merge(mode="concat", concat_axis=-1)([w, c])
        x = L.Dropout(dropout)(x)
        enc = L.Bidirectional(L.LSTM(tagger_lstm_dim,
                                     return_sequences=True))(x)
        intent = L.Dense(num_intents, activation="softmax")(
            L.GlobalMaxPooling1D()(enc))
        ents = L.Bidirectional(L.LSTM(tagger_lstm_dim,
                                      return_sequences=True))(enc)
        ents = L.TimeDistributed(
            L.Dense(num_entities, activation="softmax"))(ents)
        super().__init__(Model([words, chars], [intent, ents]))
