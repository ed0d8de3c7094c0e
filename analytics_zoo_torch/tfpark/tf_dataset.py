"""TFDataset: feed tf.data pipelines (and other sources) into the zoo
engine (port of the JAX package's ``tfpark/tf_dataset.py``).

tf.data stays a host-side producer: ``from_tf_data_dataset`` drains the
dataset's numpy iterator (it needs TensorFlow only through the dataset
object it is given).  The other factories read TFRecords
(``feature/tfrecord.py``), encoded images (``feature/image.py``'s codec),
an ``ImageSet``, a ``TextSet`` or raw strings, and pandas columns.
``batch_size`` is the global training batch; ``batch_per_thread`` maps to
the inference batch (reference semantics).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_torch.feature.feature_set import FeatureSet


class TFDataset:
    def __init__(self, feature_set: FeatureSet, batch_size: int = -1,
                 batch_per_thread: int = -1):
        self.feature_set = feature_set
        self.batch_size = batch_size
        self.batch_per_thread = batch_per_thread

    # ------------------------------------------------------------ factories
    @classmethod
    def from_ndarrays(cls, tensors, batch_size: int = -1,
                      batch_per_thread: int = -1,
                      val_tensors=None) -> "TFDataset":
        x, y = tensors if isinstance(tensors, tuple) else (tensors, None)
        fs = FeatureSet.from_ndarrays(x, y)
        ds = cls(fs, batch_size, batch_per_thread)
        if val_tensors is not None:
            vx, vy = val_tensors
            ds.val_set = FeatureSet.from_ndarrays(vx, vy, shuffle=False)
        return ds

    @classmethod
    def from_tf_data_dataset(cls, dataset, batch_size: int = -1,
                             batch_per_thread: int = -1,
                             max_items: Optional[int] = None
                             ) -> "TFDataset":
        """Materialise a (finite or capped) tf.data.Dataset host-side.

        The reference ships the serialized tf.data graph to executors
        (TFDataFeatureSet); here the host is the executor, so we simply
        drain the iterator into columnar storage.
        """
        xs, ys = [], []
        for i, item in enumerate(dataset.as_numpy_iterator()):
            if max_items is not None and i >= max_items:
                break
            if isinstance(item, tuple) and len(item) == 2:
                xs.append(item[0])
                ys.append(item[1])
            else:
                xs.append(item)
        x = np.stack(xs)
        y = np.stack(ys) if ys else None
        if y is not None and y.ndim == 1:
            y = y[:, None]
        return cls(FeatureSet.from_ndarrays(x, y),
                   batch_size, batch_per_thread)

    @classmethod
    def from_feature_set(cls, fs: FeatureSet, batch_size: int = -1,
                         batch_per_thread: int = -1) -> "TFDataset":
        return cls(fs, batch_size, batch_per_thread)

    @classmethod
    def from_tfrecord_file(cls, paths, features, label: Optional[str] = None,
                           batch_size: int = -1,
                           batch_per_thread: int = -1) -> "TFDataset":
        """Read TFRecord Examples with the pure-Python reader
        (feature/tfrecord.py; reference tf_dataset.py:479 used the
        tensorflow-hadoop input format).

        ``features``: list of feature names forming x — a single array
        when one name, else a list pytree in order (multi-input models);
        ``label``: optional label feature name.
        """
        from analytics_zoo_torch.feature.tfrecord import load_tfrecord_arrays
        names = list(features) + ([label] if label else [])
        cols = load_tfrecord_arrays(paths, feature_names=names)
        missing = [n for n in names if n not in cols]
        if missing:
            raise ValueError(f"features {missing} not found in TFRecords "
                             f"(have {sorted(cols)})")
        xs = [cols[n] for n in features]
        x = xs[0] if len(xs) == 1 else xs
        y = cols[label] if label else None
        return cls(FeatureSet.from_ndarrays(x, y),
                   batch_size, batch_per_thread)

    @classmethod
    def from_image_set(cls, image_set, batch_size: int = -1,
                       batch_per_thread: int = -1) -> "TFDataset":
        """ImageSet → dataset (reference tf_dataset.py from_image_set)."""
        return cls(image_set.to_feature_set(),
                   batch_size, batch_per_thread)

    @classmethod
    def from_text_set(cls, text_set, batch_size: int = -1,
                      batch_per_thread: int = -1) -> "TFDataset":
        """TextSet (already word2idx + shaped) → dataset."""
        return cls(text_set.to_feature_set(),
                   batch_size, batch_per_thread)

    @classmethod
    def from_dataframe(cls, df, feature_cols, labels_cols=None,
                       batch_size: int = -1,
                       batch_per_thread: int = -1) -> "TFDataset":
        """pandas DataFrame columns → dataset (reference from_dataframe
        took a Spark DataFrame; the driver-side table here is pandas)."""
        def col(c):
            v = df[c].to_numpy()
            if v.dtype == object:   # column of arrays
                v = np.stack(v)
            return v
        xs = [col(c) for c in feature_cols]
        x = xs[0] if len(xs) == 1 else xs
        y = None
        if labels_cols:
            names = [labels_cols] if isinstance(labels_cols, str) \
                else list(labels_cols)
            ys = [y_[:, None] if y_.ndim == 1 else y_
                  for y_ in (col(c) for c in names)]
            y = ys[0] if len(ys) == 1 else ys
        return cls(FeatureSet.from_ndarrays(x, y),
                   batch_size, batch_per_thread)

    @classmethod
    def from_bytes(cls, records, labels=None, transform=None,
                   batch_size: int = -1,
                   batch_per_thread: int = -1) -> "TFDataset":
        """Encoded image bytes → decoded dataset (the in-process form
        of the reference's TFBytesDataset, tf_dataset.py:826: a byte
        RDD of JPEGs decoded per executor).

        ``transform``: optional ``Preprocessing`` applied per decoded
        HWC uint8 image (resize/normalize/...); without one, all
        images must already share a shape.
        """
        from analytics_zoo_torch.feature.image import decode_image_bytes
        imgs = []
        for i, rec in enumerate(records):
            img = decode_image_bytes(rec, context=f"record {i}")
            if transform is not None:
                img = transform(img)
            imgs.append(np.asarray(img))
        x = np.stack(imgs)
        y = None
        if labels is not None:
            y = np.asarray(labels)
            if y.ndim == 1:
                y = y[:, None]
        return cls(FeatureSet.from_ndarrays(x, y),
                   batch_size, batch_per_thread)

    @classmethod
    def from_strings(cls, texts, labels=None, word_index=None,
                     sequence_length: int = 128,
                     max_words_num: int = -1,
                     shuffle: bool = True,
                     batch_size: int = -1,
                     batch_per_thread: int = -1) -> "TFDataset":
        """Raw strings → tokenize → word2idx → pad → dataset (the
        in-process form of the reference's TFTextDataset,
        tf_dataset.py:876: a string RDD run through TextSet stages).

        Returns the dataset; the fitted ``word_index`` is available as
        ``ds.word_index`` for inference-time reuse (pass it back in).
        """
        from analytics_zoo_torch.feature.text import TextSet
        ts = (TextSet.from_texts(list(texts), labels).tokenize()
              .word2idx(max_words_num=max_words_num,
                        existing_map=word_index)
              .shape_sequence(sequence_length))
        ds = cls(ts.to_feature_set(shuffle=shuffle),
                 batch_size, batch_per_thread)
        ds.word_index = ts.word_index
        return ds

    @classmethod
    def from_string_rdd(cls, *a, **kw):
        raise NotImplementedError(
            "RDD sources require the Spark-bridge deployment; use "
            "from_strings / from_bytes / from_ndarrays / "
            "from_tf_data_dataset / from_feature_set")

    from_rdd = from_string_rdd
    from_bytes_rdd = from_string_rdd

    def get_training_batch_size(self) -> int:
        if self.batch_size <= 0:
            raise ValueError("this TFDataset was built for inference "
                             "(batch_per_thread); pass batch_size")
        return self.batch_size
