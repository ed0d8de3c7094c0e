"""Text pipeline: TextSet + tokenize → normalize → word2idx →
shapeSequence → generateSample (port of ``feature/text.py``: numpy and
the standard library only, a copy on the port's ``FeatureSet``).

Reference: zoo/feature/text/TextSet.scala:43-712 and the transformer
classes (Tokenizer, Normalizer, WordIndexer, SequenceShaper,
TextFeatureToSample).  Word-index save/load and relation-pair
construction for ranking (``from_relation_pairs``, used by KNRM QA
ranking) are part of the surface.

Host-side pipeline producing padded int32 id matrices for device infeed.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.feature.feature_set import FeatureSet

_TOKEN_RE = re.compile(r"[A-Za-z0-9']+")


class TextFeature:
    """One text sample: raw text, optional label, pipeline artifacts."""

    def __init__(self, text: str, label: Optional[int] = None, uri=None):
        self.text = text
        self.label = label
        self.uri = uri
        self.tokens: Optional[List[str]] = None
        self.indices: Optional[np.ndarray] = None


class TextSet:
    """Container of TextFeatures with chained pipeline stages."""

    def __init__(self, features: List[TextFeature],
                 word_index: Optional[Dict[str, int]] = None):
        self.features = features
        self.word_index = word_index

    # ------------------------------------------------------------ creation
    @classmethod
    def from_texts(cls, texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        return cls([TextFeature(t, l) for t, l in zip(texts, labels)])

    @classmethod
    def read_csv(cls, path: str, sep: str = ",") -> "TextSet":
        """uri,text per line (TextSet.readCSV)."""
        feats = []
        with open(path) as f:
            for line in f:
                uri, text = line.rstrip("\n").split(sep, 1)
                feats.append(TextFeature(text, uri=uri))
        return cls(feats)

    # ------------------------------------------------------------ pipeline
    def tokenize(self) -> "TextSet":
        for ft in self.features:
            ft.tokens = _TOKEN_RE.findall(ft.text)
        return self

    def normalize(self) -> "TextSet":
        for ft in self.features:
            assert ft.tokens is not None, "tokenize first"
            ft.tokens = [t.lower() for t in ft.tokens]
        return self

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build (or reuse) the word index; 0 is reserved for padding /
        unknown (TextSet.word2idx semantics: index starts at 1)."""
        if existing_map is None:
            counter = Counter()
            for ft in self.features:
                counter.update(ft.tokens or [])
            ranked = [w for w, c in counter.most_common() if c >= min_freq]
            ranked = ranked[remove_topN:]
            if max_words_num > 0:
                ranked = ranked[:max_words_num]
            self.word_index = {w: i + 1 for i, w in enumerate(ranked)}
        else:
            self.word_index = dict(existing_map)
        wi = self.word_index
        for ft in self.features:
            ft.indices = np.asarray(
                [wi.get(t, 0) for t in (ft.tokens or [])], np.int32)
        return self

    def shape_sequence(self, len_: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        """Pad/truncate to fixed length (SequenceShaper)."""
        for ft in self.features:
            idx = ft.indices
            assert idx is not None, "word2idx first"
            if len(idx) > len_:
                idx = idx[-len_:] if trunc_mode == "pre" else idx[:len_]
            elif len(idx) < len_:
                pad = np.full(len_ - len(idx), pad_element, np.int32)
                idx = np.concatenate([pad, idx]) if trunc_mode == "pre" \
                    else np.concatenate([idx, pad])
            ft.indices = idx
        return self

    def generate_sample(self) -> "TextSet":
        return self

    # ------------------------------------------------------------- exports
    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        x = np.stack([ft.indices for ft in self.features])
        labels = [ft.label for ft in self.features]
        y = None if any(l is None for l in labels) else \
            np.asarray(labels, np.int32).reshape(-1, 1)
        return x, y

    def to_feature_set(self, shuffle: bool = True) -> FeatureSet:
        x, y = self.to_arrays()
        return FeatureSet.from_ndarrays(x, y, shuffle=shuffle)

    # --------------------------------------------------------- persistence
    def save_word_index(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.word_index, f)

    def load_word_index(self, path: str) -> "TextSet":
        with open(path) as f:
            self.word_index = json.load(f)
        return self

    def __len__(self):
        return len(self.features)

    # --------------------------------------------------------- qa ranking
    @classmethod
    def from_relation_pairs(cls, relations, corpus1: Dict[str, str],
                            corpus2: Dict[str, str]) -> "TextSet":
        """Build interleaved (pos, neg) text pairs for pairwise ranking
        (TextSet.fromRelationPairs, feeding RankHinge loss).

        ``relations``: list of (id1, id2, label); for each id1, every
        positive id2 pairs with every negative id2.
        """
        by_q: Dict[str, Dict[int, List[str]]] = {}
        for id1, id2, label in relations:
            by_q.setdefault(id1, {0: [], 1: []})[int(label)].append(id2)
        feats = []
        for id1, groups in by_q.items():
            for pos in groups[1]:
                for neg in groups[0]:
                    feats.append(TextFeature(
                        corpus1[id1] + " \t " + corpus2[pos], label=1))
                    feats.append(TextFeature(
                        corpus1[id1] + " \t " + corpus2[neg], label=0))
        return cls(feats)
