"""Pretrained BERT checkpoint import (port of
``tfpark/text/bert_checkpoint.py``).

Loads published BERT weights into the native BERT encoder
(``pipeline/api/keras/layers/attention.py``) from:

* a **google TF checkpoint** — the ``bert_model.ckpt`` prefix or the
  directory holding it, read with ``tf.train.load_checkpoint`` (TF kernels
  are already (in, out)); TensorFlow is imported only here, and a machine
  without it raises;
* a **HuggingFace** ``BertModel`` or any state_dict of tensors or arrays
  under its names (torch Linear weights are (out, in) and get
  transposed); neither ``transformers`` nor TensorFlow is needed.

Each block's Q/K/V projections fuse into the encoder's single
``qkv_kernel`` (concatenated on the output dim, Q then K then V, the
order the fused ``(B, T, 3H) -> (B, T, 3, heads, head_dim)`` reshape
reads).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch


# -------------------------------------------------------------- config io
def bert_kwargs_from_config(config_path: str) -> Dict[str, Any]:
    """A google ``bert_config.json`` as ``BERT(...)`` kwargs (google field
    names, bert/modeling.py BertConfig)."""
    with open(config_path) as f:
        c = json.load(f)
    act = str(c.get("hidden_act", "gelu"))
    return dict(
        vocab=int(c["vocab_size"]),
        hidden_size=int(c["hidden_size"]),
        n_block=int(c["num_hidden_layers"]),
        n_head=int(c["num_attention_heads"]),
        intermediate_size=int(c["intermediate_size"]),
        max_position_len=int(c.get("max_position_embeddings", 512)),
        type_vocab_size=int(c.get("type_vocab_size", 2)),
        hidden_drop=float(c.get("hidden_dropout_prob", 0.1)),
        attn_drop=float(c.get("attention_probs_dropout_prob", 0.1)),
        # google "gelu" is the exact erf gelu; HF "gelu_new" is the tanh
        # approximation this framework calls "gelu"
        hidden_act={"gelu": "gelu_erf", "gelu_new": "gelu"}.get(act, act),
    )


# ------------------------------------------------------------ source readers
def _google_reader(src) -> Callable[[str], np.ndarray]:
    """get(google variable name) over a TF checkpoint."""
    import tensorflow as tf

    prefix = src
    if os.path.isdir(src):
        ckpt = tf.train.latest_checkpoint(src)
        if ckpt is None:
            for cand in ("bert_model.ckpt", "model.ckpt"):
                if os.path.exists(os.path.join(src, cand + ".index")):
                    ckpt = os.path.join(src, cand)
                    break
        if ckpt is None:
            raise FileNotFoundError(
                f"no TF checkpoint found under {src!r}")
        prefix = ckpt
    reader = tf.train.load_checkpoint(prefix)

    def get(name: str) -> np.ndarray:
        return np.asarray(reader.get_tensor(name))

    return get


_G2HF = {
    "bert/embeddings/word_embeddings": "embeddings.word_embeddings.weight",
    "bert/embeddings/token_type_embeddings":
        "embeddings.token_type_embeddings.weight",
    "bert/embeddings/position_embeddings":
        "embeddings.position_embeddings.weight",
    "bert/embeddings/LayerNorm/gamma": "embeddings.LayerNorm.weight",
    "bert/embeddings/LayerNorm/beta": "embeddings.LayerNorm.bias",
    "bert/pooler/dense/kernel": "pooler.dense.weight",
    "bert/pooler/dense/bias": "pooler.dense.bias",
}

# bert/encoder/layer_N/<tail> -> encoder.layer.N.<HF tail>
_BLOCK_G2HF = {
    "attention/self/query/kernel": "attention.self.query.weight",
    "attention/self/query/bias": "attention.self.query.bias",
    "attention/self/key/kernel": "attention.self.key.weight",
    "attention/self/key/bias": "attention.self.key.bias",
    "attention/self/value/kernel": "attention.self.value.weight",
    "attention/self/value/bias": "attention.self.value.bias",
    "attention/output/dense/kernel": "attention.output.dense.weight",
    "attention/output/dense/bias": "attention.output.dense.bias",
    "attention/output/LayerNorm/gamma": "attention.output.LayerNorm.weight",
    "attention/output/LayerNorm/beta": "attention.output.LayerNorm.bias",
    "intermediate/dense/kernel": "intermediate.dense.weight",
    "intermediate/dense/bias": "intermediate.dense.bias",
    "output/dense/kernel": "output.dense.weight",
    "output/dense/bias": "output.dense.bias",
    "output/LayerNorm/gamma": "output.LayerNorm.weight",
    "output/LayerNorm/beta": "output.LayerNorm.bias",
}


def hf_name(name: str) -> str:
    """The HF state_dict key of a google variable name."""
    if name in _G2HF:
        return _G2HF[name]
    parts = name.split("/")
    if len(parts) < 4 or parts[1] != "encoder":
        raise KeyError(f"not a BERT variable name: {name!r}")
    n = parts[2].split("_")[1]
    return f"encoder.layer.{n}.{_BLOCK_G2HF['/'.join(parts[3:])]}"


def _hf_reader(src) -> Callable[[str], np.ndarray]:
    """get(google variable name) over a HF BertModel or a state_dict of
    tensors or arrays (keys with or without a ``bert.`` prefix)."""
    if hasattr(src, "state_dict"):
        src = src.state_dict()
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in src.items()}
    if not any(k.startswith("embeddings.") for k in sd) and any(
            k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()
              if k.startswith("bert.")}

    def get(name: str) -> np.ndarray:
        arr = sd[hf_name(name)]
        # torch Linear weights are (out, in); google kernels are (in, out)
        return arr.T if name.endswith("/kernel") else arr

    return get


# ---------------------------------------------------------------- installer
def load_bert_checkpoint(model, src) -> None:
    """Import pretrained BERT weights into ``model`` in place.

    ``model`` is a graph Model holding the native BERT encoder (the encoder
    itself, or an estimator's head model: the encoder's layers come
    before the head's in the graph's order).  ``src`` is a google
    checkpoint prefix or directory, a HF ``BertModel``, or a state_dict.
    Each value lands on the model's device in the model's dtype."""
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_torch.pipeline.api.keras.layers.attention import (
        MultiHeadSelfAttention, PositionwiseFeedForward)
    from analytics_zoo_torch.pipeline.api.keras.layers.embedding import (
        Embedding)
    from analytics_zoo_torch.pipeline.api.keras.layers.normalization import (
        LayerNorm)

    get = _google_reader(src) if isinstance(src, (str, os.PathLike)) \
        else _hf_reader(src)

    embeds = [l for l in model.layers if isinstance(l, Embedding)]
    lns = [l for l in model.layers if isinstance(l, LayerNorm)]
    attns = [l for l in model.layers
             if isinstance(l, MultiHeadSelfAttention)]
    ffns = [l for l in model.layers
            if isinstance(l, PositionwiseFeedForward)]
    denses = [l for l in model.layers if isinstance(l, Dense)]
    n = len(attns)
    if len(embeds) < 3 or len(lns) != 2 * n + 1 or len(ffns) != n \
            or not denses:
        raise ValueError(
            f"model does not look like the native BERT encoder "
            f"(embeddings={len(embeds)}, layernorms={len(lns)}, "
            f"attention={n}, ffn={len(ffns)}, dense={len(denses)})")

    # the model's own variables (drawn if it has none yet): a re-import
    # into a fine-tuned model keeps its head
    variables = model.get_variables()
    params, state = variables["params"], variables["state"]

    def put(layer, key: str, value: np.ndarray) -> None:
        cur = params[layer.name][key]
        if tuple(cur.shape) != tuple(np.shape(value)):
            raise ValueError(
                f"{layer.name}.{key}: checkpoint shape "
                f"{tuple(np.shape(value))} != model shape "
                f"{tuple(cur.shape)}")
        params[layer.name][key] = torch.as_tensor(
            np.ascontiguousarray(value)).to(device=cur.device,
                                            dtype=cur.dtype)

    # embeddings in the graph's order: token, segment, position
    tok, seg, pos = embeds[0], embeds[1], embeds[2]
    put(tok, "embeddings", get("bert/embeddings/word_embeddings"))
    put(seg, "embeddings", get("bert/embeddings/token_type_embeddings"))
    # checkpoints carry 512 position rows; a model built with a shorter
    # max_position_len takes their prefix
    model_pos = params[pos.name]["embeddings"].shape[0]
    put(pos, "embeddings",
        get("bert/embeddings/position_embeddings")[:model_pos])
    put(lns[0], "gamma", get("bert/embeddings/LayerNorm/gamma"))
    put(lns[0], "beta", get("bert/embeddings/LayerNorm/beta"))

    for i in range(n):
        p = f"bert/encoder/layer_{i}"
        put(attns[i], "qkv_kernel", np.concatenate(
            [get(f"{p}/attention/self/{w}/kernel")
             for w in ("query", "key", "value")], axis=1))
        put(attns[i], "qkv_bias", np.concatenate(
            [get(f"{p}/attention/self/{w}/bias")
             for w in ("query", "key", "value")]))
        put(attns[i], "out_kernel",
            get(f"{p}/attention/output/dense/kernel"))
        put(attns[i], "out_bias", get(f"{p}/attention/output/dense/bias"))
        put(lns[2 * i + 1], "gamma",
            get(f"{p}/attention/output/LayerNorm/gamma"))
        put(lns[2 * i + 1], "beta",
            get(f"{p}/attention/output/LayerNorm/beta"))
        put(ffns[i], "up_kernel", get(f"{p}/intermediate/dense/kernel"))
        put(ffns[i], "up_bias", get(f"{p}/intermediate/dense/bias"))
        put(ffns[i], "down_kernel", get(f"{p}/output/dense/kernel"))
        put(ffns[i], "down_bias", get(f"{p}/output/dense/bias"))
        put(lns[2 * i + 2], "gamma", get(f"{p}/output/LayerNorm/gamma"))
        put(lns[2 * i + 2], "beta", get(f"{p}/output/LayerNorm/beta"))

    # the pooler is the first Dense in the graph's order
    put(denses[0], "kernel", get("bert/pooler/dense/kernel"))
    put(denses[0], "bias", get("bert/pooler/dense/bias"))

    model.set_variables({"params": params, "state": state})


def bert_for_checkpoint(ckpt_dir, seq_len: int = 128, **overrides):
    """A native ``BERT`` configured from a google checkpoint directory's
    (or prefix's directory's) ``bert_config.json``."""
    from analytics_zoo_torch.pipeline.api.keras.layers.attention import BERT

    base = ckpt_dir if os.path.isdir(ckpt_dir) \
        else os.path.dirname(ckpt_dir)
    cfg_path = os.path.join(base, "bert_config.json")
    kwargs: Dict[str, Any] = {}
    if os.path.exists(cfg_path):
        kwargs = bert_kwargs_from_config(cfg_path)
    kwargs["seq_len"] = seq_len
    kwargs.update(overrides)
    return BERT(**kwargs)
