"""Inception-v1 trained through the TFPark adapter (port of the JAX
package's ``benchmarks/inception.py``; BASELINE.md config 4:
"Distributed Inception-v1 via the TFPark-equivalent adapter"; reference
recipe examples/inception/Train.scala:31 over the TFPark path
pyzoo/zoo/tfpark/model.py:34).

The measured path is the USER path end to end: the model is *defined
in tf.keras* (functional API, the real Inception-v1 topology with its
9 concatenation blocks), converted to native layers by
``tfpark.KerasModel``, and trained by the engine.  Throughput is the
median steady-state epoch from the fit history (the first epoch, which
pays the kernel builds and the CUDA-graph captures, is excluded) and
INCLUDES per-batch host→device transfer — this benchmark measures the
adapter pipeline, not the card's peak.  ``build_tf_inception_v1`` needs
TensorFlow, imported inside it; ``inception_v1.json`` beside this file
holds what the converter reads of that model (its config, each layer's
class, build config and weight shapes, the compile facts) for machines
without TensorFlow.
"""

from __future__ import annotations

import time


def _inception_block(tf, x, c1, c3r, c3, c5r, c5, pp, name):
    """One Inception-v1 mixed block (1x1 / 3x3 / 5x5 / pool towers)."""
    L = tf.keras.layers
    b1 = L.Conv2D(c1, 1, activation="relu", padding="same",
                  name=name + "_1x1")(x)
    b3 = L.Conv2D(c3r, 1, activation="relu", padding="same",
                  name=name + "_3x3r")(x)
    b3 = L.Conv2D(c3, 3, activation="relu", padding="same",
                  name=name + "_3x3")(b3)
    b5 = L.Conv2D(c5r, 1, activation="relu", padding="same",
                  name=name + "_5x5r")(x)
    b5 = L.Conv2D(c5, 5, activation="relu", padding="same",
                  name=name + "_5x5")(b5)
    bp = L.MaxPooling2D(3, strides=1, padding="same",
                        name=name + "_pool")(x)
    bp = L.Conv2D(pp, 1, activation="relu", padding="same",
                  name=name + "_poolproj")(bp)
    return L.Concatenate(name=name + "_concat")([b1, b3, b5, bp])


def build_tf_inception_v1(num_classes: int = 1000,
                          image_size: int = 224):
    """Inception-v1 (GoogLeNet, no aux classifiers — the reference
    trains Inception_v1_NoAuxClassifier) in tf.keras functional API."""
    import tensorflow as tf
    L = tf.keras.layers
    inp = L.Input((image_size, image_size, 3))
    x = L.Conv2D(64, 7, strides=2, padding="same",
                 activation="relu", name="conv1")(inp)
    x = L.MaxPooling2D(3, strides=2, padding="same")(x)
    x = L.Conv2D(64, 1, activation="relu", name="conv2r")(x)
    x = L.Conv2D(192, 3, padding="same", activation="relu",
                 name="conv2")(x)
    x = L.MaxPooling2D(3, strides=2, padding="same")(x)
    x = _inception_block(tf, x, 64, 96, 128, 16, 32, 32, "mixed3a")
    x = _inception_block(tf, x, 128, 128, 192, 32, 96, 64, "mixed3b")
    x = L.MaxPooling2D(3, strides=2, padding="same")(x)
    x = _inception_block(tf, x, 192, 96, 208, 16, 48, 64, "mixed4a")
    x = _inception_block(tf, x, 160, 112, 224, 24, 64, 64, "mixed4b")
    x = _inception_block(tf, x, 128, 128, 256, 24, 64, 64, "mixed4c")
    x = _inception_block(tf, x, 112, 144, 288, 32, 64, 64, "mixed4d")
    x = _inception_block(tf, x, 256, 160, 320, 32, 128, 128, "mixed4e")
    x = L.MaxPooling2D(3, strides=2, padding="same")(x)
    x = _inception_block(tf, x, 256, 160, 320, 32, 128, 128, "mixed5a")
    x = _inception_block(tf, x, 384, 192, 384, 48, 128, 128, "mixed5b")
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dropout(0.4)(x)
    out = L.Dense(num_classes, activation="softmax", name="logits")(x)
    m = tf.keras.Model(inp, out)
    m.compile(optimizer=tf.keras.optimizers.SGD(0.0898, momentum=0.9),
              loss="sparse_categorical_crossentropy")
    return m


def keras_spec(tf_model) -> dict:
    """What the converter and ``KerasModel`` read of a compiled tf.keras
    functional model, as plain JSON data: ``get_config()``, each layer's
    class name, ``get_build_config()`` and weight shapes, and the compile
    facts (the loss, the optimizer's class name and float32 learning
    rate, ``metrics_names``).  ``inception_v1.json`` is this of
    ``build_tf_inception_v1(1000, 224)``; no TensorFlow is imported."""
    import json

    import numpy as np
    layers = []
    for layer in tf_model.layers:
        build = layer.get_build_config() \
            if hasattr(layer, "get_build_config") else None
        layers.append({"name": layer.name,
                       "class_name": type(layer).__name__,
                       "build_config": build,
                       "weight_shapes": [list(w.shape)
                                         for w in layer.get_weights()]})
    spec = {"config": tf_model.get_config(), "layers": layers,
            "compile": {
                "loss": tf_model.loss,
                "optimizer": type(tf_model.optimizer).__name__,
                "learning_rate": float(np.float32(np.asarray(
                    tf_model.optimizer.learning_rate))),
                "metrics_names": list(tf_model.metrics_names)}}
    return json.loads(json.dumps(spec))


def inception_v1_spec() -> dict:
    """The committed ``inception_v1.json``: ``keras_spec`` of
    ``build_tf_inception_v1(1000, 224)``."""
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "inception_v1.json")
    with open(path) as f:
        return json.load(f)


def run_inception_bench(device, image_size: int = 224,
                        num_classes: int = 1000, batch_size: int = 64,
                        rows: int = 512, timed_epochs: int = 3,
                        warm_epochs: int = 1):
    import numpy as np

    from analytics_zoo_torch.tfpark import KerasModel

    kind = device_kind(device)
    rs = np.random.RandomState(0)
    x = rs.rand(rows, image_size, image_size, 3).astype(np.float32)
    y = rs.randint(0, num_classes, (rows, 1))

    t0 = time.time()
    tfm = build_tf_inception_v1(num_classes, image_size)
    model = KerasModel(tfm)
    convert_s = time.time() - t0
    n_layers = len(tfm.layers)

    t0 = time.time()
    history = model.fit(x, y, batch_size=batch_size,
                        epochs=warm_epochs + timed_epochs)
    fit_wall = time.time() - t0

    steps = rows // batch_size
    epoch_samples = steps * batch_size
    # per-epoch history; the first warm_epochs pay the builds and captures
    steady = sorted(r["throughput"] for r in history[warm_epochs:])
    tput = steady[len(steady) // 2]

    return {
        "metric": "inception_v1_tfpark_train_throughput",
        "value": round(tput, 1),
        "unit": "imgs/sec/chip",
        "vs_baseline": None,
        "workload": "inception",
        "image_size": image_size,
        "batch_size": batch_size,
        "rows": rows,
        "timed_epochs": timed_epochs,
        "tf_layers_converted": n_layers,
        "convert_time_s": round(convert_s, 2),
        "fit_wall_s": round(fit_wall, 2),
        "epoch_throughputs": [round(r["throughput"], 1)
                              for r in history],
        "epoch_time_s": round(epoch_samples / tput, 3),
        "includes_h2d": True,
        "device": str(device),
        "device_kind": kind,
    }


def device_kind(device) -> str:
    """The name of the card the zoo context runs on
    (``torch.cuda.get_device_name``), or "cpu".  ``device`` must be that
    device: the models run on the context's device whatever is passed,
    and ``init_zoo_context`` raises when the live context is on another
    one."""
    import torch

    from analytics_zoo_torch.common.zoo_context import init_zoo_context
    ran = init_zoo_context(device=device).device
    if ran.type == "cuda":
        return torch.cuda.get_device_name(ran)
    return ran.type
