"""Cluster Serving quick start — the 60-second client demo (port of the
JAX package's ``serving/quick_start.py``): enqueue an image into the
Redis input stream, poll the output queue, print the top-N result.

Run against a live deployment (``zoo-serving start`` + redis):

    python -m analytics_zoo_torch.serving.quick_start --redis-url \
        redis://localhost:6379 --image cat.jpg

With no arguments it is fully self-contained: an embedded broker and a
background serving worker over a tiny classifier, so the round trip
demonstrates the full enqueue → decode → predict → result path with
zero external services.  The worker serves on the live zoo context's
device, or on ``init_zoo_context()``'s default (``cuda:0``): a caller
that wants the CPU calls ``init_zoo_context(device="cpu")`` first.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--redis-url", default=None,
                   help="redis://host:port of a live deployment; "
                        "default = self-contained embedded demo")
    p.add_argument("--image", default=None,
                   help="image file to classify; default = synthetic")
    p.add_argument("--uri", default="quick-start-0")
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--smoke", action="store_true",
                   help="CI mode: cap the result-poll timeout")
    args = p.parse_args(argv)
    if args.smoke:
        args.timeout = min(args.timeout, 15.0)

    import numpy as np

    from analytics_zoo_torch.serving.client import InputQueue, OutputQueue

    broker = None
    worker = serving = None
    if args.redis_url is None:
        # self-contained: embedded broker + background worker, on the
        # live context's device (get_zoo_context initialises the default)
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        get_zoo_context()

        from analytics_zoo_torch.pipeline.api.keras import Sequential
        from analytics_zoo_torch.pipeline.api.keras.layers import (
            Conv2D, Dense, Flatten)
        from analytics_zoo_torch.pipeline.inference import InferenceModel
        from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
        from analytics_zoo_torch.serving.server import (ClusterServing,
                                                      ServingConfig)
        model = Sequential()
        model.add(Conv2D(8, 3, 3, input_shape=(32, 32, 3),
                         activation="relu"))
        model.add(Flatten())
        model.add(Dense(5))
        model.compile("adam", "mse")
        broker = EmbeddedBroker()
        serving = ClusterServing(
            InferenceModel().load_zoo(model),
            ServingConfig(batch_size=4, top_n=3), broker=broker)
        worker = serving.start_background()

    inq = InputQueue(redis_url=args.redis_url, broker=broker)
    outq = OutputQueue(redis_url=args.redis_url, broker=broker)

    try:
        if args.image is not None:
            inq.enqueue_image(args.uri, args.image)   # path accepted
        else:
            arr = (np.random.RandomState(0)
                   .rand(32, 32, 3).astype(np.float32))
            inq.enqueue(args.uri, arr)

        t0 = time.time()
        result = outq.query(args.uri, timeout_s=args.timeout)
        if result is None:
            print(f"no result for {args.uri} within {args.timeout}s "
                  "(is the serving worker running?)")
        else:
            print(f"top-N for {args.uri} ({time.time() - t0:.2f}s): "
                  f"{result}")
    finally:
        if serving is not None:
            serving.stop()
            worker.join(timeout=10)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
