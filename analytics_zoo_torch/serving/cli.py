"""Cluster Serving CLI — the scripts/cluster-serving entry points
(reference cluster-serving-start/stop shells + ClusterServing.main,
serving/ClusterServing.scala:44).

``start`` reads config.yaml, builds the model from ``model: builder:``
(a "pkg.module:function" returning a model of this package: a KerasNet
or a ZooModel), loads ``model: weights:`` (a ``save_model`` file of
either package) or, without it, draws its weights, and runs the serving
loop against Redis (``python -m analytics_zoo_torch.serving.cli start
--config config.yaml``).  ``stop`` sets the cross-process stop key.
"""

from __future__ import annotations

import argparse
import importlib
import sys


def _build_model(spec: str, weights: str = None):
    """Build the port's model named by ``spec``, then load ``weights`` (a
    ``save_model`` file; missing or mismatched raises, never random
    weights) or, without it, draw its weights."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise SystemExit(
            f"model builder {spec!r} must look like pkg.module:function")
    from analytics_zoo_torch.models.common import ZooModel
    fn = getattr(importlib.import_module(mod_name), fn_name)
    model = fn()
    if weights:
        model.load_weights(weights)
    else:
        (model.model if isinstance(model, ZooModel) else model).init()
    return model


def _send_stop(cfg):
    import time

    from analytics_zoo_torch.serving.redis_client import connect
    from analytics_zoo_torch.serving.server import STOP_KEY
    broker = connect(cfg.redis_url)
    broker.hset(STOP_KEY, {"stop": str(time.time())})
    return broker


def _parse_endpoints(spec: str):
    """``params.endpoints`` / ``--endpoints``: comma/whitespace-
    separated ``name=pkg.module:builder`` entries."""
    out = []
    for item in spec.replace(",", " ").split():
        name, sep, builder = item.partition("=")
        if not sep or not name or not builder:
            raise SystemExit(
                f"endpoint spec {item!r} must look like "
                "name=pkg.module:builder")
        out.append((name.strip(), builder.strip()))
    return out


def _start(cfg, args):
    builder = args.builder or cfg.extra.get("model.builder")
    if not builder:
        raise SystemExit("start needs --builder or config model: builder:")
    weights = args.weights or cfg.extra.get("model.weights")
    model = _build_model(builder, weights)

    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.serving.server import ClusterServing
    im = InferenceModel().load_zoo(model, quantize=args.quantize)
    serving = ClusterServing(im, cfg)
    # multi-model endpoints beside the default model: records with an
    # ``endpoint`` field (and HTTP /predict/<name>) route to these
    if cfg.endpoints:
        for name, ep_builder in _parse_endpoints(cfg.endpoints):
            ep_model = InferenceModel().load_zoo(
                _build_model(ep_builder), quantize=args.quantize)
            serving.register_endpoint(name, ep_model)
    # graceful drain: SIGTERM (supervisor / orchestrator shutdown) →
    # finish + ack in-flight batches, flush metrics, exit 0
    serving.install_signal_handlers()
    serving.run()
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="cluster-serving")
    p.add_argument("command",
                   choices=["init", "start", "stop", "restart",
                            "shutdown"])
    p.add_argument("--config", "-c", default="config.yaml")
    p.add_argument("--builder", default=None,
                   help="pkg.module:function returning a built model "
                        "(overrides config)")
    p.add_argument("--weights", default=None)
    p.add_argument("--redis", default=None, help="host:port")
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--consumer-group", default=None,
                   help="shared consumer group for replica fleets "
                        "(overrides config params: consumer_group)")
    p.add_argument("--consumer-name", default=None,
                   help="this replica's unique consumer name "
                        "(overrides config params: consumer_name)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="expose Prometheus /metrics on this port "
                        "(0 = ephemeral; overrides config "
                        "params: metrics_port)")
    p.add_argument("--http-port", type=int, default=None,
                   help="HTTP/JSON fast-path port (0 = ephemeral; "
                        "overrides config params: http_port)")
    p.add_argument("--endpoints", default=None,
                   help="extra model endpoints, "
                        "'name=pkg.module:builder,...' (overrides "
                        "config params: endpoints)")
    args = p.parse_args(argv)

    import os
    from analytics_zoo_torch.serving.server import ServingConfig
    from analytics_zoo_torch.serving.redis_client import connect

    cfg = ServingConfig.from_yaml(args.config) \
        if os.path.exists(args.config) else ServingConfig()
    if args.redis:
        cfg.redis_url = args.redis
    if args.metrics_port is not None:
        cfg.metrics_port = args.metrics_port
    if args.http_port is not None:
        cfg.http_port = args.http_port
    if args.endpoints:
        cfg.endpoints = args.endpoints
    if args.consumer_group:
        cfg.consumer_group = args.consumer_group
    if args.consumer_name:
        cfg.consumer_name = args.consumer_name

    if args.command == "init":
        # validate the full setup without serving (ref
        # cluster-serving-init): broker reachable + model builds
        from analytics_zoo_torch.serving.server import INPUT_STREAM
        connect(cfg.redis_url).xlen(INPUT_STREAM)
        builder = args.builder or cfg.extra.get("model.builder")
        if builder:
            _build_model(builder,
                         args.weights or cfg.extra.get("model.weights"))
        print("Cluster Serving has been properly set up.")
        return 0

    if args.command == "stop":
        _send_stop(cfg)
        print("stop signal sent")
        return 0

    if args.command == "shutdown":
        # stop the worker AND the broker (ref cluster-serving-shutdown:
        # stop + redis-cli shutdown).  Wait for the worker to ACK the
        # stop (it DELETEs STOP_KEY after draining) before killing the
        # broker — shutting redis down first would crash the worker
        # mid-drain and lose read-past records.
        import time

        from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
        from analytics_zoo_torch.serving.server import STOP_KEY
        broker = _send_stop(cfg)
        if not isinstance(broker, EmbeddedBroker):
            deadline = time.time() + 30.0
            while broker.hgetall(STOP_KEY) and time.time() < deadline:
                time.sleep(0.1)
        try:
            broker.shutdown()
        except Exception:
            pass
        print("Cluster Serving is shutdown.")
        return 0

    if args.command == "restart":
        import time

        from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
        from analytics_zoo_torch.serving.server import STOP_KEY
        broker = _send_stop(cfg)
        if isinstance(broker, EmbeddedBroker):
            # in-process broker: no external worker can be listening —
            # clear our own signal and start directly
            broker.delete(STOP_KEY)
        else:
            # wait for the old worker to acknowledge (it DELETEs
            # STOP_KEY on shutdown) — starting immediately would let
            # the new worker consume its own stop signal, or steal the
            # old worker's
            deadline = time.time() + 30.0
            while broker.hgetall(STOP_KEY) and time.time() < deadline:
                time.sleep(0.1)
            if broker.hgetall(STOP_KEY):
                # no worker was running — clear the stale signal
                broker.delete(STOP_KEY)
        print("stop acknowledged; restarting")
        return _start(cfg, args)

    return _start(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
