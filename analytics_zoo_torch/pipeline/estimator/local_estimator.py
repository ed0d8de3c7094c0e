"""LocalEstimator — pure-local trainer with no distributed machinery (port
of the JAX package's ``pipeline/estimator/local_estimator.py``).

Reference: ``LocalEstimator`` (zoo/pipeline/estimator/LocalEstimator.scala)
trains on one node: ``fit(trainData, ..., batchSize, epochs)`` over
shuffled batches, with no triggers and no checkpoints: the lightest
entry point.

The port runs one step program on the zoo context's device: forward,
autograd backward (``DistributedTrainer.loss_and_grads``: the
regularization penalty, ``train.remat`` and frozen layers as in the
trainer) and the optimizer's OWN update, ``OptimMethod.update`` applied
in place — as the reference's step calls ``optim.update`` and
``optax.apply_updates``, never the fused one-pass update that only the
``DistributedTrainer`` takes.  The train, eval and predict steps are
built through ``compile.engine_jit`` under the reference's key hints
(``local_train_step``, ``local_eval_step``, ``local_predict_step``):
captured into CUDA graphs on the card, eager on the CPU.  Step ``it``
draws its dropout masks from ``step_generator(seed, it, device)``, the
generator the ``DistributedTrainer`` gives step ``it`` of a run seeded
``seed`` (the reference folds ``it`` into its key).

The training-health watchdog runs as in the reference: each step's
finite flag reaches it without a sync of its own, and under
``checkpoint_and_halt`` a halting issue raises ``TrainingHalted`` (this
engine has no checkpoints: the model keeps its last synced variables).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

log = logging.getLogger("analytics_zoo_torch.local_estimator")


class LocalEstimator:
    """Train/evaluate/predict a Keras-API model on the local device.

    ``model`` may be compiled or not; ``criterion``/``optim_method``
    accept the same string or object forms as ``KerasNet.compile``.
    """

    def __init__(self, model, criterion, optim_method,
                 metrics: Optional[Sequence] = None):
        from analytics_zoo_torch.pipeline.api.keras import (
            metrics as met, objectives, optimizers as opt)
        self.model = model
        self.loss_fn = objectives.get(criterion)
        self.optim = opt.get(optim_method)
        self.metrics = [met.get(m) for m in (metrics or [])]
        self.history: List[Dict] = []
        self._step = None
        self._eval_step = None
        self._predict_step = None

    def _device(self) -> torch.device:
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        return get_zoo_context().device

    # ------------------------------------------------------------- compile
    def _build_step(self):
        from analytics_zoo_torch.common.config import get_config
        from analytics_zoo_torch.compile import engine_jit
        from analytics_zoo_torch.observability import get_compile_monitor
        from analytics_zoo_torch.observability.watchdog import (
            fold_finiteness_check)
        from analytics_zoo_torch.parallel.trainer import (
            DistributedTrainer, mask_frozen_params)
        from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
        model, optim = self.model, self.optim
        # the trainer's forward and backward (remat, regularizers, frozen
        # layers); no optimizer is handed to it, so it builds no fused
        # update
        grads_of = DistributedTrainer(model, self.loss_fn).loss_and_grads
        check_finite = bool(get_config().get("observability.check_finite"))

        def step(params, opt_state, state, x, y, rng):
            loss, grads, new_state = grads_of(params, state, (x, y), rng)
            # the watchdog's NaN/Inf detector, the same fold the trainer's
            # step makes
            finite = (fold_finiteness_check(loss, grads)
                      if check_finite else None)

            def update():
                updates, new_opt_state = optim.update(grads, opt_state,
                                                      params)
                tree_map(lambda p, u: p.add_(u), params, updates)
                return new_opt_state
            with torch.no_grad():
                new_opt_state = mask_frozen_params(model, params, update)
            return params, new_opt_state, new_state, loss, finite

        return get_compile_monitor().wrap(
            "local_train_step",
            engine_jit(step, donate_argnums=(0, 1, 2),
                       key_hint="local_train_step"))

    def _current_step(self):
        """The step program, rebuilt whenever the model's frozen-layer
        set changes (a captured program bakes it in)."""
        frozen = (self.model.frozen_layer_names()
                  if hasattr(self.model, "frozen_layer_names") else set())
        if self._step is None or \
                getattr(self, "_step_frozen", None) != frozen:
            self._step = self._build_step()
            self._step_frozen = frozen
        return self._step

    # ----------------------------------------------------------------- fit
    def fit(self, x, y, validation_data=None, batch_size: int = 32,
            epochs: int = 1, rng: Optional[int] = None):
        """Train ``epochs`` epochs on arrays, a ``FeatureSet`` or a
        ``DataPipeline`` (whose batch size replaces ``batch_size``);
        ``rng`` is the integer seed of the dropout generators (default
        0).  Each epoch appends ``{"epoch", "loss", "throughput"}`` to
        ``history`` (``loss`` the epoch's last step's), and with
        ``validation_data`` and metrics also ``"val"``."""
        from analytics_zoo_torch.common.config import get_config
        from analytics_zoo_torch.data import DataPipeline
        from analytics_zoo_torch.feature.feature_set import FeatureSet
        from analytics_zoo_torch.observability import (
            EPOCH_BUCKETS, get_registry, get_tracer)
        from analytics_zoo_torch.observability.diagnostics import (
            step_attribution_histogram)
        from analytics_zoo_torch.observability.watchdog import (
            StepFlags, TrainingHalted, TrainingWatchdog,
            set_active_watchdog)
        from analytics_zoo_torch.parallel.trainer import (
            put_on_device, step_generator)
        from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
        pipeline = x if isinstance(x, DataPipeline) else None
        if pipeline is not None:
            data = pipeline
            batch_size = pipeline.batch_size
        else:
            data = x if isinstance(x, FeatureSet) \
                else FeatureSet.from_ndarrays(x, y)
            if data.size < batch_size:
                raise ValueError(
                    f"batch_size {batch_size} exceeds dataset size "
                    f"{data.size}")
        seed = int(rng) if rng is not None else 0
        device = self._device()

        variables = self.model.get_variables()
        # the step program writes (params, opt_state, state) in place:
        # train on copies, so the model's own variables are never
        # written (they keep the last synced values, a halt included)
        copy = lambda t: tree_map(  # noqa: E731
            lambda a: a.detach().to(device, copy=True), t)
        params = copy(variables["params"])
        state = copy(variables["state"])
        opt_state = self.optim.init(params)
        step_fn = self._current_step()
        flags = StepFlags()

        it = 0
        validate = validation_data is not None and self.metrics

        def sync_to_host():
            # copies: the next steps keep writing params and state
            self.model.set_variables({"params": tree_map(torch.clone,
                                                         params),
                                      "state": tree_map(torch.clone, state)})

        reg = get_registry()
        m_epoch = reg.histogram(
            "train_epoch_seconds", "wall time per completed epoch",
            labels=("engine",), buckets=EPOCH_BUCKETS)
        m_samples = reg.counter("train_samples_total",
                                "training samples consumed")
        # step-time attribution + sampled device bracket, the trainer's
        # shape (trainer._dispatch_instrumented)
        m_step_time = step_attribution_histogram(reg)
        device_every = int(
            get_config().get("observability.device_time_every") or 0)
        tracer = get_tracer()
        # training-health watchdog: this engine has no checkpoints, so
        # checkpoint_and_halt halts only (the model keeps its last
        # synced variables)
        watchdog = TrainingWatchdog()
        prev_watchdog = set_active_watchdog(watchdog)
        watchdog.start_stall_monitor()

        def health_check(wait: bool = False):
            # the steps' finite flags the device has computed (all of
            # them where the loop has just synchronized), then the policy
            flags.drain(wait=wait)
            issue = watchdog.poll()
            if issue is not None:
                raise TrainingHalted(
                    f"local training halted by watchdog at step {it}: "
                    f"{issue}", issue=issue)

        try:
            for epoch in range(epochs):
                t0 = time.perf_counter()
                seen = 0
                loss = None
                batches = iter(pipeline) if pipeline is not None \
                    else data.epoch_batches(epoch, batch_size, train=True)
                while True:
                    t_wait = time.perf_counter()
                    try:
                        bx, by = next(batches)
                    except StopIteration:
                        break
                    # host batch assembly = the local data_wait
                    m_step_time.labels("data_wait").observe(
                        time.perf_counter() - t_wait)
                    with tracer.span("train_step"):
                        t_step = time.perf_counter()
                        # the copy to the device is the dispatch's, as
                        # the reference's step takes host arrays
                        bx, by = put_on_device((bx, by), device)
                        params, opt_state, state, loss, finite = step_fn(
                            params, opt_state, state, bx, by,
                            step_generator(seed, it, device))
                        m_step_time.labels("host_dispatch").observe(
                            time.perf_counter() - t_step)
                        flags.push(finite)
                        if device_every > 0 and \
                                (it + 1) % device_every == 0:
                            # the sampled dispatch->ready bracket
                            if device.type == "cuda":
                                torch.cuda.synchronize(device)
                            m_step_time.labels("device").observe(
                                time.perf_counter() - t_step)
                    it += 1
                    seen += batch_size
                    watchdog.beat()
                    health_check()
                wall = time.perf_counter() - t0
                m_epoch.labels("local").observe(wall)
                m_samples.inc(seen)
                record = {"epoch": epoch + 1, "loss": float(loss),
                          "throughput": seen / max(wall, 1e-9)}
                watchdog.observe_loss(record["loss"])
                # the loss read synchronized the steps: every flag is in
                health_check(wait=True)
                if validate:   # evaluate() reads the model's variables
                    sync_to_host()
                    record["val"] = self.evaluate(
                        *validation_data, batch_size=batch_size)
                self.history.append(record)
                log.info("epoch %d loss %.4f%s (%.1f samples/s)",
                         epoch + 1, record["loss"],
                         f" val {record['val']}" if "val" in record else "",
                         record["throughput"])
        finally:
            watchdog.stop()
            set_active_watchdog(prev_watchdog)
        if not validate:
            sync_to_host()
        return self

    # ------------------------------------------------------------ evaluate
    def _placed_variables(self):
        from analytics_zoo_torch.pipeline.api.keras.topology import to_device
        variables = to_device(self.model.get_variables(), self._device())
        return variables["params"], variables["state"]

    def evaluate(self, x, y, batch_size: int = 32) -> Dict[str, float]:
        from analytics_zoo_torch.feature.feature_set import FeatureSet
        from analytics_zoo_torch.parallel.trainer import put_on_device
        from analytics_zoo_torch.pipeline.api.keras.metrics import accumulate
        data = x if isinstance(x, FeatureSet) \
            else FeatureSet.from_ndarrays(x, y)
        model, metrics = self.model, self.metrics
        if self._eval_step is None:
            from analytics_zoo_torch.compile import engine_jit

            def step(params, state, bx, by, mask):
                with torch.no_grad():
                    out, _ = model.apply(params, bx, state=state,
                                         training=False)
                    return tuple(m.batch_update(by, out, mask)
                                 for m in metrics)
            # the weights are read, never written: borrowed in place
            self._eval_step = engine_jit(step, borrow_argnums=(0, 1),
                                         key_hint="local_eval_step")
        params, state = self._placed_variables()
        device = self._device()
        return accumulate(
            metrics,
            (self._eval_step(params, state,
                             *put_on_device((bx, by, mask), device))
             for bx, by, mask in data.epoch_batches(0, batch_size,
                                                    train=False)))

    # ------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 256):
        from analytics_zoo_torch.parallel.trainer import put_on_device
        from analytics_zoo_torch.pipeline.estimator.estimator import (
            predict_in_batches)
        model = self.model
        if self._predict_step is None:
            from analytics_zoo_torch.compile import engine_jit

            def step(params, state, bx):
                with torch.no_grad():
                    out, _ = model.apply(params, bx, state=state,
                                         training=False)
                return out
            self._predict_step = engine_jit(
                step, borrow_argnums=(0, 1), key_hint="local_predict_step")
        params, state = self._placed_variables()
        device = self._device()
        return predict_in_batches(
            lambda xb: self._predict_step(params, state,
                                          put_on_device(xb, device)),
            x, batch_size)
