"""Estimator — the training loop, single device (port of
``pipeline/estimator/estimator.py``).

``train`` runs the reference's per-step loop: each epoch walks the
FeatureSet's deterministic batches through ``DistributedTrainer.prefetch``
(inline, or ``data.prefetch`` deep on a thread), one
``DistributedTrainer.train_step_at`` each, until the end trigger fires;
an epoch appends ``{"epoch", "loss", "throughput", "wall_s"}`` to
``history``, its loss the mean of the epoch's step losses (what the
reference's whole-epoch scan reports for an in-memory FeatureSet), and
with a ``validation_set`` and ``validation_method`` also ``"val"``, the
validation scores after the epoch.  The step losses stay on the device;
the epoch's mean is the one value read back per epoch.  ``evaluate`` and
``predict`` run the eval and predict steps over ordered batches with a
padded tail.

With a ``model_dir``, training checkpoints and recovers as the
reference's does (Topology.scala:1179-1306):

- at entry the latest ``snapshot.<iteration>.ckpt`` there is restored —
  params, state, optimizer state, epoch and iteration — and training
  resumes from it; a snapshot that cannot be read or does not match the
  model raises (training never starts fresh beside it);
- when ``checkpoint_trigger`` fires (default ``EveryEpoch()``: after
  each epoch's record) the payload ``{"params", "state", "opt_state",
  "epoch", "iteration"}`` is written in the JAX package's layout
  (``utils/serialization.Checkpoint``), so a snapshot either package
  writes resumes in the other;
- a failure inside an epoch goes to ``resilience/policy.RecoveryPolicy``
  (``elastic=False``): a transient or unknown failure within the
  ``train.retry_times`` / ``train.retry_interval_s`` budget restores the
  latest snapshot and replays from it; a poisoned or unrecoverable one,
  an exhausted budget, or no ``model_dir`` raises.  As in the reference,
  a retry before the first snapshot replays the epoch from the state it
  reached.

Counters ``checkpoint_save_total``, ``checkpoint_restore_total``,
``train_retry_total``, ``train_failures_total{class}`` and
``train_recovery_total{action}``; ``checkpoint_save`` and
``checkpoint_restore`` spans (with ``bytes`` and the snapshot's
``iteration``); ``train.failure``/``train.retry`` flight-recorder events.

Not ported: TensorBoard summaries, the watchdog and its halt snapshot,
``DataPipeline`` state in the snapshot, mesh re-formation and the
degraded exit, the chunked and whole-epoch dispatch engines, the
device-resident validation cache.

``optim_methods={group: (OptimMethod, layer names or "*")}`` trains each
group of layers with its own optimizer (the reference's multi-optimMethod
split; ``parallel/trainer.py``): the optimizer state, and a snapshot's
``opt_state``, are ``{group: state}``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.common.triggers import (
    EveryEpoch, MaxEpoch, Trigger, TrainingState,
)
from analytics_zoo_torch.parallel.trainer import (
    ClipSpec, DistributedTrainer,
)
from analytics_zoo_torch.pipeline.api.keras.topology import (
    to_device, tree_leaves, tree_map,
)

log = logging.getLogger("analytics_zoo_torch.estimator")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"Estimator {what} is not ported to the PyTorch package yet "
        "(ROADMAP.md, port queue)")


def _train_metrics():
    """The training loop's instruments in the shared registry
    (get-or-create, cheap to call per ``train``)."""
    from analytics_zoo_torch.observability import get_registry
    reg = get_registry()
    return {
        "ckpt_save": reg.counter(
            "checkpoint_save_total", "checkpoint snapshots written"),
        "ckpt_restore": reg.counter(
            "checkpoint_restore_total",
            "checkpoint restores (resume + failure recovery)"),
        "retries": reg.counter(
            "train_retry_total",
            "training-step failures absorbed by the retry loop"),
        "failures": reg.counter(
            "train_failures_total",
            "mid-training failures by classified cause",
            labels=("class",)),
        "recoveries": reg.counter(
            "train_recovery_total",
            "recovery actions taken by the failure policy engine",
            labels=("action",)),
    }


def predict_in_batches(run_batch, x, batch_size: int):
    """Fixed-shape batched prediction: zero-pad the tail batch, slice the
    padding back off, concatenate on the host.  ``run_batch`` takes a host
    batch and returns a device tensor, or a list of them for a model of
    several outputs (then a list of arrays comes back); ``window``
    batches stay in flight on the device while older results stream to
    the host."""
    n = len(tree_leaves(x)[0])
    if n == 0:
        raise ValueError("predict called with an empty input")
    window = 8
    outs, in_flight = [], []
    for b in range(math.ceil(n / batch_size)):
        lo, hi = b * batch_size, min((b + 1) * batch_size, n)
        xb = tree_map(lambda a: np.asarray(a)[lo:hi], x)
        real = hi - lo
        if real < batch_size:   # keep one batch shape
            xb = tree_map(
                lambda a: np.concatenate(
                    [a, np.zeros((batch_size - real,) + a.shape[1:],
                                 a.dtype)]), xb)
        in_flight.append(tree_map(lambda o: o[:real], run_batch(xb)))
        if len(in_flight) >= window:
            outs.append(tree_map(_to_host, in_flight.pop(0)))
    outs.extend(tree_map(_to_host, o) for o in in_flight)
    return tree_map(lambda *parts: np.concatenate(parts), *outs)


def _to_host(t) -> np.ndarray:
    return t.cpu().numpy()


class Estimator:
    def __init__(self, model, optim_method=None,
                 optim_methods: Optional[Dict] = None,
                 model_dir: Optional[str] = None):
        from analytics_zoo_torch.pipeline.api.keras import optimizers
        self.model = model
        self.optim_method = optimizers.get(optim_method)
        self.optim_groups = optim_methods
        self.model_dir = model_dir
        self._clip: Optional[ClipSpec] = None
        self.variables = None
        self.history: List[Dict] = []
        self.train_state = TrainingState()

    # ------------------------------------------------------------- settings
    def set_constant_gradient_clipping(self, min_value, max_value):
        self._clip = ClipSpec("const", float(min_value), float(max_value))

    def set_l2_norm_gradient_clipping(self, clip_norm):
        self._clip = ClipSpec("l2norm", float(clip_norm))

    def clear_gradient_clipping(self):
        self._clip = None

    def set_tensorboard(self, log_dir: str, app_name: str):
        raise _not_ported("set_tensorboard")

    # ------------------------------------------------------------- training
    def train(self, train_set, criterion,
              end_trigger: Optional[Trigger] = None,
              checkpoint_trigger: Optional[Trigger] = None,
              validation_set=None, validation_method=None,
              batch_size: int = 32, rng: Optional[int] = None):
        """Train on a FeatureSet until ``end_trigger`` (default one
        epoch), scoring ``validation_method`` on ``validation_set`` after
        each epoch, and with a ``model_dir`` snapshotting when
        ``checkpoint_trigger`` fires (default every epoch).  ``rng`` is
        the integer seed of the dropout generators (default
        ``data.shuffle_seed``)."""
        from analytics_zoo_torch.observability import get_tracer
        from analytics_zoo_torch.observability.flightrec import record_event
        from analytics_zoo_torch.pipeline.api.keras import objectives
        from analytics_zoo_torch.resilience.policy import (
            RecoveryAction, RecoveryPolicy, RetryBudget)
        from analytics_zoo_torch.utils.serialization import Checkpoint
        if self.optim_method is None and not self.optim_groups:
            raise ValueError("Estimator needs an optim_method to train")
        criterion = objectives.get(criterion)
        end_trigger = end_trigger or MaxEpoch(1)
        checkpoint_trigger = checkpoint_trigger or EveryEpoch()
        cfg = get_config()
        seed = int(rng if rng is not None else cfg.get("data.shuffle_seed"))
        trainer = DistributedTrainer(self.model, criterion,
                                     optim_method=self.optim_method,
                                     clip=self._clip,
                                     optim_groups=self.optim_groups)
        if train_set.size < batch_size:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{train_set.size}: no full training batch can be formed "
                "(training drops the remainder batch)")

        if self.variables is None:
            self.variables = self.model.get_variables()
        params = trainer.place_params(self.variables["params"])
        state = trainer.replicate(self.variables["state"])
        opt_state = trainer.init_opt_state(params)
        ts = self.train_state
        ckpt = Checkpoint(self.model_dir) if self.model_dir else None
        met = _train_metrics()
        tracer = get_tracer()

        def save_snapshot():
            start = time.perf_counter()
            path = ckpt.save({"params": params, "state": state,
                              "opt_state": opt_state, "epoch": ts.epoch,
                              "iteration": ts.iteration}, step=ts.iteration)
            tracer.complete("checkpoint_save", start,
                            time.perf_counter() - start,
                            iteration=ts.iteration,
                            bytes=os.path.getsize(path))
            met["ckpt_save"].inc()

        def restore_snapshot() -> bool:
            """The latest snapshot into params, state, opt_state and the
            counters; False when the directory holds none."""
            nonlocal params, state, opt_state
            path = ckpt.latest_path() if ckpt is not None else None
            if path is None:
                return False
            start = time.perf_counter()
            restored = ckpt.restore_latest(
                {"params": params, "state": state, "opt_state": opt_state,
                 "epoch": 0, "iteration": 0})
            params, state = restored["params"], restored["state"]
            opt_state = restored["opt_state"]
            ts.epoch = int(restored["epoch"])
            ts.iteration = int(restored["iteration"])
            tracer.complete("checkpoint_restore", start,
                            time.perf_counter() - start,
                            iteration=ts.iteration,
                            bytes=os.path.getsize(path))
            met["ckpt_restore"].inc()
            return True

        if restore_snapshot():
            log.info("resumed from checkpoint at epoch %d iter %d",
                     ts.epoch, ts.iteration)
        eval_runner = None
        if validation_set is not None and validation_method:
            eval_runner = trainer.make_eval_runner(list(validation_method))
        # the reference's failure policy (resilience/policy.py): the
        # time-windowed retry budget is the TRANSIENT/UNKNOWN branch; one
        # device, so a lost host takes that budget too
        policy = RecoveryPolicy(
            RetryBudget(int(cfg.get("train.retry_times")),
                        float(cfg.get("train.retry_interval_s"))),
            elastic=False)

        while not end_trigger(ts):
            epoch_start = time.perf_counter()
            seen, steps, loss_sum, stop = 0, 0, None, False
            try:
                for batch in trainer.prefetch(train_set.epoch_batches(
                        ts.epoch, batch_size, train=True)):
                    params, opt_state, state, loss = trainer.train_step_at(
                        params, opt_state, state, batch, seed, ts.iteration)
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    steps += 1
                    ts.iteration += 1
                    seen += batch_size
                    # iteration-level triggers (SeveralIteration,
                    # MaxIteration) fire mid-epoch
                    if ckpt is not None and checkpoint_trigger(ts):
                        save_snapshot()
                    if end_trigger(ts):
                        stop = True
                        break
            except Exception as exc:   # noqa: BLE001 — the policy engine
                decision = policy.decide(exc,
                                         have_checkpoint=ckpt is not None)
                met["failures"].labels(decision.failure_class.value).inc()
                record_event(
                    "train.failure",
                    classification=decision.failure_class.value,
                    action=decision.action.name.lower(),
                    iteration=ts.iteration,
                    cause=f"{type(exc).__name__}: {exc}"[:200])
                if decision.action is not RecoveryAction.RETRY:
                    log.error("training failure classified %s is not "
                              "recoverable here: %s",
                              decision.failure_class.value, decision.reason)
                    raise
                met["retries"].inc()
                met["recoveries"].labels("retry").inc()
                record_event("train.retry",
                             classification=decision.failure_class.value,
                             retries_left=policy.budget.remaining,
                             iteration=ts.iteration)
                log.warning("training step failed (%s: %s); restoring the "
                            "latest checkpoint (%d retries left)",
                            decision.failure_class.value, exc,
                            policy.budget.remaining)
                restore_snapshot()
                continue
            if steps:
                ts.last_loss = float(loss_sum / steps)   # the epoch's sync
            if stop:
                break
            ts.epoch += 1
            ts.slice_index = 0
            ts.epoch_finished = True
            wall = time.perf_counter() - epoch_start
            record = {"epoch": ts.epoch, "loss": ts.last_loss,
                      "throughput": seen / max(wall, 1e-9), "wall_s": wall}
            if eval_runner is not None:
                scores = eval_runner(params, state,
                                     validation_set.epoch_batches(
                                         0, batch_size, train=False))
                record["val"] = scores
                ts.last_score = next(iter(scores.values()), None)
            self.history.append(record)
            if ckpt is not None and checkpoint_trigger(ts):
                save_snapshot()
            ts.epoch_finished = False

        self.variables = {"params": params, "state": state}
        self.model.set_variables(self.variables)
        return self

    # ------------------------------------------------------------ inference
    def _placed(self, trainer):
        variables = to_device(self.model.get_variables(), trainer.device)
        return variables["params"], variables["state"]

    def evaluate(self, data_set, criterion=None, validation_method=None,
                 batch_size: int = 32) -> Dict[str, float]:
        from analytics_zoo_torch.pipeline.api.keras import metrics as met
        methods = list(validation_method or [])
        if criterion is not None:
            methods = [met.Loss(criterion)] + methods
        trainer = DistributedTrainer(self.model, None)
        params, state = self._placed(trainer)
        return trainer.make_eval_runner(methods)(
            params, state, data_set.epoch_batches(0, batch_size, train=False))

    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        trainer = DistributedTrainer(self.model, None)
        params, state = self._placed(trainer)
        fn = trainer.predict_fn()
        return predict_in_batches(
            lambda xb: fn(params, state, trainer.put_batch(xb)), x,
            batch_size)
