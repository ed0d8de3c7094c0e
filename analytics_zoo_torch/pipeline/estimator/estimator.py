"""Estimator — the training loop, single device (port of
``pipeline/estimator/estimator.py``).

``train`` runs the reference's three dispatch routes, under its exact
gates (``pipeline/estimator/estimator.py:395-497``):

- **HBM epoch cache**: when ``train.steps_per_dispatch > 1``, the train
  set is exactly a ``FeatureSet``, the end trigger is a ``MaxEpoch`` and
  the checkpoint trigger an ``EveryEpoch``, and twice the dataset's bytes
  fit ``train.hbm_cache_mb``, the whole dataset is placed on the device
  once and permuted there each epoch (one index upload), and the epoch
  runs as ``DistributedTrainer.epoch_scan_fn`` over it: no host read and
  no host-to-device copy between its steps.  The epoch's loss is the mean
  of its steps' losses.  A failed placement trains chunked instead; a
  failure inside an HBM epoch (the budget cannot see free device memory)
  restores the latest snapshot and falls back to chunked dispatch, or,
  with no snapshot and no step of this call committed before that epoch,
  rebuilds from the entry-time variables, or else raises
  ``_UnrecoverableTraining``.
- **chunked dispatch**: under the same gates, the epoch goes to the
  device in chunks of ``train.steps_per_dispatch`` batches
  (``FeatureSet.epoch_chunks``), each run as ``epoch_scan_fn``; the
  epoch's loss is the last chunk's mean.
- **per-step dispatch** otherwise: one ``train_step_at`` a batch through
  ``prefetch`` (inline, or ``data.prefetch`` deep on a thread),
  iteration-level triggers firing between steps; the epoch's loss is the
  last step's.  At entry the step program is warmed (captured) on the
  first batch.
- **a** ``DataPipeline`` (``data/``) always takes the per-step route: a
  ``DeviceLoader`` (``data.prefetch`` deep) places its batches, and the
  pipeline fixes the batch size.  The step program is warmed at entry on
  a peeked batch, which is not consumed.  The pipeline's position
  commits per batch consumed and rides in the snapshot's ``data`` slot,
  so a resumed run starts mid-epoch on the exact next batch; a snapshot
  without that slot restores the model state and logs that the epoch's
  batches replay from the pipeline's current position.  A retry that
  finds no snapshot before any step of the call rewinds the pipeline to
  its position at entry.

The three routes take the same steps (same batches, same dropout
generators, ``step_generator(seed, iteration)``), so they end in the same
parameters; only the reported epoch loss follows the route, as in the
reference.  An epoch appends ``{"epoch", "loss", "throughput",
"wall_s"}`` to ``history``, and with a ``validation_set`` and
``validation_method`` also ``"val"``, the validation scores after the
epoch (on the eval batches placed once on the device when they fit the
budget beside the train cache).  ``evaluate`` and ``predict`` run the
eval and predict steps over ordered batches with a padded tail; a
``DataPipeline`` to evaluate or validate on must be built with
``remainder="pad"`` (``eval_batches``).

Counters ``checkpoint_save_total``, ``checkpoint_restore_total``,
``train_retry_total``, ``train_failures_total{class}`` and
``train_recovery_total{action}``; ``checkpoint_save`` and
``checkpoint_restore`` spans (with ``bytes`` and the snapshot's
``iteration``); ``train.failure``/``train.retry`` flight-recorder events.

A restore writes the snapshot's leaves into the training state's
tensors in place, so a captured step program keeps replaying on its
captured tensors.  The fault-injection site trips before every step on
every route (the port's fused routes are replays of a one-step program).

``set_tensorboard(log_dir, app_name)`` writes the reference's scalars
(``utils/summary.py``: JSONL and tfevents): ``Loss`` at each dispatch
that carries the iteration count across a multiple of 20 (the
dispatch's loss, at the count after it), ``Throughput`` after each epoch
at its count, and each validation score under its name.  The writers are
closed when ``train`` returns or raises.

Not ported: the watchdog and its halt snapshot, mesh re-formation and
the degraded exit.

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
import torch

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.common.triggers import (
    EveryEpoch, MaxEpoch, Trigger, TrainingState,
)
from analytics_zoo_torch.parallel.trainer import (
    ClipSpec, DistributedTrainer,
)
from analytics_zoo_torch.resilience.chaos import InjectedFault
from analytics_zoo_torch.pipeline.api.keras.topology import (
    to_device, tree_leaves, tree_map,
)

log = logging.getLogger("analytics_zoo_torch.estimator")


class _UnrecoverableTraining(RuntimeError):
    """A failure the retry machinery must not absorb: steps were
    committed and no snapshot can restore them."""


def _nbytes(tree) -> int:
    return sum(int(np.asarray(a).nbytes) for a in tree_leaves(tree)
               if a is not None)


def _assign(dst, src):
    """``src``'s values in ``dst``'s tensors, in place where a leaf's shape,
    dtype and device match (a captured step keeps its tensors); ``src``'s
    leaf elsewhere."""
    if isinstance(dst, dict) and isinstance(src, dict) and \
            dst.keys() == src.keys():
        return {k: _assign(dst[k], src[k]) for k in src}
    if isinstance(dst, tuple) and isinstance(src, tuple) and \
            type(dst) is type(src) and len(dst) == len(src):
        vals = [_assign(a, b) for a, b in zip(dst, src)]
        return type(src)(*vals) if hasattr(src, "_fields") else tuple(vals)
    if isinstance(dst, list) and isinstance(src, list) and \
            len(dst) == len(src):
        return [_assign(a, b) for a, b in zip(dst, src)]
    if isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor) and \
            dst.shape == src.shape and dst.dtype == src.dtype and \
            dst.device == src.device:
        if dst is not src:
            with torch.no_grad():
                dst.copy_(src)
        return dst
    return src


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


def eval_batches(data_set, batch_size: int):
    """Ordered, masked eval batches from either data layer: a
    ``FeatureSet`` (zero-padded tail + mask) or a ``DataPipeline`` built
    with ``remainder="pad"`` (which yields the same ``(x, y, mask)``
    shape).  The shared entry for ``evaluate`` and the in-training
    validation pass."""
    from analytics_zoo_torch.data import DataPipeline
    if isinstance(data_set, DataPipeline):
        if data_set.sampler.remainder != "pad":
            raise ValueError(
                "evaluation needs every sample exactly once: build the "
                "validation DataPipeline with remainder='pad' (and "
                "shuffle=False) so the tail batch is masked, not "
                "dropped")
        return (batch for _step, batch in data_set.iter_epoch(0))
    return data_set.epoch_batches(0, batch_size, train=False)


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
        self._train_summary = None
        self._val_summary = None
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
        from analytics_zoo_torch.utils.summary import (
            TrainSummary, ValidationSummary)
        self._train_summary = TrainSummary(log_dir, app_name)
        self._val_summary = ValidationSummary(log_dir, app_name)

    # ------------------------------------------------------------- training
    def train(self, train_set, criterion,
              end_trigger: Optional[Trigger] = None,
              checkpoint_trigger: Optional[Trigger] = None,
              validation_set=None, validation_method=None,
              batch_size: int = 32, rng: Optional[int] = None):
        """Train on a FeatureSet or a DataPipeline until ``end_trigger``
        (default one epoch), scoring ``validation_method`` on
        ``validation_set`` after each epoch, and with a ``model_dir``
        snapshotting when ``checkpoint_trigger`` fires (default every
        epoch).  ``rng`` is the integer seed of the dropout generators
        (default ``data.shuffle_seed``).  A pipeline's own batch size
        replaces ``batch_size``."""
        from analytics_zoo_torch.data import DataPipeline, DeviceLoader
        from analytics_zoo_torch.feature.feature_set import FeatureSet
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
        is_pipeline = isinstance(train_set, DataPipeline)
        if is_pipeline:
            # the pipeline owns its batch geometry (it is part of the
            # checkpointed stream identity): the argument is ignored
            batch_size = train_set.batch_size
        trainer = DistributedTrainer(self.model, criterion,
                                     optim_method=self.optim_method,
                                     clip=self._clip,
                                     optim_groups=self.optim_groups)
        if not is_pipeline and train_set.size < batch_size:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{train_set.size}: no full training batch can be formed "
                "(training drops the remainder batch)")

        if self.variables is None:
            self.variables = self.model.get_variables()
        params = trainer.place_params(self.variables["params"])
        # a copy as well: the step program writes the state fed back into
        # the tensors it captured, which must not be the model's
        state = trainer.place_params(self.variables["state"])
        opt_state = trainer.init_opt_state(params)
        ts = self.train_state
        ckpt = Checkpoint(self.model_dir) if self.model_dir else None
        met = _train_metrics()
        tracer = get_tracer()

        def save_snapshot():
            start = time.perf_counter()
            payload = {"params": params, "state": state,
                       "opt_state": opt_state, "epoch": ts.epoch,
                       "iteration": ts.iteration}
            if is_pipeline:
                # the position points at the NEXT batch to deliver
                # (committed per consumed batch): the snapshot resumes
                # mid-epoch exactly
                payload["data"] = train_set.state_dict()
            path = ckpt.save(payload, step=ts.iteration)
            tracer.complete("checkpoint_save", start,
                            time.perf_counter() - start,
                            iteration=ts.iteration,
                            bytes=os.path.getsize(path))
            met["ckpt_save"].inc()

        def restore_snapshot() -> bool:
            """The latest snapshot into params, state, opt_state (in place)
            and the counters; False when the directory holds none."""
            nonlocal params, state, opt_state
            path = ckpt.latest_path() if ckpt is not None else None
            if path is None:
                return False
            start = time.perf_counter()
            like = {"params": params, "state": state,
                    "opt_state": opt_state, "epoch": 0, "iteration": 0}
            if is_pipeline:
                like["data"] = train_set.state_dict()
            try:
                restored = ckpt.restore_latest(like)
            except (ValueError, KeyError):
                if "data" not in like:
                    raise
                # a snapshot saved without the pipeline's position
                del like["data"]
                restored = ckpt.restore_latest(like)
                log.warning(
                    "checkpoint has no data-pipeline state (pre-pipeline "
                    "snapshot); restored model state only — the epoch's "
                    "batches replay from the pipeline's current position")
            params = _assign(params, restored["params"])
            state = _assign(state, restored["state"])
            opt_state = _assign(opt_state, restored["opt_state"])
            ts.epoch = int(restored["epoch"])
            ts.iteration = int(restored["iteration"])
            if is_pipeline and restored.get("data") is not None:
                # seek to the checkpointed position: the resumed run
                # consumes the exact next batch
                train_set.load_state_dict(restored["data"])
            tracer.complete("checkpoint_restore", start,
                            time.perf_counter() - start,
                            iteration=ts.iteration,
                            bytes=os.path.getsize(path))
            met["ckpt_restore"].inc()
            return True

        if restore_snapshot():
            log.info("resumed from checkpoint at epoch %d iter %d",
                     ts.epoch, ts.iteration)
        # iteration count at entry to THIS call: "no step committed yet"
        # for the HBM-cache recovery means none beyond this point
        start_iteration = ts.iteration
        # the pipeline's position at entry: a retry with no snapshot to
        # restore and no step of this call committed rewinds to it, so
        # the batches the failed attempt consumed replay
        entry_data_state = train_set.state_dict() if is_pipeline else None
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

        # chunked dispatch and the HBM epoch cache only where the
        # semantics are provably unchanged: epoch-scoped triggers and the
        # EXACT FeatureSet class (a subclass may override epoch_batches)
        chunk_steps = int(cfg.get("train.steps_per_dispatch"))
        use_chunks = (chunk_steps > 1 and type(train_set) is FeatureSet
                      and isinstance(end_trigger, MaxEpoch)
                      and isinstance(checkpoint_trigger, EveryEpoch))
        chunk_fns: Dict[int, object] = {}
        hbm_src = None
        hbm_mb = float(cfg.get("train.hbm_cache_mb"))
        nbytes = 0
        if use_chunks and hbm_mb > 0:
            nbytes = _nbytes((train_set.x, train_set.y))
            if 2 * nbytes <= hbm_mb * (1 << 20):
                nb_epoch = train_set.size // batch_size
                epoch_rows = nb_epoch * batch_size
                try:
                    hbm_src = trainer.put_epoch_source(train_set.x,
                                                       train_set.y)
                    hbm_permute = trainer.permute_rows_fn()
                    hbm_scan = trainer.epoch_scan_fn(nb_epoch, batch_size)
                except Exception:   # noqa: BLE001 — train chunked instead
                    hbm_src = None
                    log.warning("HBM epoch cache placement failed; falling "
                                "back to chunked dispatch", exc_info=True)
                else:
                    log.info("HBM epoch cache active: %.1f MB on device, %d "
                             "steps/epoch, on-device reshuffle",
                             nbytes / (1 << 20), nb_epoch)
        hbm_train_bytes = 2 * nbytes if hbm_src is not None else 0

        # the eval batches placed once when they fit beside the train cache
        eval_cache = [None]
        if (eval_runner is not None and hbm_mb > 0
                and type(validation_set) is FeatureSet):
            val_bytes = _nbytes((validation_set.x, validation_set.y))
            if val_bytes + hbm_train_bytes <= hbm_mb * (1 << 20):
                try:
                    eval_cache[0] = [
                        trainer.put_batch(b) for b in
                        validation_set.epoch_batches(0, batch_size,
                                                     train=False)]
                    log.info("eval-batch HBM cache active: %.1f MB on "
                             "device", val_bytes / (1 << 20))
                except Exception:   # noqa: BLE001
                    eval_cache[0] = None
                    log.warning("eval-batch HBM cache placement failed; "
                                "streaming per epoch", exc_info=True)

        # the eval step reads its weights by identity (borrowed): params
        # stay the same tensors, updated in place, while each step hands
        # back new state tensors, so the state is copied into tensors of
        # the eval's own
        eval_state = [None]

        def run_eval():
            eval_state[0] = tree_map(torch.clone, state) \
                if eval_state[0] is None else _assign(eval_state[0], state)
            if eval_cache[0] is not None:
                try:
                    return eval_runner(params, eval_state[0], eval_cache[0])
                except Exception:   # noqa: BLE001
                    eval_cache[0] = None
                    log.warning("eval failed with cached batches; released "
                                "the cache, retrying streamed",
                                exc_info=True)
            return eval_runner(params, eval_state[0],
                               eval_batches(validation_set, batch_size))

        def advance():
            ts.iteration += 1

        def hbm_epoch():
            """The epoch over the device-resident rows, permuted on the
            device: one dispatch of its ``nb_epoch`` steps."""
            xs, ys = hbm_src
            if train_set.shuffle:
                perm = train_set._epoch_perm(ts.epoch)[:epoch_rows]
                xe, ye = hbm_permute(xs, ys, perm)
            else:
                xe, ye = xs, ys
            with tracer.span("train_epoch_scan", steps=nb_epoch):
                out = hbm_scan(params, opt_state, state, xe, ye, seed,
                               ts.iteration, on_step=advance)
            # an execution failure surfaces here, inside the recovery
            # scope: one scalar read an epoch
            float(out[3])
            return out

        def dispatches():
            """This epoch's dispatches on the route, as (steps, run):
            ``run()`` takes the steps, advancing ``ts.iteration`` by them,
            and returns ``(params, opt_state, state, loss)``, the loss the
            mean of its steps' (the reported epoch loss is the last
            dispatch's: the HBM epoch's mean, the last chunk's mean, the
            last step's)."""
            if is_pipeline:
                for batch in device_loader.epoch():
                    def run(batch=batch):
                        out = trainer.train_step_at(params, opt_state, state,
                                                    batch, seed, ts.iteration)
                        advance()
                        return out
                    yield 1, run
            elif hbm_src is not None:
                yield nb_epoch, hbm_epoch
            elif use_chunks:
                chunks = ((x, y) for x, y, _ in train_set.epoch_chunks(
                    ts.epoch, batch_size, chunk_steps))
                for xc, yc in trainer.prefetch(chunks):
                    k = len(tree_leaves(xc)[0]) // batch_size
                    if k not in chunk_fns:
                        chunk_fns[k] = trainer.epoch_scan_fn(k, batch_size)

                    def run(fn=chunk_fns[k], xc=xc, yc=yc, k=k):
                        with tracer.span("train_dispatch", steps=k):
                            return fn(params, opt_state, state, xc, yc, seed,
                                      ts.iteration, on_step=advance)
                    yield k, run
            else:
                for batch in trainer.prefetch(train_set.epoch_batches(
                        ts.epoch, batch_size, train=True)):
                    def run(batch=batch):
                        out = trainer.train_step_at(params, opt_state, state,
                                                    batch, seed, ts.iteration)
                        advance()
                        return out
                    yield 1, run

        def leave_hbm(epoch_iteration: int) -> None:
            """After a failure inside an HBM epoch: train chunked from the
            latest snapshot, or, with none and no step of this call
            committed before that epoch, from the entry-time variables;
            else ``_UnrecoverableTraining``."""
            nonlocal hbm_src, params, state, opt_state
            hbm_src = None
            eval_cache[0] = None
            if restore_snapshot():
                log.warning("HBM epoch cache failed (likely OOM); restored "
                            "checkpoint, falling back to chunked dispatch",
                            exc_info=True)
                return
            if epoch_iteration == start_iteration:
                log.warning("HBM epoch cache failed (likely OOM) before any "
                            "step; falling back to chunked dispatch",
                            exc_info=True)
                params = _assign(params, trainer.place_params(
                    self.variables["params"]))
                state = _assign(state, trainer.place_params(
                    self.variables["state"]))
                opt_state = _assign(opt_state,
                                    trainer.init_opt_state(params))
                ts.iteration = start_iteration
                return
            raise _UnrecoverableTraining(
                f"HBM epoch cache failed at iteration {ts.iteration} with "
                "no checkpoint to restore; set model_dir or "
                "train.hbm_cache_mb=0")

        device_loader = None
        if is_pipeline:
            device_loader = DeviceLoader(train_set, put_fn=trainer.put_batch)
            # warm (capture) the step program on a peeked batch: a pure
            # read, the position commits only per batch the loader hands
            # out
            try:
                warm_batch = next(iter(train_set.iter_epoch(
                    train_set.epoch, start_step=train_set.step)))[1]
            except StopIteration:
                warm_batch = None
            if warm_batch is not None:
                trainer.warm_start(params, opt_state, state, warm_batch,
                                   seed)

        try:
            while not end_trigger(ts):
                epoch_start = time.perf_counter()
                epoch_iteration = ts.iteration
                seen, loss, stop, again = 0, None, False, False
                try:
                    for steps, run in dispatches():
                        try:
                            params, opt_state, state, loss = run()
                        except InjectedFault:
                            raise     # injected faults go to the policy below
                        except Exception:   # noqa: BLE001 — recovery below
                            if hbm_src is None:
                                raise
                            leave_hbm(epoch_iteration)
                            again = True
                            break
                        seen += steps * batch_size
                        # the reference's Loss scalar: at each dispatch
                        # that carries the count across a multiple of 20
                        if self._train_summary is not None and \
                                ts.iteration // 20 != \
                                (ts.iteration - steps) // 20:
                            self._train_summary.add_scalar(
                                "Loss", float(loss), ts.iteration)
                        # iteration-level triggers (SeveralIteration,
                        # MaxIteration) fire mid-epoch
                        if ckpt is not None and checkpoint_trigger(ts):
                            save_snapshot()
                        if end_trigger(ts):
                            stop = True
                            break
                except _UnrecoverableTraining:
                    raise
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
                    if not restore_snapshot() and is_pipeline and \
                            ts.iteration == start_iteration:
                        train_set.load_state_dict(entry_data_state)
                    continue
                if again:
                    continue
                # the route's loss: the HBM epoch's mean, the last chunk's
                # mean, or the last step's (the epoch's one host read)
                if loss is not None:
                    ts.last_loss = float(loss)
                if stop:
                    break
                ts.epoch += 1
                ts.slice_index = 0
                ts.epoch_finished = True
                wall = time.perf_counter() - epoch_start
                record = {"epoch": ts.epoch, "loss": ts.last_loss,
                          "throughput": seen / max(wall, 1e-9), "wall_s": wall}
                if self._train_summary is not None:
                    self._train_summary.add_scalar(
                        "Throughput", record["throughput"], ts.iteration)
                if eval_runner is not None:
                    scores = run_eval()
                    record["val"] = scores
                    ts.last_score = next(iter(scores.values()), None)
                    if self._val_summary is not None:
                        for k, v in scores.items():
                            self._val_summary.add_scalar(k, v, ts.iteration)
                self.history.append(record)
                if ckpt is not None and checkpoint_trigger(ts):
                    save_snapshot()
                ts.epoch_finished = False

        finally:
            # the writers hold open files; one reopens on its next
            # scalar, so a later train() keeps recording
            for summary in (self._train_summary, self._val_summary):
                if summary is not None:
                    summary.close()

        self.variables = {"params": params, "state": state}
        self.model.set_variables(self.variables)
        return self

    # ------------------------------------------------------------ inference
    def _placed(self, trainer):
        variables = to_device(self.model.get_variables(), trainer.device)
        return variables["params"], variables["state"]

    def _infer_trainer(self) -> DistributedTrainer:
        """The trainer of evaluate and predict, kept across calls so their
        programs are captured once per Estimator, not once per call."""
        if getattr(self, "_cached_infer_trainer", None) is None:
            self._cached_infer_trainer = DistributedTrainer(self.model, None)
            self._cached_eval_runner = (None, None)
        return self._cached_infer_trainer

    def evaluate(self, data_set, criterion=None, validation_method=None,
                 batch_size: int = 32) -> Dict[str, float]:
        from analytics_zoo_torch.pipeline.api.keras import metrics as met
        methods = list(validation_method or [])
        trainer = self._infer_trainer()
        # the runner of the last criterion and metric objects only: other
        # objects replace its programs rather than adding to them
        objs = (criterion, *methods)
        cached, runner = self._cached_eval_runner
        if cached is None or len(cached) != len(objs) or \
                any(a is not b for a, b in zip(cached, objs)):
            if criterion is not None:
                methods = [met.Loss(criterion)] + methods
            runner = trainer.make_eval_runner(methods)
            self._cached_eval_runner = (objs, runner)
        params, state = self._placed(trainer)
        return runner(params, state, eval_batches(data_set, batch_size))

    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        trainer = self._infer_trainer()
        params, state = self._placed(trainer)
        fn = trainer.predict_fn()
        return predict_in_batches(
            lambda xb: fn(params, state, trainer.put_batch(xb)), x,
            batch_size)
