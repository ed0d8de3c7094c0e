"""The training engine, single device (port of ``parallel/trainer.py``).

The reference compiles one step — forward, backward, optimizer update —
into one XLA program over a device mesh and donates the old parameters
to it.  The port runs the same step eagerly on one device: autograd over
the plain ``{layer: {param: tensor}}`` tree gives the gradients, and the
update writes the parameters and the optimizer state in place (the
counterpart of donation).  By default the update is the fused one-pass
update of ``ops/fused.py`` (the CUDA kernels on the card); with
``train.fused_optimizer=false`` or ``ops.fused=off`` it is the
optimizer's own unfused ``update`` (gradient clipping first).

A step returns the model's new ``state`` (BatchNormalization's moving
statistics, computed without autograd) beside the params, and never reads
a value back to the host: the loss stays a device tensor until the caller
reports it.  Each step's dropout generators come
from ``step_generator(seed, step, device)``, so a run is reproducible on
the CPU and on the card alike; ``train_step_at`` makes that generator
itself from the run's seed and the step's index, as the reference folds
the step into its key inside the step.  ``prefetch`` places each batch
inline by default, or ``data.prefetch`` deep on a thread of its own
while the steps run.  Each step first trips the ``trainer.dispatch``
fault-injection site (``resilience/chaos.py``) at the trainer's 0-based
step count, before anything is computed, so a fault at step k leaves
exactly k steps committed.

With ``optim_groups`` (``{group: (OptimMethod, layer names or "*")}``,
the reference's multi-optimMethod split) each group's layers take their
own optimizer's update and the state is ``{group: state}``; groups turn
the fused update off, as in the reference.  With ``train.remat`` the
forward and the loss are recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant); the recompute draws its
dropout masks from a generator set to the step generator's state before
the forward, so it sees the first forward's masks, and the model's new
``state`` is the first forward's.

Every step program is built through ``compile.engine_jit``: the train
step (``train_step``, ``train_step_at``), the eval and predict steps,
and the device-resident epoch's step (``epoch_scan_fn``).  On the card
each is captured into a CUDA graph at its first call, or ahead of it by
``warm_start``, and replayed; on the CPU, or with ``compile.aot=false``,
it runs eagerly.  The fault-injection trip and the dispatch count stay
on the host, before the replay (the reference's
``_dispatch_instrumented``), and each dispatch observes its host wall as
``train_step_time_seconds{component="host_dispatch"}``.

The device-resident epoch (``epoch_scan_fn``, ``put_epoch``,
``put_epoch_source``, ``permute_rows_fn``): the reference scans
``num_batches`` steps in one XLA program.  The port replays a one-step
graph ``num_batches`` times over the epoch's rows on the device: the
step gathers its batch at a device offset that the graph itself
advances, so no batch crosses from the host inside a chunk, and each
step's dropout generator is set on the host before its replay, the same
generator the per-step route gives that step.  One graph of k steps
would need k sets of generators registered and k steps' activations in
one pool; the one-step graph serves every k, shares the per-step
route's memory footprint, and keeps the per-step fault-injection site
(the reference's fused program trips it only on its per-step route).

Not ported: the mesh and sharding, collectives accounting, MFU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.compile import engine_jit
from analytics_zoo_torch.observability.diagnostics import (
    get_compile_monitor, step_attribution_histogram)
from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map, tree_replace,
)
from analytics_zoo_torch.resilience.chaos import (
    SITE_TRAINER_DISPATCH, active_chaos,
)

_SEED_MOD = 2 ** 63


@dataclasses.dataclass
class ClipSpec:
    kind: str          # "const" | "l2norm"
    a: float = 0.0
    b: float = 0.0


def _apply_clipping(grads, clip: Optional[ClipSpec]):
    if clip is None:
        return grads
    if clip.kind == "const":
        return tree_map(lambda g: torch.clamp(g, clip.a, clip.b), grads)
    if clip.kind == "l2norm":
        from analytics_zoo_torch.pipeline.api.keras.optimizers import (
            global_norm)
        gnorm = global_norm(tree_leaves(grads))
        scale = torch.clamp(clip.a / (gnorm + 1e-12), max=1.0)
        return tree_map(lambda g: g * scale, grads)
    raise ValueError(clip.kind)


def mask_frozen_params(model, params, update: Callable):
    """Run ``update()``, which writes ``params`` in place, and keep the
    frozen layers' params bit-identical through it (restoring them also
    undoes weight decay, which zeroing their gradients would not)."""
    frozen = (model.frozen_layer_names()
              if hasattr(model, "frozen_layer_names") else set())
    saved = {k: tree_map(torch.clone, params[k]) for k in frozen
             if k in params}
    out = update()
    for k, tree in saved.items():
        tree_map(lambda dst, src: dst.copy_(src), params[k], tree)
    return out


def _group_params(params, groups: Dict[str, Sequence[str]]):
    """Split a top-level params dict into named disjoint groups:
    ``groups`` maps a group name to a list of top-level layer names, or
    to ``"*"``, the layers no other group names, in the params' order
    (Topology.scala:1130-1151)."""
    assigned = set()
    for names in groups.values():
        if names != "*":
            assigned.update(names)
    out = {}
    for gname, names in groups.items():
        if names == "*":
            out[gname] = [k for k in params if k not in assigned]
        else:
            out[gname] = list(names)
    return out


def put_on_device(batch, device):
    """Host arrays (a tree, None leaves allowed) onto ``device``.  On the
    card the copy goes through pinned memory, so it does not wait for the
    steps already queued."""
    def put(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor) and a.device == device:
            return a
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return tree_map(put, batch)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator training step ``step`` of a run seeded ``seed`` draws
    its dropout masks from, on ``device`` (the layers fold their names
    into it)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 +
             int(step) * 0xBF58476D1CE4E5B9 + 1) % _SEED_MOD
    return torch.Generator(device=device).manual_seed(mixed)


def _integer_leaf_message(params, path: str = "") -> str:
    """Name the first param leaf that is neither real nor complex: the
    gradient cannot be taken, as ``jax.grad`` refuses such an input in the
    reference (a ``TorchNet`` over BatchNorm carries the integer
    ``num_batches_tracked``)."""
    if isinstance(params, dict):
        for k, v in params.items():
            msg = _integer_leaf_message(v, f"{path}/{k}")
            if msg:
                return msg
        return ""
    if isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            msg = _integer_leaf_message(v, f"{path}/{i}")
            if msg:
                return msg
        return ""
    if torch.is_tensor(params) and not (params.is_floating_point() or
                                        params.is_complex()):
        return (f"grad requires real- or complex-valued inputs, but the "
                f"param leaf {path} is {params.dtype}")
    return ""


class DistributedTrainer:
    """Runs the train, eval and predict steps of one model on the zoo
    context's device."""

    def __init__(self, model, loss_fn: Optional[Callable],
                 optim_method=None, clip: Optional[ClipSpec] = None,
                 optim_groups: Optional[Dict[str, Tuple[Any, Sequence[str]]]]
                 = None):
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        self.model = model
        self.loss_fn = loss_fn
        self.optim = optim_method
        self.clip = clip
        self.optim_groups = optim_groups  # {name: (OptimMethod, names)}
        self.device = get_zoo_context().device
        self._dispatch_count = 0
        self._monitor = get_compile_monitor()
        self._m_step_time = step_attribution_histogram()
        self._train_step = None
        self._train_step_at = None
        self._epoch_steps: Dict[int, Any] = {}
        self._predict_step = None
        self._offset = None
        self._permuted = None
        cfg = get_config()
        self.remat = bool(cfg.get("train.remat"))
        self.grad_sync_dtype = str(cfg.get("train.grad_sync_dtype"))
        # fused optimizer update (ops/fused.py): clip + moment update +
        # param apply in ONE pass per leaf.  None = unsupported
        # (optimizer groups, an optimizer or clip it does not reproduce,
        # or train.fused_optimizer off): the optimizer's own update runs.
        self._fused_update = None
        if bool(cfg.get("train.fused_optimizer", True)) and \
                not self.optim_groups and self.optim is not None:
            from analytics_zoo_torch.ops.fused import build_fused_update
            self._fused_update = build_fused_update(self.optim, self.clip)

    # ------------------------------------------------------------ placement
    def place_params(self, params):
        """A copy of ``params`` on the device, for the steps to update in
        place (the caller's tensors are never written)."""
        return tree_map(lambda a: a.detach().to(self.device, copy=True),
                        params)

    def replicate(self, tree):
        return tree_map(lambda a: a.to(self.device), tree)

    def put_batch(self, batch):
        """Host arrays (a tree, None leaves allowed) onto the device
        (``put_on_device``)."""
        return put_on_device(batch, self.device)

    def prefetch(self, batches, depth: Optional[int] = None):
        """Place host batches (``put_batch``) ``depth`` deep ahead of the
        steps (default ``data.prefetch``): 0 places each batch inline; above
        0 a daemon thread pulls, places and queues them, overlapping host
        batch assembly and the host-to-device copy with the steps, at the
        cost of the interpreter lock it shares with them.  A worker's
        exception is raised to the consumer; a consumer that stops early
        (an iteration trigger) stops the worker.

        CUDA's current device is per thread, so the worker places under
        ``torch.cuda.device(self.device)``.  Its copy is issued on that
        device's default stream, the stream the steps run on, so a step
        that uses a batch is ordered after the batch's copy."""
        import queue
        import threading
        if depth is None:
            depth = int(get_config().get("data.prefetch"))
        if depth <= 0:
            for b in batches:
                yield self.put_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                with (torch.cuda.device(self.device)
                      if self.device.type == "cuda"
                      else contextlib.nullcontext()):
                    for b in batches:
                        if not put(self.put_batch(b)):
                            return
                put(end)
            except BaseException as e:   # handed on to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="zoo-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    # ----------------------------------------------------------- optimizer
    def _groups(self, params):
        return _group_params(
            params, {k: v[1] for k, v in self.optim_groups.items()})

    def init_opt_state(self, params):
        if self.optim_groups:
            return {g: self.optim_groups[g][0].init(
                        {k: params[k] for k in names})
                    for g, names in self._groups(params).items()}
        return self.optim.init(params)

    @property
    def fused_optimizer_active(self) -> bool:
        """Whether steps run the single-pass fused update (ops/fused.py)
        instead of the optimizer's own update."""
        return self._fused_update is not None

    def _optimizer_update(self, grads, opt_state, params):
        if self.optim_groups:
            new_state = {}
            for g, names in self._groups(params).items():
                sub_p = {k: params[k] for k in names}
                updates, new_state[g] = self.optim_groups[g][0].update(
                    {k: grads[k] for k in names}, opt_state[g], sub_p)
                tree_map(lambda p, u: p.add_(u), sub_p, updates)
            return params, new_state
        updates, new_state = self.optim.update(grads, opt_state, params)
        tree_map(lambda p, u: p.add_(u), params, updates)
        return params, new_state

    # ---------------------------------------------------------- train step
    def loss_and_grads(self, params, state, batch, rng):
        """Forward and backward of one batch: ``(loss, grads, new_state)``,
        ``grads`` a tree like ``params``; nothing is updated.  The
        gradients are those of the loss plus the model's regularization
        penalty (``W_regularizer`` and the like); the loss returned is
        the loss without it."""
        x, y = batch
        leaves = tree_leaves(params)
        if not all(p.is_floating_point() or p.is_complex() for p in leaves):
            raise TypeError(_integer_leaf_message(params))
        live = [p.detach().requires_grad_() for p in leaves]
        first = {}

        def forward(*leaves):
            # under remat this runs again in the backward: the recompute
            # draws from a generator set to the state ``rng`` had before
            # the first forward, and its new state is dropped
            g = rng
            if "new_state" in first and rng is not None:
                g = torch.Generator(device=rng.device)
                g.set_state(first["rng_state"])
            p = tree_replace(params, list(leaves))
            out, new_state = self.model.apply(p, x, state=state,
                                              training=True, rng=g)
            loss = self.loss_fn(y, out)
            # a float 0.0 when no layer registered a regularizer
            reg = self.model.regularization_loss(p)
            first.setdefault("new_state", new_state)
            return (loss + reg if torch.is_tensor(reg) else loss), loss

        with torch.enable_grad():
            if self.remat:
                from torch.utils.checkpoint import checkpoint
                first["rng_state"] = (rng.get_state() if rng is not None
                                      else None)
                objective, loss = checkpoint(forward, *live,
                                             use_reentrant=False)
            else:
                objective, loss = forward(*live)
        if objective.requires_grad:
            grads = torch.autograd.grad(objective, live, allow_unused=True,
                                        materialize_grads=True)
        else:   # every param frozen or detached: zero gradients, as jax.grad
            grads = [torch.zeros_like(p) for p in live]
        return loss.detach(), tree_replace(params, grads), first["new_state"]

    def _step_core(self, params, opt_state, state, batch, rng):
        """One forward, backward and update: the body every step program
        captures."""
        loss, grads, new_state = self.loss_and_grads(params, state, batch,
                                                     rng)
        if self.grad_sync_dtype == "bfloat16":
            grads = tree_map(lambda g: g.to(torch.bfloat16).float(), grads)

        def update():
            if self._fused_update is not None:
                return self._fused_update(grads, opt_state, params)
            return self._optimizer_update(_apply_clipping(grads, self.clip),
                                          opt_state, params)
        with torch.no_grad():
            params, opt_state = mask_frozen_params(self.model, params,
                                                   update)
        return params, opt_state, new_state, loss

    def _build_train_step(self, fold_rng: bool = False):
        """The train-step program; ``fold_rng`` names the one
        ``train_step_at`` dispatches (the generator is made on the host
        from the step index, so one program serves both)."""
        # through a weak reference: the graphs die with the trainer
        core = weakref.WeakMethod(self._step_core)
        jitted = engine_jit(
            lambda *args: core()(*args), donate_argnums=(0, 1, 2),
            key_hint="train_step_at" if fold_rng else "train_step")
        return self._monitor.wrap("train_step", jitted)

    def _dispatch_instrumented(self, fn, *args):
        """One step dispatch: the fault-injection site, keyed on this
        trainer's 0-based dispatch count and tripped BEFORE the dispatch
        (a fault at step k leaves exactly k committed steps), then the
        program, its host wall observed."""
        chaos = active_chaos()
        if chaos is not None:
            chaos.trip(SITE_TRAINER_DISPATCH, self._dispatch_count)
        self._dispatch_count += 1
        t0 = time.perf_counter()
        out = fn(*args)
        self._m_step_time.labels("host_dispatch").observe(
            time.perf_counter() - t0)
        return out

    def train_step(self, params, opt_state, state, batch, rng):
        """One step on a device-placed ``batch`` (``put_batch``), with the
        dropout generator ``rng``; returns ``(params, opt_state, state,
        loss)``, ``params`` and the moments updated in place."""
        if self._train_step is None:
            self._train_step = self._build_train_step()
        return self._dispatch_instrumented(
            self._train_step, params, opt_state, state, batch, rng)

    def train_step_at(self, params, opt_state, state, batch, seed: int,
                      step: int):
        """``train_step`` with the dropout generator of step ``step`` of a
        run seeded ``seed``: ``step_generator(seed, step, device)``."""
        if self._train_step_at is None:
            self._train_step_at = self._build_train_step(fold_rng=True)
        return self._dispatch_instrumented(
            self._train_step_at, params, opt_state, state, batch,
            step_generator(seed, step, self.device))

    def warm_start(self, params, opt_state, state, host_batch,
                   seed: int) -> bool:
        """Capture the per-step train program (``train_step_at``'s) for
        ``host_batch``'s shapes before the first real batch arrives, so
        the capture is paid at start-up where it is attributable.  The
        batch is placed as a step's would be; nothing is executed on the
        arguments (``EngineJit.warm``: params, moments and generators as
        they were, no launch counted).  Returns whether a graph is in
        place (False: the eager route, or a failed capture; never an
        error)."""
        try:
            if self._train_step_at is None:
                self._train_step_at = self._build_train_step(fold_rng=True)
            batch = self.put_batch(host_batch)
            from analytics_zoo_torch.observability import get_tracer
            with get_tracer().span("aot_warm_start"):
                return bool(self._train_step_at.warm(
                    params, opt_state, state, batch,
                    step_generator(seed, 0, self.device)))
        except Exception:   # noqa: BLE001 — warm-start is best-effort
            import logging
            logging.getLogger("analytics_zoo_torch.compile").debug(
                "train-step warm start failed; capturing lazily",
                exc_info=True)
            return False

    # ------------------------------------------------- device-resident epoch
    def _epoch_step(self, batch_size: int):
        """The one-step program over device-resident rows: the batch is
        rows ``[offset, offset + batch_size)`` of ``x``/``y``, gathered on
        the device, and the step advances ``offset`` (a device scalar) in
        place."""
        fn = self._epoch_steps.get(batch_size)
        if fn is None:
            core = weakref.WeakMethod(self._step_core)

            def step(params, opt_state, state, x, y, offset, rng):
                idx = offset + torch.arange(batch_size, device=offset.device)
                xb = tree_map(lambda a: a.index_select(0, idx), x)
                yb = None if y is None else tree_map(
                    lambda a: a.index_select(0, idx), y)
                params, opt_state, state, loss = core()(
                    params, opt_state, state, (xb, yb), rng)
                offset.add_(batch_size)
                return params, opt_state, state, loss, offset
            # the epoch rows (the HBM buffers, or a chunk the caller
            # drops) and the offset are donated with the training state
            fn = engine_jit(step, donate_argnums=(0, 1, 2, 3, 4, 5),
                            key_hint="train_epoch_scan")
            self._epoch_steps[batch_size] = fn
        return fn

    def epoch_scan_fn(self, num_batches: int, batch_size: int):
        """``num_batches`` steps over DEVICE-RESIDENT rows — the HBM tier of
        the FeatureSet cache hierarchy, and a chunk of the chunked route.
        Returns ``f(params, opt_state, state, x, y, seed, start_step,
        on_step=None) -> (params, opt_state, state, mean_loss)``: step i
        takes rows ``[i * batch_size, (i + 1) * batch_size)`` and the
        generator ``step_generator(seed, start_step + i)``, the per-step
        route's for that step, so the routes take the same steps;
        ``on_step()`` runs on the host after each step (the Estimator
        counts its iterations there).  Each step is one dispatch of the
        captured one-step program (``_epoch_step``): no host read and no
        host-to-device copy inside."""
        # a compile monitor of its own for each chunk length, as the
        # reference builds a program for each: a short last chunk is a new
        # program, not recompilation churn
        step = self._monitor.wrap("train_epoch_scan",
                                  self._epoch_step(batch_size))

        def epoch(params, opt_state, state, x, y, seed, start_step,
                  on_step=None):
            if self._offset is None:
                self._offset = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
            offset = self._offset
            offset.zero_()
            losses = []
            for i in range(num_batches):
                params, opt_state, state, loss, offset = \
                    self._dispatch_instrumented(
                        step, params, opt_state, state, x, y, offset,
                        step_generator(seed, start_step + i, self.device))
                losses.append(loss)
                if on_step is not None:
                    on_step()
            self._offset = offset
            return params, opt_state, state, torch.stack(losses).mean()
        return epoch

    def put_epoch(self, x, y, epoch: int, feature_set=None):
        """Device-place a whole epoch; with ``feature_set`` its
        deterministic per-epoch permutation is applied on the host first
        (one gather per epoch instead of one per step)."""
        if feature_set is not None and feature_set.shuffle:
            perm = feature_set._epoch_perm(epoch)
            x = tree_map(lambda a: np.asarray(a)[perm], x)
            y = tree_map(lambda a: np.asarray(a)[perm], y) \
                if y is not None else None
        return self.put_epoch_source(x, y)

    def put_epoch_source(self, x, y):
        """Place the UNPERMUTED whole dataset on the device once — the HBM
        cache tier (the reference's DRAM cache, FeatureSet.scala:585-662,
        promoted into device memory).  One device, so no padding to a
        data-parallel width."""
        return self.put_batch((x, y))

    def permute_rows_fn(self):
        """DEVICE-SIDE row gather ``(x, y, perm) -> (x[perm], y[perm])``:
        one int64 index upload an epoch instead of the epoch's bytes.  The
        gathers write the same buffers every epoch, so the epoch step's
        captured inputs stay the tensors it was captured on.  One gather a
        leaf is one kernel, captured or not: it runs eagerly."""
        def permute(x, y, perm):
            idx = torch.as_tensor(np.asarray(perm, np.int64)).to(
                self.device)
            src = (x, y)
            leaves = [a for a in tree_leaves(src) if a is not None]
            prev = self._permuted
            if prev is None or [tuple(b.shape) for b in prev[1]] != \
                    [(len(idx),) + tuple(a.shape[1:]) for a in leaves]:
                bufs = [a.new_empty((len(idx),) + tuple(a.shape[1:]))
                        for a in leaves]
                self._permuted = prev = (None, bufs)
            it = iter(prev[1])

            def take(a):
                if a is None:
                    return None
                out = next(it)
                torch.index_select(a, 0, idx, out=out)
                return out
            return tree_map(take, x), (None if y is None else
                                       tree_map(take, y))
        return permute

    # ----------------------------------------------------------- eval step
    def _build_eval_step(self, metrics):
        model = self.model

        def step(params, state, batch):
            x, y, mask = batch
            with torch.no_grad():
                out, _ = model.apply(params, x, state=state, training=False)
                return tuple(m.batch_update(y, out, mask) for m in metrics)
        # params and state are read, never written: the graph reads the
        # caller's tensors themselves, and other weights capture it again
        return engine_jit(step, borrow_argnums=(0, 1), key_hint="eval_step")

    def make_eval_runner(self, metrics):
        """``run(params, state, batches)``: the eval step over host batches
        or batches already on the device (the Estimator's eval cache),
        folded into the metrics' scores."""
        from analytics_zoo_torch.pipeline.api.keras.metrics import accumulate
        step = self._build_eval_step(metrics)

        def run(params, state, batches):
            return accumulate(metrics, (step(params, state,
                                             self.put_batch(b))
                                        for b in batches))
        return run

    # -------------------------------------------------------- predict step
    def predict_fn(self):
        if self._predict_step is None:
            model = self.model

            def step(params, state, x):
                with torch.no_grad():
                    out, _ = model.apply(params, x, state=state,
                                         training=False)
                return out
            self._predict_step = engine_jit(step, borrow_argnums=(0, 1),
                                            key_hint="predict_step")
        return self._predict_step
