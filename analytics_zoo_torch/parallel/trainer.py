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

Not ported: the mesh and sharding, the whole-epoch and chunked scans and
the observability hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_torch.common.config import get_config
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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator training step ``step`` of a run seeded ``seed`` draws
    its dropout masks from, on ``device`` (the layers fold their names
    into it)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 +
             int(step) * 0xBF58476D1CE4E5B9 + 1) % _SEED_MOD
    return torch.Generator(device=device).manual_seed(mixed)


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
        """Host arrays (a tree, None leaves allowed) onto the device.  On
        the card the copy goes through pinned memory, so it does not wait
        for the steps already queued."""
        def put(a):
            if a is None:
                return None
            t = torch.as_tensor(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return tree_map(put, batch)

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
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
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
        chaos = active_chaos()
        if chaos is not None:
            chaos.trip(SITE_TRAINER_DISPATCH, self._dispatch_count)
        self._dispatch_count += 1
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

    def train_step(self, params, opt_state, state, batch, rng):
        """One step on a device-placed ``batch`` (``put_batch``), with the
        dropout generator ``rng``; returns ``(params, opt_state, state,
        loss)``, ``params`` and the moments updated in place."""
        return self._step_core(params, opt_state, state, batch, rng)

    def train_step_at(self, params, opt_state, state, batch, seed: int,
                      step: int):
        """``train_step`` with the dropout generator of step ``step`` of a
        run seeded ``seed``: ``step_generator(seed, step, device)``."""
        return self._step_core(params, opt_state, state, batch,
                               step_generator(seed, step, self.device))

    # ----------------------------------------------------------- eval step
    def make_eval_runner(self, metrics):
        from analytics_zoo_torch.pipeline.api.keras.metrics import accumulate
        model = self.model

        def step(params, state, batch):
            x, y, mask = batch
            with torch.no_grad():
                out, _ = model.apply(params, x, state=state, training=False)
                return tuple(m.batch_update(y, out, mask) for m in metrics)

        def run(params, state, batches):
            return accumulate(metrics, (step(params, state,
                                             self.put_batch(b))
                                        for b in batches))
        return run

    # -------------------------------------------------------- predict step
    def predict_fn(self):
        model = self.model

        def step(params, state, x):
            with torch.no_grad():
                out, _ = model.apply(params, x, state=state, training=False)
            return out
        return step
