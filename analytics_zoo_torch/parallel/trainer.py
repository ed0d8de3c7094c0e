"""The training engine (port of ``parallel/trainer.py``).

The reference compiles one step — forward, backward, optimizer update —
into one XLA program over a device mesh and donates the old parameters
to it.  The port runs the same step on each rank of the mesh
(``parallel/mesh.py``, one process a device): autograd over
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
exactly k steps committed.  With ``observability.check_finite`` (the
default) each step also computes the watchdog's ``isfinite(loss + Σ
grads)`` flag on the device, an output of its program, and hands it to
``finite_flags`` (``observability/watchdog.py::StepFlags``), which
delivers it to the active watchdog once the device has computed it: no
host read is added to a step.

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

On a mesh (the zoo context's, or ``mesh=``) the step is the reference's
under GSPMD, with the collectives written out on the mesh's groups:

- **data parallel**: each rank takes its rows of the batch
  (``put_batch``: a process's own batch when the data axes span every
  process, else its ``1 / dp`` of the global batch); the gradients are
  summed over ``data`` × ``fsdp`` in one bucket and divided by the
  degree BEFORE clipping and the update, so the global norm is the
  global batch's, as in the reference; the reported loss is the mean
  over those ranks;
- **FSDP** (ZeRO-style): a leaf the spec shards (``parallel/sharding.py``)
  lives on each rank as its piece; the step all-gathers the pieces for
  the forward and backward, reduce-scatters its gradient over ``fsdp``
  (then sums it over ``data``), and the optimizer state stays on the
  pieces;
- **tensor parallel**: a leaf a layer declares (``param_pspecs``) stays a
  piece for good; the layer's own collectives make its output whole;
- the fused Adam/SGD update runs on each rank's pieces through the same
  multi-tensor kernels, one launch a step; an l2-norm clip's global norm
  sums the pieces' squares over their axis.

A step on a mesh of more than one rank runs eagerly (gloo's collectives
run on the host, and a captured program would replay without them); on
one rank it is captured as before.  ``gather_tree`` puts pieces back
together (snapshots and the Estimator's final variables are whole) and
``shard_tree`` cuts a whole tree into this rank's pieces (restores).
Each dispatch on a mesh adds the step's estimated collective bytes to
``collective_bytes_total`` (``observability/collectives.py``), and every
``observability.device_time_every`` steps a multi-process run times a
barrier (``train_barrier_wait_seconds``).

Not ported: MFU.
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
from analytics_zoo_torch.compile.engine import log_eager
from analytics_zoo_torch.parallel import comm
from analytics_zoo_torch.parallel import mesh as mesh_lib
from analytics_zoo_torch.observability.diagnostics import (
    get_compile_monitor, step_attribution_histogram)
from analytics_zoo_torch.observability.watchdog import (
    StepFlags, fold_finiteness_check)
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


def _apply_clipping(grads, clip: Optional[ClipSpec], norm_fn=None):
    if clip is None:
        return grads
    if clip.kind == "const":
        return tree_map(lambda g: torch.clamp(g, clip.a, clip.b), grads)
    if clip.kind == "l2norm":
        from analytics_zoo_torch.pipeline.api.keras.optimizers import (
            global_norm)
        gnorm = (norm_fn or global_norm)(tree_leaves(grads))
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


def _map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and a spec tree laid out like it
    (NamedTuples kept)."""
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map_with_specs(fn, v, s) for v, s in zip(tree, specs)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, specs)


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
                 = None, mesh=None):
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        self.model = model
        self.loss_fn = loss_fn
        self.optim = optim_method
        self.clip = clip
        self.optim_groups = optim_groups  # {name: (OptimMethod, names)}
        ctx = get_zoo_context()
        self.device = ctx.device
        self.mesh = mesh if mesh is not None else ctx.mesh
        # the params' spec tree and its leaves (tree_leaves order), set by
        # the first place_params; None: every leaf whole
        self._specs = None
        self._flat_specs = None
        self._sharded = False
        self._collective_bytes = None
        self._barrier_every = 0
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
        # the watchdog's NaN/Inf detector: each step folds a finite flag
        # into its program and returns it; the flags reach the host
        # through ``finite_flags`` without a sync of their own
        self._obs_check_finite = bool(cfg.get("observability.check_finite"))
        self.finite_flags = StepFlags()
        self._obs_collectives = bool(cfg.get("observability.collectives",
                                             True))
        if bool(cfg.get("observability.barrier_probe", True)) and \
                self.mesh.world_size > 1:
            self._barrier_every = int(
                cfg.get("observability.device_time_every") or 0)
        # fused optimizer update (ops/fused.py): clip + moment update +
        # param apply in ONE pass per leaf.  None = unsupported
        # (optimizer groups, an optimizer or clip it does not reproduce,
        # or train.fused_optimizer off): the optimizer's own update runs.
        self._fused_update = None
        if bool(cfg.get("train.fused_optimizer", True)) and \
                not self.optim_groups and self.optim is not None:
            from analytics_zoo_torch.ops.fused import build_fused_update
            self._fused_update = build_fused_update(
                self.optim, self.clip, norm_fn=self._grad_norm)

    # ------------------------------------------------------------- programs
    def _jit(self, fn, key_hint: str, **kwargs):
        """``engine_jit(fn)`` on a one-rank mesh; ``fn`` itself, run
        eagerly, when its collectives must run on every call."""
        if self.mesh.world_size == 1:
            return engine_jit(fn, key_hint=key_hint, **kwargs)
        log_eager(key_hint, f"collectives over a mesh of "
                            f"{self.mesh.world_size} ranks")
        return fn

    # ------------------------------------------------------------- sharding
    def param_shardings(self, params):
        """The spec tree of ``params`` (whole leaves): tensor-parallel
        specs the layers declare, FSDP, or None (``parallel/sharding.py``)."""
        if self._specs is None:
            from analytics_zoo_torch.parallel.sharding import (
                any_sharded, collect_param_shardings)
            self._specs = collect_param_shardings(self.model, params,
                                                  self.mesh)
            self._flat_specs = tree_leaves(self._specs)
            self._whole_shapes = [tuple(a.shape) for a in tree_leaves(params)]
            self._sharded = any_sharded(self._specs)
        return self._specs

    def _specs_like(self, tree, specs=None):
        """The spec tree of ``tree``: the params' specs on every subtree
        laid out like (part of) the params (an optimizer state's moments),
        None elsewhere."""
        specs = self._specs if specs is None else specs
        if isinstance(tree, dict):
            if isinstance(specs, dict) and tree and set(tree) <= set(specs):
                return {k: self._specs_like(v, specs[k])
                        for k, v in tree.items()}
            return {k: self._specs_like(v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [self._specs_like(v, specs) for v in tree]
            return type(tree)(*vals) if hasattr(tree, "_fields") \
                else type(tree)(vals)
        if isinstance(specs, mesh_lib.Shard) and \
                isinstance(tree, torch.Tensor) and tree.ndim > specs.dim:
            return specs
        return None

    def shard_tree(self, tree):
        """This rank's pieces of a tree of whole leaves (params, or a tree
        laid out like them), as new tensors on the device."""
        def cut(a, s):
            if not isinstance(a, torch.Tensor):
                return a
            return mesh_lib.shard_of(a.detach(), s, self.mesh).to(
                self.device, copy=True).contiguous()
        return _map_with_specs(cut, tree, self._specs_like(tree))

    def gather_tree(self, tree):
        """The whole leaves of a tree of this rank's pieces (a collective
        on a sharded mesh: every rank calls it); the tree itself when
        nothing is sharded."""
        if not self._sharded:
            return tree
        return _map_with_specs(
            lambda a, s: mesh_lib.gather_leaf(a, s, self.mesh)
            if isinstance(a, torch.Tensor) else a,
            tree, self._specs_like(tree))

    def full_like(self, tree, device=None):
        """Uninitialised tensors of the whole leaves' shapes, like a tree
        of pieces (the target a whole snapshot restores into), on
        ``device`` (default each piece's; ``"meta"`` allocates nothing)."""
        if not self._sharded:
            return tree

        def whole(a, s):
            if not isinstance(a, torch.Tensor) or s is None:
                return a
            shape = list(a.shape)
            shape[s.dim] *= self.mesh.size(s.axis)
            return torch.empty(shape, dtype=a.dtype,
                               device=device or a.device)
        return _map_with_specs(whole, tree, self._specs_like(tree))

    # ------------------------------------------------------------ placement
    def place_params(self, params):
        """This rank's pieces of ``params`` (whole leaves) on the device,
        new tensors the steps update in place (the caller's tensors are
        never written)."""
        self.param_shardings(params)
        return self.shard_tree(params)

    def place_state(self, tree):
        """A copy of a replicated tree (the model's ``state``) on the
        device."""
        return tree_map(lambda a: a.detach().to(self.device, copy=True)
                        if isinstance(a, torch.Tensor) else a, tree)

    def place_like(self, host_tree, like_tree):
        """Whole host leaves (a restored optimizer state) cut like a live
        tree of pieces."""
        del like_tree
        return self.shard_tree(host_tree)

    def replicate(self, tree):
        return tree_map(lambda a: a.to(self.device), tree)

    def _batch_rows(self, n: int) -> Optional[Tuple[int, int]]:
        """(first row, rows) this rank takes of a host batch of ``n``
        rows, or None when it takes all of them: a process's own batch
        (the data axes span every process), or one that does not split
        into the data-parallel degree (replicated, as the reference)."""
        dp = self.mesh.dp_size
        if dp == 1 or mesh_lib.data_split_across_hosts(self.mesh) or \
                n % dp:
            return None
        k = n // dp
        return self.mesh.dp_index * k, k

    def _rows_differ(self, n: int) -> bool:
        """Whether ranks of the data-parallel group hold different rows of
        a batch of ``n``."""
        return self.mesh.dp_size > 1 and (
            mesh_lib.data_split_across_hosts(self.mesh) or
            n % self.mesh.dp_size == 0)

    def put_batch(self, batch):
        """Host arrays (a tree, None leaves allowed) onto the device
        (``put_on_device``), this rank's rows of them on a data-parallel
        mesh."""
        placed = put_on_device(batch, self.device)
        leaves = [a for a in tree_leaves(placed)
                  if isinstance(a, torch.Tensor) and a.ndim > 0]
        rows = self._batch_rows(len(leaves[0])) if leaves else None
        if rows is None:
            return placed
        lo, k = rows
        return tree_map(lambda a: a[lo:lo + k]
                        if isinstance(a, torch.Tensor) and a.ndim > 0
                        else a, placed)

    def put_whole(self, batch):
        """Host arrays onto the device, every row (the epoch routes cut
        each step's batch on the device)."""
        return put_on_device(batch, self.device)

    def prefetch(self, batches, depth: Optional[int] = None, place=None):
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
        place = place or self.put_batch
        if depth is None:
            depth = int(get_config().get("data.prefetch"))
        if depth <= 0:
            for b in batches:
                yield place(b)
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
                        if not put(place(b)):
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
        """The optimizer state of ``params`` (this rank's pieces: the
        moments live on the pieces, ZeRO-style)."""
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

    # -------------------------------------------------------- collectives
    def _grad_norm(self, flat_g):
        """The global L2 norm of the gradient leaves (``tree_leaves``
        order): each piece's squares summed over its axis, a whole leaf's
        counted once.  Unsharded, ``optimizers.global_norm`` itself."""
        from analytics_zoo_torch.pipeline.api.keras.optimizers import (
            global_norm)
        if not self._sharded:
            return global_norm(flat_g)
        by_axis: Dict[Optional[str], list] = {}
        for g, sp in zip(flat_g, self._flat_specs):
            by_axis.setdefault(None if sp is None else sp.axis, []).append(g)
        total = None
        for axis, gs in by_axis.items():
            sq = torch.stack(torch._foreach_norm(
                [g.float() for g in gs])).square().sum()
            if axis is not None:
                sq = comm.all_reduce_sum(sq, self.mesh.group(axis))
            total = sq if total is None else total + sq
        return total.sqrt()

    def _gather_params(self, params):
        """The params the forward takes: FSDP pieces all-gathered whole
        (tensor-parallel pieces stay pieces: their layers compute on
        them)."""
        if not self._sharded or self.mesh.size(mesh_lib.FSDP_AXIS) == 1:
            return params
        leaves = tree_leaves(params)
        out = [mesh_lib.gather_leaf(p, sp, self.mesh)
               if sp is not None and sp.axis == mesh_lib.FSDP_AXIS and
               tuple(p.shape) != whole else p
               for p, sp, whole in zip(leaves, self._flat_specs,
                                       self._whole_shapes)]
        return tree_replace(params, out)

    def _sync_grads(self, grads):
        """The gradients averaged over ``data`` × ``fsdp``: FSDP leaves
        reduce-scattered over ``fsdp`` into this rank's piece (then summed
        over ``data``), every other leaf summed in one bucket; then
        divided by the degree."""
        dp = self.mesh.dp_size
        if dp == 1:
            return grads
        flat = tree_leaves(grads)
        specs = self._flat_specs or [None] * len(flat)
        out = list(flat)
        bucket = []
        for i, (g, sp) in enumerate(zip(flat, specs)):
            if sp is not None and sp.axis == mesh_lib.FSDP_AXIS:
                g = comm.reduce_scatter_sum(
                    g, self.mesh.group(mesh_lib.FSDP_AXIS), dim=sp.dim)
                g = comm.all_reduce_sum(
                    g, self.mesh.group(mesh_lib.DATA_AXIS))
                out[i] = g / dp
            else:
                bucket.append(i)
        if bucket:
            flat_b = torch.cat([flat[i].reshape(-1).float()
                                for i in bucket])
            flat_b = comm.all_reduce_sum(flat_b, self.mesh.dp_group()) / dp
            at = 0
            for i in bucket:
                n = flat[i].numel()
                out[i] = flat_b[at:at + n].view(flat[i].shape).to(
                    flat[i].dtype)
                at += n
        return tree_replace(grads, out)

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
        # on a data-parallel mesh this rank's rows are block dp_index of
        # the global batch (random masks are drawn for the whole of it)
        block = ((self.mesh.dp_index, self.mesh.dp_size)
                 if self.mesh.dp_size > 1 else None)

        def forward(*leaves):
            # under remat this runs again in the backward: the recompute
            # draws from a generator set to the state ``rng`` had before
            # the first forward, and its new state is dropped
            g = rng
            if "new_state" in first and rng is not None:
                g = torch.Generator(device=rng.device)
                g.set_state(first["rng_state"])
            p = tree_replace(params, list(leaves))
            with mesh_lib.active(self.mesh, block):
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
        captures.  Returns ``(params, opt_state, state, loss, finite)``,
        ``finite`` the watchdog's flag (None with
        ``observability.check_finite`` off)."""
        loss, grads, new_state = self.loss_and_grads(
            self._gather_params(params), state, batch, rng)
        if self.mesh.dp_size > 1:
            # the global batch's gradients and loss, before clipping and
            # the update (the reference's are global under GSPMD)
            grads = self._sync_grads(grads)
            loss = comm.all_reduce_sum(loss, self.mesh.dp_group()) / \
                self.mesh.dp_size
        # the watchdog's NaN/Inf detector, folded into the step's program
        # (a flag among its outputs, read later without a sync)
        finite = (fold_finiteness_check(loss, grads)
                  if self._obs_check_finite else None)
        if self.grad_sync_dtype == "bfloat16":
            grads = tree_map(lambda g: g.to(torch.bfloat16).float(), grads)

        def update():
            if self._fused_update is not None:
                return self._fused_update(grads, opt_state, params)
            return self._optimizer_update(
                _apply_clipping(grads, self.clip, self._grad_norm),
                opt_state, params)
        with torch.no_grad():
            params, opt_state = mask_frozen_params(self.model, params,
                                                   update)
        return params, opt_state, new_state, loss, finite

    def _build_train_step(self, fold_rng: bool = False):
        """The train-step program; ``fold_rng`` names the one
        ``train_step_at`` dispatches (the generator is made on the host
        from the step index, so one program serves both)."""
        # through a weak reference: the graphs die with the trainer
        core = weakref.WeakMethod(self._step_core)
        jitted = self._jit(
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
        self.account_collectives(args[0], 1)
        if self._barrier_every and \
                self._dispatch_count % self._barrier_every == 0:
            self._probe_barrier_wait()
        # the step's finite flag goes to the watchdog's queue; the
        # caller gets the step's other outputs
        self.finite_flags.push(out[-1])
        return out[:-1]

    def _estimate_collectives(self, params) -> Dict[str, float]:
        """The step's ``{op: bytes}`` from the mesh and the whole params'
        sizes (``observability/collectives.py``); {} off a mesh."""
        if not self._obs_collectives or self.mesh.world_size == 1:
            return {}
        try:
            from analytics_zoo_torch.observability.collectives import (
                estimate_train_step_collectives)
            return estimate_train_step_collectives(
                self.full_like(params, "meta"), self.mesh,
                self.grad_sync_dtype)
        except Exception:   # noqa: BLE001 — accounting never fails a step
            return {}

    def account_collectives(self, params, steps: int) -> None:
        """Add ``steps`` steps of the estimated collective traffic to the
        counters.  Never raises."""
        if self._collective_bytes is None:
            self._collective_bytes = self._estimate_collectives(params)
        if self._collective_bytes and steps > 0:
            from analytics_zoo_torch.observability.collectives import (
                record_step_collectives)
            record_step_collectives(self._collective_bytes, steps=steps)

    def _probe_barrier_wait(self) -> None:
        """Time a barrier over every rank after the sampled step: the wait
        is the slowest rank's remaining step time (~0 on the straggler),
        ``train_barrier_wait_seconds``.  Every rank reaches it at the same
        dispatch count."""
        from analytics_zoo_torch.observability import get_registry
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        comm.barrier()
        get_registry().histogram(
            "train_barrier_wait_seconds",
            "sampled cross-host barrier wait after a train step "
            "(multi-host only): ~0 on the straggler, ~skew on the "
            "fastest host").observe(time.perf_counter() - t0)

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

            rows = self._batch_rows(batch_size)
            first, count = rows if rows is not None else (0, batch_size)

            def step(params, opt_state, state, x, y, offset, rng):
                idx = offset + first + torch.arange(count,
                                                    device=offset.device)
                xb = tree_map(lambda a: a.index_select(0, idx), x)
                yb = None if y is None else tree_map(
                    lambda a: a.index_select(0, idx), y)
                params, opt_state, state, loss, finite = core()(
                    params, opt_state, state, (xb, yb), rng)
                offset.add_(batch_size)
                return params, opt_state, state, loss, offset, finite
            # the epoch rows (the HBM buffers, or a chunk the caller
            # drops) and the offset are donated with the training state
            fn = self._jit(step, donate_argnums=(0, 1, 2, 3, 4, 5),
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
        promoted into device memory).  Every row is placed: each step takes
        its rank's rows of its batch on the device."""
        return self.put_whole((x, y))

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
            with torch.no_grad(), mesh_lib.active(self.mesh):
                out, _ = model.apply(self._gather_params(params), x,
                                     state=state, training=False)
                return tuple(m.batch_update(y, out, mask) for m in metrics)
        # params and state are read, never written: the graph reads the
        # caller's tensors themselves, and other weights capture it again
        return self._jit(step, borrow_argnums=(0, 1), key_hint="eval_step")

    def _sum_partials(self, partials, n: int):
        """A batch's metric partials summed over the data-parallel ranks
        when they scored different rows of it."""
        if not self._rows_differ(n):
            return partials
        group = self.mesh.dp_group()
        return tuple(tuple(comm.all_reduce_sum(t, group) for t in p)
                     for p in partials)

    def make_eval_runner(self, metrics):
        """``run(params, state, batches)``: the eval step over host batches
        or batches already on the device (the Estimator's eval cache),
        folded into the metrics' scores."""
        from analytics_zoo_torch.pipeline.api.keras.metrics import accumulate
        step = self._build_eval_step(metrics)

        def score(params, state, b):
            n = len(tree_leaves(b)[0])
            return self._sum_partials(step(params, state, self.put_batch(b)),
                                      n)

        def run(params, state, batches):
            return accumulate(metrics, (score(params, state, b)
                                        for b in batches))
        return run

    # -------------------------------------------------------- predict step
    def predict_fn(self):
        if self._predict_step is None:
            model = self.model

            def step(params, state, x):
                with torch.no_grad(), mesh_lib.active(self.mesh):
                    out, _ = model.apply(self._gather_params(params), x,
                                         state=state, training=False)
                return out
            self._predict_step = self._jit(step, borrow_argnums=(0, 1),
                                           key_hint="predict_step")
        return self._predict_step
