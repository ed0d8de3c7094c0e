"""engine_jit — the one chokepoint every compiled program of the port is
built through (port of ``compile/engine.py``).

The reference lowers each program once per abstract signature, compiles
it ahead of time and dispatches the executable.  The port's compiled
program is a CUDA graph: per signature, ``engine_jit`` captures one call
of the function into a ``torch.cuda.CUDAGraph`` and replays it.  A graph
replays the very kernels the eager call launches, in the same order, on
the same buffers, so the compiled path is a speed change and never a
behavior change: it is held bit-identical to the eager run.
(``torch.compile`` would re-fuse the plain elementwise work, which
changes the rounding, and would need the ctypes kernels registered as
custom ops.)

**Signature.** The pytree structure of the arguments plus, per leaf:
(shape, dtype, device) for a tensor, the device for a
``torch.Generator``, and the VALUE for a Python scalar or string; and the
settings a program reads as it runs (grad and inference mode,
deterministic algorithms, and what modules register with
``register_trace_key``: ``ops.fused``, the dtype policy), which a capture
bakes in as jit bakes them into its trace.  A
graph freezes every host value at capture, so a Python scalar cannot be
an argument of a replay the way XLA passes it: the port keys the
signature by the scalar's value (a new value captures a new graph, the
old one stays).  Per-step values that change every call therefore enter
as device tensors or generators, never as Python numbers (the trainer
passes the step's dropout generator, not the step index).  Static
positions (``static_argnums``) are keyed by value as in the reference.

**First call, or ``warm``, captures.**  The function runs once on a side
stream (the warm-up: lazy library set-up, the caching allocator, the
kernels' first use), every tensor the warm-up may write is restored from
a snapshot taken before it (so ``warm`` runs no step), then the call is
captured on the side stream into a memory pool the engine's signatures
share (``capture_error_mode="thread_local"``: another thread's CUDA work
does not break it).  Capture executes nothing.  Tensor arguments take
one of three roles, by position:

* **donated** (``donate_argnums``): the tensor becomes the graph's input
  itself.  A later call that passes the very tensor costs no copy
  (parameters and moments, which the steps update in place, the port's
  counterpart of donation); one that passes another tensor has it copied
  into the first, which the caller gave up (a fresh Adam count, BN's new
  statistics, fed back).
* **borrowed** (``borrow_argnums``, a port addition): positions the
  program only reads and whose tensors stay the same from call to call
  (the weights of an eval, predict or decode step).  The graph reads the
  caller's tensors themselves, held by weak reference, and nothing is
  ever written into them.  A call that passes other tensors there (new
  weights after a ``fit`` or ``set_weights``) drops the program and
  captures it again for them, counted in ``recaptures`` and
  ``compile_recaptures_total{fn}``.
* every other tensor (a batch) is copied into a buffer of the engine's
  own at capture and at every replay, so no call ever writes a tensor
  the caller still holds (a cached eval batch, say).

An output that is a donated or borrowed input is handed back as that
tensor; every other output lives in the graph's pool, which the next
replay writes over, so the caller gets a clone (a loss, a count, BN's new
statistics: a few bytes).

**Generators.**  A graph draws random numbers from generators registered
with it before capture (``CUDAGraph.register_generator_state``).  Each
generator argument is replaced by one of the engine's, and every
generator the function derives from it (``derived_generator``, which
the Keras layers' ``fold_name`` goes through) by a pre-made one, in the
order the warm-up derived them; the ones the warm-up drew from are
registered.  Before each replay the engine sets its root to the
caller's generator's state and re-seeds each derived generator as the
eager call would have, so consecutive replays draw the eager steps'
masks, not the captured step's.

**Kernel launches.**  ``ops/kernels.LAUNCHES`` counts in Python, and a
replay runs none: the launches of the warm-up are dropped, those of the
capture are recorded per signature, and each replay adds them.  Both
record by stream: only launches on the engine's side stream go to the
warm-up's or the capture's record (autograd's backward runs on its
forward's stream), so another thread's launches, and its replays, count
as they would with no capture open.

**Fallback ladder** (never a behavior change): CPU tensors, or
``compile.aot=false`` → eager dispatch, the counterpart of plain
``jax.jit``; a capture that fails for a signature (a host read, an
unregistered generator, a call CUDA cannot record) → that signature
runs eagerly from then on, with ``compile_cache_errors_total{kind=
"capture"}`` and a warning; an error while executing (the warm-up or a
replay) is never absorbed and propagates as the eager call's would.

Replays of one ``engine_jit`` are serialized by a lock and ordered on
the device (a replay waits for the previous replay's stream), since its
signatures share one pool.  The graphs die with the ``EngineJit``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

log = logging.getLogger("analytics_zoo_torch.compile")

_SCALARS = (bool, int, float, complex, str, bytes)

#: every capture and every capture fallback of the process, in order:
#: ``{"fn", "capture_s", "pool_bytes", "launches", "fallback"}``
#: (``fallback`` None, or why the signature runs eagerly); a capture also
#: has ``"recapture"``, whether it replaced a program whose borrowed
#: tensors changed; a program that runs eagerly by design (no capture is
#: tried) is logged by ``log_eager`` with ``"eager"``, the reason
CAPTURE_LOG: List[Dict[str, Any]] = []


def log_eager(fn: str, reason: str) -> None:
    """Record that ``fn`` runs eagerly by design: not a capture and not a
    capture fallback."""
    CAPTURE_LOG.append({"fn": fn, "capture_s": None, "pool_bytes": None,
                        "launches": {}, "fallback": None, "eager": reason})
    log.info("%r runs eagerly: %s", fn, reason)


# ------------------------------------------------------------------ trees
def _flatten(tree, leaves: list):
    """Structure of ``tree`` (hashable), its leaves appended to
    ``leaves``: dicts (keys sorted, as jax flattens them), lists, tuples
    and named tuples are nodes; everything else, None included, a
    leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("d", tuple(keys), tuple(_flatten(tree[k], leaves)
                                        for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("n", type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return ("l" if isinstance(tree, list) else "t", len(tree),
                tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(node, it):
    if node is None:
        return next(it)
    kind, meta, children = node
    if kind == "d":
        return {k: _unflatten(c, it) for k, c in zip(meta, children)}
    if kind == "n":
        return meta(*(_unflatten(c, it) for c in children))
    vals = [_unflatten(c, it) for c in children]
    return vals if kind == "l" else tuple(vals)


def _leaf_sig(leaf):
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return ("t", tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, torch.Generator):
        return ("g", leaf.device)
    if isinstance(leaf, _SCALARS):
        return ("v", type(leaf), leaf)
    raise TypeError(f"engine_jit: a {type(leaf).__name__} argument has no "
                    "signature")


# settings read while a program runs, which a capture bakes in: each
# program is captured once per combination of their values
_trace_keys: List[Callable[[], Any]] = [
    torch.is_grad_enabled, torch.is_inference_mode_enabled,
    torch.are_deterministic_algorithms_enabled]


def register_trace_key(fn: Callable[[], Any]) -> None:
    """Add a setting the programs read as they run (``ops.fused``, the
    dtype policy): a program captured under one value is captured again
    under another, as an eager call would follow it."""
    if fn not in _trace_keys:
        _trace_keys.append(fn)


def trace_key() -> Tuple:
    return tuple(fn() for fn in _trace_keys)


def call_signature(args: Tuple, static_argnums: Tuple[int, ...] = ()
                   ) -> Tuple:
    """Hashable signature of a call: per argument the pytree structure
    plus, per leaf, (shape, dtype, device) of a tensor, the device of a
    generator and the value of a Python scalar; static positions keyed by
    value (``repr``)."""
    parts = []
    for i, a in enumerate(args):
        if i in static_argnums:
            parts.append(("static", repr(a)))
            continue
        leaves: list = []
        treedef = _flatten(a, leaves)
        parts.append((treedef, tuple(_leaf_sig(l) for l in leaves)))
    return tuple(parts)


# -------------------------------------------------------- graph backends
# one capture at a time in the process (two concurrent captures, each
# synchronizing, invalidate each other)
_capture_lock = threading.RLock()


class CudaGraphs:
    """The real backend: ``torch.cuda.CUDAGraph`` on CUDA tensors."""

    def applies(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def new_pool(self, device):
        return torch.cuda.graph_pool_handle()

    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def register(self, graph, gen: torch.Generator) -> None:
        reg = getattr(graph, "register_generator_state", None)
        if reg is None:
            raise RuntimeError("this PyTorch cannot register a generator "
                               "with a CUDA graph")
        reg(gen)

    def side_stream(self, device):
        return torch.cuda.Stream(device=device)

    def current_stream(self, device):
        return torch.cuda.current_stream(device)

    def stream_key(self, stream) -> int:
        """The handle ``ops/kernels.launch`` records a launch's stream by."""
        return stream.cuda_stream

    @contextlib.contextmanager
    def on_stream(self, stream):
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            cur.wait_stream(stream)

    def capture(self, graph, pool, stream, run: Callable, inputs=()):
        """Capture ``run()`` into ``graph`` on ``stream``; returns its
        outputs and the bytes the capture reserved (its pool's growth).
        ``inputs`` are its static tensors (a real capture executes nothing,
        so it needs none).
        Captures are serialized process-wide: a device-wide synchronize
        (``torch.cuda.graph`` makes one, and so does freeing cached memory)
        while another thread captures invalidates that capture.  Inside
        the lock the allocator's cache is freed first, as
        ``torch.cuda.graph`` frees it: a capture cannot free memory when
        it runs short, and the warm-up just cached a step's worth.  A
        failed capture leaves no allocation routed to ``pool``."""
        with _capture_lock, torch.cuda.stream(stream):
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(stream.device)
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = run()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:   # noqa: BLE001 — the first error wins
                    pass
                self.abandon(stream.device, pool)
                raise
            try:
                graph.capture_end()
            except BaseException:
                self.abandon(stream.device, pool)
                raise
            grown = torch.cuda.memory_reserved(stream.device) - reserved
        torch.cuda.current_stream(stream.device).wait_stream(stream)
        return out, grown

    def abandon(self, device, pool) -> None:
        """After a failed capture: stop routing allocations to ``pool``
        (``capture_end`` raises before it does).  The graph releases the
        pool when it is freed."""
        index = torch.device(device).index or 0
        fn = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if fn is not None:
            try:
                fn(index, pool)
            except Exception:   # noqa: BLE001 — already ended
                pass

    def replay(self, graph) -> None:
        graph.replay()


_backend_lock = threading.Lock()
_backend: Any = CudaGraphs()


def set_graph_backend(backend) -> Any:
    """Install another graph backend (tests install a stand-in that takes
    CPU tensors); returns the previous one."""
    global _backend
    with _backend_lock:
        prev, _backend = _backend, backend
    return prev


# ------------------------------------------------------------ generators
_gen_ctx = threading.local()


def derived_generator(parent: torch.Generator,
                      seed_of: Callable[[int], int]) -> torch.Generator:
    """A fresh generator on ``parent``'s device seeded
    ``seed_of(parent.initial_seed())`` — how the layers fold their names
    into a step's generator.  Inside an engine warm-up the derivation is
    recorded, inside a capture (and a stand-in replay) the pre-made
    generator the engine registered for it is returned."""
    ctx = getattr(_gen_ctx, "active", None)
    if ctx is None:
        return torch.Generator(device=parent.device).manual_seed(
            seed_of(parent.initial_seed()))
    return ctx.derive(parent, seed_of)


class _GenPlan:
    """The generators of one signature: roots (one per generator
    argument), derivations in warm-up order, which of them were drawn
    from, and the engine's own generator objects."""

    def __init__(self, roots: List[torch.Generator]):
        self.roots = roots
        self.parents: List[int] = []            # index into all gens
        self.seed_fns: List[Callable[[int], int]] = []
        self.derived: List[torch.Generator] = []
        self.drawn: List[int] = []
        self.recording = True
        self._index: Dict[int, int] = {}
        self._states: List[torch.Tensor] = []
        self._cursor = 0
        self.bad: Optional[str] = None

    @property
    def all(self) -> List[torch.Generator]:
        return self.roots + self.derived

    def reset_index(self):
        self._index = {id(g): i for i, g in enumerate(self.all)}
        self._cursor = 0

    def derive(self, parent, seed_of):
        pi = self._index.get(id(parent))
        if self.recording:
            gen = torch.Generator(device=parent.device).manual_seed(
                seed_of(parent.initial_seed()))
            if pi is None:
                self.bad = "a generator derived from one the engine " \
                           "does not hold"
                return gen
            self.parents.append(pi)
            self.seed_fns.append(seed_of)
            self.derived.append(gen)
            self._states.append(gen.get_state())
            self._index[id(gen)] = len(self.all) - 1
            return gen
        j = self._cursor
        if j >= len(self.derived) or self.parents[j] != pi:
            raise RuntimeError("engine_jit: the capture derived its "
                               "generators otherwise than the warm-up")
        self._cursor += 1
        return self.derived[j]

    def finish_recording(self, root_states):
        """Mark what the warm-up drew from, then make fresh derived
        generators for the capture."""
        self.recording = False
        nroot = len(self.roots)
        self.drawn = [i for i, g in enumerate(self.roots)
                      if not torch.equal(g.get_state(), root_states[i])]
        self.drawn += [nroot + j for j, g in enumerate(self.derived)
                       if not torch.equal(g.get_state(), self._states[j])]
        self.derived = [torch.Generator(device=g.device)
                        for g in self.derived]
        self._states = []
        for g, s in zip(self.roots, root_states):
            g.set_state(s)
        self.reset_index()

    def seed(self, callers: List[torch.Generator]) -> None:
        """Set every drawn generator to what the eager call would draw
        from with the caller's generators."""
        seeds = [g.initial_seed() for g in callers]
        for g, c in zip(self.roots, callers):
            g.set_state(c.get_state())
        nroot = len(self.roots)
        drawn = set(self.drawn)
        for j, (pi, fn) in enumerate(zip(self.parents, self.seed_fns)):
            s = fn(seeds[pi])
            seeds.append(s)
            if nroot + j in drawn:
                self.derived[j].manual_seed(s)

    @contextlib.contextmanager
    def active(self):
        prev = getattr(_gen_ctx, "active", None)
        _gen_ctx.active = self
        self._cursor = 0
        try:
            yield
        finally:
            _gen_ctx.active = prev


def _where(exc: BaseException) -> str:
    """`` (at file:line)`` of the innermost frame of this package the
    exception passed through, for a capture fallback's report."""
    import traceback
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "analytics_zoo_torch" in f.filename and
              not f.filename.endswith("compile/engine.py")]
    if not frames:
        return ""
    f = frames[-1]
    return f" (at {f.filename.rsplit('analytics_zoo_torch', 1)[-1]}" \
           f":{f.lineno})"


# ----------------------------------------------------------------- engine
class _Program:
    """One captured signature."""

    # tensor_idx: the leaves copied in before a replay where the caller
    # passes another tensor (donated and copied positions)
    __slots__ = ("graph", "static", "tensor_idx", "gen_idx", "plan",
                 "out_def", "out_spec", "launches", "borrowed")

    def holds(self, leaves) -> bool:
        """Whether every borrowed position still gets the tensor (and the
        storage) the graph was captured on."""
        return all(ref() is leaves[i] and leaves[i].data_ptr() == ptr
                   for i, ref, ptr in self.borrowed)


class EngineJit:
    """A callable with a capture-and-replay fast path; see the module
    docstring for the signature, the donated positions and the routes."""

    def __init__(self, fn, *, static_argnums=(), donate_argnums=(),
                 borrow_argnums=(), key_hint: Optional[str] = None):
        if isinstance(static_argnums, int):
            static_argnums = (static_argnums,)
        if isinstance(donate_argnums, int):
            donate_argnums = (donate_argnums,)
        if isinstance(borrow_argnums, int):
            borrow_argnums = (borrow_argnums,)
        if set(donate_argnums) & set(borrow_argnums):
            raise ValueError("engine_jit: a position is donated and "
                             "borrowed")
        self._fn = fn
        self._static = tuple(static_argnums)
        self._donate = tuple(donate_argnums)
        self._borrow = tuple(borrow_argnums)
        #: programs captured again because a borrowed position got other
        #: tensors
        self.recaptures = 0
        self.key_hint = key_hint or getattr(fn, "__qualname__", None) \
            or getattr(fn, "__name__", None) or "fn"
        self._programs: Dict[Tuple, _Program] = {}
        self._fallback: set = set()
        self._stale: set = set()       # dropped for other borrowed tensors
        self._pool = None
        self._stream = None
        self._last_stream = None
        self._lock = threading.RLock()

    # ------------------------------------------------------------ plumbing
    def _aot_enabled(self) -> bool:
        """The ``compile.aot`` kill switch: False turns the whole capture
        path off, ``warm``/``aot`` included."""
        try:
            from analytics_zoo_torch.common.config import get_config
            return bool(get_config().get("compile.aot", True))
        except Exception:   # noqa: BLE001
            return True

    def _split(self, args):
        """(signature, treedef, leaves, device) of a call, or None when it
        takes the eager route (no tensor, tensors on several devices, a
        leaf with no signature, or a device the backend does not take)."""
        leaves: list = []
        treedef = _flatten(tuple(a for i, a in enumerate(args)
                                 if i not in self._static), leaves)
        devices = {l.device for l in leaves
                   if isinstance(l, (torch.Tensor, torch.Generator))}
        if len(devices) != 1:
            return None
        device = devices.pop()
        if not _backend.applies(device):
            return None
        try:
            sig = (tuple(repr(args[i]) for i in self._static), treedef,
                   tuple(_leaf_sig(l) for l in leaves), trace_key())
        except TypeError:
            return None
        return sig, treedef, leaves, device

    def _roles(self, args) -> List[str]:
        """Per leaf of the dynamic arguments, the role of its position:
        ``"donate"``, ``"borrow"`` or ``"copy"``."""
        out: List[str] = []
        for i, a in enumerate(args):
            if i in self._static:
                continue
            n: list = []
            _flatten(a, n)
            role = "donate" if i in self._donate else \
                "borrow" if i in self._borrow else "copy"
            out += [role] * len(n)
        return out

    def _lookup(self, sig, leaves) -> Optional[_Program]:
        """The program of ``sig``, or None; a program whose borrowed
        tensors are not the call's is dropped (and counted) so that the
        caller captures it again."""
        prog = self._programs.get(sig)
        if prog is None or prog.holds(leaves):
            return prog
        del self._programs[sig]
        if not self._programs:
            # its graph was the pool's last: CUDA does not capture into a
            # pool whose graphs are all gone, so the next capture takes a
            # fresh one
            self._pool = None
        self._stale.add(sig)
        self.recaptures += 1
        try:
            from analytics_zoo_torch.observability import get_registry
            get_registry().counter(
                "compile_recaptures_total",
                "programs captured again because a borrowed position "
                "(the weights of an eval, predict or decode step) got "
                "other tensors", labels=("fn",)).labels(self.key_hint).inc()
        except Exception:   # noqa: BLE001 — accounting never breaks a call
            pass
        log.info("engine_jit %r: the weights it borrows changed; capturing "
                 "again", self.key_hint)
        return None

    def _rebuild(self, args, treedef, leaves):
        dyn = iter(_unflatten(treedef, iter(leaves)))
        return tuple(a if i in self._static else next(dyn)
                     for i, a in enumerate(args))

    # --------------------------------------------------------------- calls
    def __call__(self, *args):
        if not self._aot_enabled():
            return self._fn(*args)
        split = self._split(args)
        if split is None:
            return self._fn(*args)
        sig, treedef, leaves, device = split
        with self._lock:
            if sig in self._fallback:
                prog = None
            else:
                prog = self._lookup(sig, leaves)
                if prog is None:
                    prog = self._capture(args, sig, treedef, leaves, device)
            if prog is not None:
                return self._replay(prog, leaves, device)
        return self._fn(*args)

    def _replay(self, prog: _Program, leaves, device):
        backend = _backend
        cur = backend.current_stream(device)
        if self._last_stream is not None and self._last_stream is not cur:
            cur.wait_stream(self._last_stream)
        self._last_stream = cur
        static = prog.static
        with torch.no_grad():
            for i in prog.tensor_idx:
                if leaves[i] is not static[i]:
                    static[i].copy_(leaves[i])
        if prog.plan is not None:
            prog.plan.seed([leaves[i] for i in prog.gen_idx])
        backend.replay(prog.graph)
        if prog.launches:
            from analytics_zoo_torch.ops import kernels
            kernels.add_launches(prog.launches, backend.stream_key(cur))
        out = [static[v] if kind == "in" else leaves[v] if kind == "borrow"
               else v.clone() if kind == "pool" else v
               for kind, v in prog.out_spec]
        return _unflatten(prog.out_def, iter(out))

    def _capture(self, args, sig, treedef, leaves, device
                 ) -> Optional[_Program]:
        """Warm up, restore, capture; None (and the signature marked for
        the eager route) when the capture fails.  A warm-up error
        propagates."""
        from analytics_zoo_torch.ops import kernels
        backend = _backend
        if self._pool is None:
            self._stream = backend.side_stream(device)
            self._pool = backend.new_pool(device)
        tensor_idx = [i for i, l in enumerate(leaves)
                      if isinstance(l, torch.Tensor)]
        gen_idx = [i for i, l in enumerate(leaves)
                   if isinstance(l, torch.Generator)]
        roles = self._roles(args)
        # a donated or borrowed tensor becomes the graph's input itself;
        # any other is copied into a buffer of the engine's own, so no
        # later call ever writes a tensor the caller still holds
        static = list(leaves)
        with torch.no_grad():
            for i in tensor_idx:
                if roles[i] == "copy":
                    static[i] = leaves[i].clone()
        run_leaves = list(static)
        roots = []
        for i in gen_idx:
            g = torch.Generator(device=device)
            g.set_state(leaves[i].get_state())
            roots.append(g)
            run_leaves[i] = g
        root_states = [g.get_state() for g in roots]
        plan = _GenPlan(roots)
        plan.reset_index()
        run_args = self._rebuild(args, treedef, run_leaves)

        fn = self._fn      # the program must not hold the engine

        def run():
            with plan.active():
                return fn(*run_args)

        # the tensors a call may write: all but the borrowed ones
        written = [i for i in tensor_idx if roles[i] != "borrow"]
        with torch.no_grad():
            snapshot = [static[i].clone() for i in written]
        side = backend.stream_key(self._stream)
        try:
            with kernels.record_launches(side), \
                    backend.on_stream(self._stream):
                run()
        finally:
            with torch.no_grad():
                for i, saved in zip(written, snapshot):
                    static[i].copy_(saved)
            del snapshot
        plan.finish_recording(root_states)
        t0 = time.perf_counter()
        graph = None
        try:
            if plan.bad:
                raise RuntimeError(plan.bad)
            graph = backend.new_graph()
            for i in plan.drawn:
                backend.register(graph, plan.all[i])
            with kernels.record_launches(side) as launches:
                out, pool_bytes = backend.capture(
                    graph, self._pool, self._stream, run,
                    [static[i] for i in tensor_idx])
        except Exception as e:   # noqa: BLE001 — the eager route instead
            del graph
            from analytics_zoo_torch.compile.cache import _count_error
            _count_error("capture")
            self._fallback.add(sig)
            # the pool a failed capture used is not reused
            self._pool = None
            reason = f"{type(e).__name__}: {str(e)[:300]}{_where(e)}"
            CAPTURE_LOG.append({"fn": self.key_hint, "capture_s": None,
                                "pool_bytes": None, "launches": {},
                                "fallback": reason})
            log.warning("engine_jit %r: capture failed (%s); this "
                        "signature runs eagerly", self.key_hint, reason)
            return None
        prog = _Program()
        prog.graph = graph
        prog.tensor_idx, prog.gen_idx = written, gen_idx
        prog.plan = plan if plan.drawn else None
        out_leaves: list = []
        prog.out_def = _flatten(out, out_leaves)
        # an output that is a donated or borrowed input goes back as that
        # tensor; any other lives in the pool (or an engine buffer): a
        # clone
        where = {id(static[i]): (("in" if roles[i] == "donate" else
                                  "borrow"), i)
                 for i in tensor_idx if roles[i] != "copy"}
        prog.out_spec = [
            where[id(o)] if id(o) in where else
            ("pool", o) if isinstance(o, torch.Tensor) else ("const", o)
            for o in out_leaves]
        # the borrowed tensors by weak reference: the engine keeps no
        # weights alive, and a dead reference is a mismatch
        prog.borrowed = [(i, weakref.ref(leaves[i]), leaves[i].data_ptr())
                         for i in tensor_idx if roles[i] == "borrow"]
        for i, _, _ in prog.borrowed:
            static[i] = None
        prog.static = static
        prog.launches = {k: v for k, v in launches.items() if v}
        self._programs[sig] = prog
        capture_s = time.perf_counter() - t0
        CAPTURE_LOG.append({"fn": self.key_hint, "capture_s": capture_s,
                            "pool_bytes": pool_bytes,
                            "launches": dict(prog.launches),
                            "generators": len(plan.drawn), "fallback": None,
                            "recapture": sig in self._stale})
        self._stale.discard(sig)
        log.info("engine_jit %r: captured signature #%d in %.3f s (pool "
                 "%d bytes)", self.key_hint, len(self._programs), capture_s,
                 pool_bytes)
        return prog

    # ---------------------------------------------------------- warm-start
    def warm(self, *args) -> bool:
        """Capture the program for this signature ahead of the first call,
        WITHOUT executing a step: every tensor argument is as it was, the
        caller's generators are not advanced and no launch is counted.
        Returns whether a graph is in place (False: ``compile.aot`` off, a
        device without graphs, or a failed capture; never an error)."""
        if not self._aot_enabled():
            return False
        split = self._split(args)
        if split is None:
            return False
        sig, treedef, leaves, device = split
        with self._lock:
            if self._lookup(sig, leaves) is not None:
                return True
            if sig in self._fallback:
                return False
            try:
                return self._capture(args, sig, treedef, leaves,
                                     device) is not None
            except Exception:   # noqa: BLE001 — warm is best-effort
                log.warning("engine_jit %r: warm-up failed; the first "
                            "call runs it again", self.key_hint,
                            exc_info=True)
                return False

    def aot(self, *args):
        """Capture for these args (``warm``) and return a callable over the
        dynamic arguments (the static ones are baked in, as in the
        reference); where no graph is in place it dispatches eagerly."""
        self.warm(*args)
        statics = {i: args[i] for i in self._static}

        def call(*dynamic):
            dyn = iter(dynamic)
            return self(*(statics[i] if i in statics else next(dyn)
                          for i in range(len(statics) + len(dynamic))))
        return call

    @property
    def aot_signatures(self) -> int:
        """How many signatures replay a captured graph."""
        return len(self._programs)


def engine_jit(fn, *, static_argnums=(), donate_argnums=(),
               borrow_argnums=(), key_hint: Optional[str] = None
               ) -> EngineJit:
    """Build a compiled callable through the port's chokepoint: the
    drop-in counterpart of the reference's ``engine_jit``, plus
    ``borrow_argnums`` (the read-only weight positions; see the module
    docstring).  ``key_hint`` names the program in logs and in
    ``CAPTURE_LOG``."""
    return EngineJit(fn, static_argnums=static_argnums,
                     donate_argnums=donate_argnums,
                     borrow_argnums=borrow_argnums, key_hint=key_hint)
