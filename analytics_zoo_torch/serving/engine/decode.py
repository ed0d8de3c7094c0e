"""Decode-step scheduler — iteration-level continuous batching for
generative serving (port of the JAX package's ``serving/engine/
decode.py``; the Orca/vLLM scheduling idea, sized for the seq2seq zoo's
RNN decode state instead of a KV cache).

The stateless engine schedules at *request* granularity: a request
occupies its device-batch slot for exactly one predict.  A generative
request is a *sequence* — and scheduling those at request granularity
(``Seq2seq.infer``'s whole-sequence loop) means a sequence that finishes
at step 5 still holds its slot for all ``max_seq_len`` steps, and a
short request's latency is gated by the longest co-rider.  This module
schedules at *iteration* granularity instead:

* a :class:`DecodeSlotPool` holds per-sequence decode state — the RNN
  carries and last token — **device-resident** in fixed
  ``(capacity + 1, ...)`` tensors, so state never round-trips the host
  between iterations;
* each scheduler iteration runs ONE decode step over the currently
  active slots, compacted through a ``slot_ids`` index vector padded to
  a rung of the bucket ladder, so the step runs at a handful of batch
  shapes, each warmed by :meth:`DecodeSlotPool.warm`;
* a sequence that emits EOS (or exhausts its token budget) retires
  **between iterations**, freeing its slot, and the queue backfills the
  freed slot in the same scheduler iteration — the device batch is
  always as full as the traffic allows;
* every emitted token is surfaced immediately through the request's
  ``on_token`` callback — the per-token streaming hook the HTTP fast
  path's chunked ``/generate`` route rides.

The pool's two device functions, each built through
``compile.engine_jit`` (a CUDA graph a bucket on the card):

* ``prefill(params, tokens, carries, enc_ids[b,L], slot_ids[b])`` — run
  the model's encoder/bridge for ``b`` new sequences and copy their
  initial state into the pool at ``slot_ids``;
* ``step(params, tokens, carries, slot_ids[b])`` — gather the active
  rows, run one ``decode_step``, copy the updated state back in place,
  and return the ``b`` new tokens (the iteration's one host read).

Bucket padding: the pool holds one row more than its capacity, a sink at
index ``capacity``.  Padding lanes gather from the sink and write into
it, and no slot ever reads it.  (The reference pads with the
out-of-range index ``capacity`` and relies on XLA's clipping gather and
dropping scatter; on CUDA an out-of-range index is a device-side assert
that poisons the process's context, and clamping would write a padding
lane's garbage over a live slot.)

The model contract (``Seq2seq`` implements it) is four methods:
``decode_params()``, ``prefill(params, enc_ids)``,
``decode_step(params, tok, carries)``, ``initial_carries(batch)``; the
pool lives on the device of the tensors ``initial_carries`` returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map,
)
from analytics_zoo_torch.serving.engine.batcher import ShedError
from analytics_zoo_torch.serving.engine.executor import (
    Endpoint, bucket_for, parse_buckets)

log = logging.getLogger("analytics_zoo_torch.serving.engine")


def _mark(request, station: str, **attrs) -> None:
    """Record a reqtrace station for a traced request (no-op when the
    request carries no TraceContext or tracing is off)."""
    trace = getattr(request, "trace", None)
    if trace is None:
        return
    from analytics_zoo_torch.observability.reqtrace import (
        get_request_log)
    get_request_log().mark(trace, station, **attrs)


@dataclasses.dataclass
class _ActiveSeq:
    """Host-side bookkeeping for one occupied slot (the device holds
    the actual decode state)."""
    request: Any                    # batcher.Request
    max_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0        # perf_counter at admission
    last_token_at: float = 0.0      # perf_counter at last emission


class DecodeSlotPool:
    """Device-resident per-sequence decode state + the per-step
    functions over it.

    The batcher's single executor thread is the only caller of
    :meth:`step_once`/:meth:`admit` (the same single-dispatcher discipline
    the stateless executor runs under); ``warm``, which may run while that
    thread serves, takes the pool's lock as they do."""

    def __init__(self, model, *, capacity: int, enc_len: int,
                 start_sign: int, stop_sign: Optional[int],
                 max_seq_len: int, buckets=()):
        from analytics_zoo_torch.observability import get_registry

        self.model = model
        self.capacity = int(capacity)
        self.enc_len = int(enc_len)
        self.start_sign = int(start_sign)
        self.stop_sign = None if stop_sign is None else int(stop_sign)
        self.max_seq_len = int(max_seq_len)
        self.buckets = parse_buckets(buckets, self.capacity)
        self._params = model.decode_params()
        # the pool: last token per slot + the model's carry tree, every
        # leaf sized (capacity + 1, ...) — the last row is the padding
        # lanes' sink — resident for the pool's whole life and updated
        # in place by the step's index copies
        self._tokens, self._carries = self._fresh_state()
        self.device = self._tokens.device
        self._free: List[int] = list(range(self.capacity))
        self._active: Dict[int, _ActiveSeq] = {}
        # held by warm and by every call that touches the device state
        self._lock = threading.RLock()
        self._warmed = set()           # (function, bucket) rungs run
        self.iterations = 0            # device steps executed
        self.admitted_total = 0
        #: (iteration, slot) per admission/retirement — the test
        #: witness for "EOS-freed slot backfilled the same iteration"
        self.admit_log: List[tuple] = []
        self.retire_log: List[tuple] = []

        # the per-iteration and admission programs (compile.engine_jit):
        # on the card a CUDA graph a bucket, captured by warm() or at the
        # first call.  The weights are borrowed and the pool state
        # donated: the graphs read and update those tensors themselves
        # (the pool in place), so between iterations ONE copy of the
        # decode state lives on the device and nothing is copied in but
        # the slot ids and the prefill's tokens
        from analytics_zoo_torch.compile import engine_jit
        cap = self.capacity
        # (each program calls the pool's function of the moment, through
        # a weak reference: the graphs die with the pool)
        pool = weakref.proxy(self)
        self._step = engine_jit(lambda *a: pool._step_fn(*a),
                                borrow_argnums=(0,), donate_argnums=(1, 2),
                                key_hint=f"gen_decode_step_c{cap}")
        self._prefill = engine_jit(lambda *a: pool._prefill_fn(*a),
                                   borrow_argnums=(0,),
                                   donate_argnums=(1, 2),
                                   key_hint=f"gen_decode_prefill_c{cap}")

        reg = get_registry()
        self._m_tokens = reg.counter(
            "serving_tokens_total",
            "tokens emitted by the generative decode scheduler",
            labels=("endpoint",))
        self._m_steps = reg.counter(
            "serving_decode_steps_total",
            "decode-step device iterations executed",
            labels=("endpoint",))
        self._m_admitted = reg.counter(
            "serving_decode_admitted_total",
            "sequences admitted into the decode slot pool",
            labels=("endpoint",))
        self._m_retired = reg.counter(
            "serving_decode_retired_total",
            "sequences retired from the decode slot pool, by cause",
            labels=("endpoint", "cause"))
        self._m_occupancy = reg.gauge(
            "serving_slot_occupancy",
            "active decode slots / pool capacity",
            labels=("endpoint",))
        self._m_inter_token = reg.histogram(
            "serving_inter_token_latency_seconds",
            "gap between successive tokens of one sequence (the "
            "first gap is admission to first token)")
        self._m_first_token = reg.histogram(
            "serving_first_token_latency_seconds",
            "request arrival to first emitted token")
        self._endpoint_name = "?"   # set by GenerativeEndpoint

    # ---------------------------------------------------- device functions
    def _step_fn(self, params, tokens, carries, slot_ids):
        """Gather the lanes' rows, one ``decode_step``, copy the new
        rows back in place; returns (tokens, carries, next tokens)."""
        tok = tokens.index_select(0, slot_ids)
        sub = tree_map(lambda a: a.index_select(0, slot_ids), carries)
        nxt, new_sub = self.model.decode_step(params, tok, sub)
        tokens.index_copy_(0, slot_ids, nxt)
        tree_map(lambda full, rows: full.index_copy_(0, slot_ids, rows),
                 carries, new_sub)
        return tokens, carries, nxt

    def _prefill_fn(self, params, tokens, carries, enc_ids, slot_ids):
        """Encode the new sequences and copy their start token and
        carries into the lanes' rows; returns (tokens, carries)."""
        new_sub = self.model.prefill(params, enc_ids)
        tokens.index_fill_(0, slot_ids, self.start_sign)
        tree_map(lambda full, rows: full.index_copy_(0, slot_ids, rows),
                 carries, new_sub)
        return tokens, carries

    # ------------------------------------------------------------ geometry
    def _reset_state(self) -> None:
        """Back to fresh state, written into the pool's own tensors (the
        captured programs hold them)."""
        tokens, carries = self._fresh_state()
        with torch.inference_mode():
            self._tokens.copy_(tokens)
            tree_map(lambda dst, src: dst.copy_(src), self._carries, carries)

    def _fresh_state(self):
        """A brand-new device-resident pool state, ``capacity + 1`` rows.
        Every leaf is copied: the model's ``initial_carries`` may alias
        one zeros tensor across leaves (LSTM's ``(z, z)``), and an
        in-place copy into ``h`` would then also write ``c``."""
        with torch.inference_mode():
            carries = tree_map(lambda a: a.clone(),
                               self.model.initial_carries(self.capacity + 1))
            tokens = torch.full((self.capacity + 1,), self.start_sign,
                                dtype=torch.int32,
                                device=tree_leaves(carries)[0].device)
        return tokens, carries

    def _on_device(self):
        """The pool's card as the calling thread's current CUDA device
        (the batcher's thread calls in; the current device is per
        thread)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @property
    def active_count(self) -> int:
        return len(self._active)

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def _pad_ids(self, ids: List[int], bucket: int) -> torch.Tensor:
        # padding lanes point at the sink row ``capacity``
        return torch.from_numpy(np.asarray(
            ids + [self.capacity] * (bucket - len(ids)), np.int64)).to(
            self.device)

    # ----------------------------------------------------------- warm start
    def warm(self) -> int:
        """Warm both pool programs (step + prefill) at every bucket of the
        ladder, every lane on the sink row, so a first request pays
        neither a capture, CUDA's lazy loading nor the libraries'
        first-call setup for its shape.  On the card each rung is captured
        into a CUDA graph without running (``EngineJit.warm``); on the CPU,
        with ``compile.aot=false``, or where a capture fails, the function
        runs once instead.  The work runs on a thread of its own that ends
        (CUDA's libraries set up per host thread and hand that on when the
        thread ends, so the batcher's thread inherits it); no slot is
        touched and, with no sequence active, the pool is reset to fresh
        state.  Returns #rungs warmed (both functions count)."""
        with ThreadPoolExecutor(1, thread_name_prefix="zoo-warm") as ex:
            warmed = ex.submit(self._warm_rungs).result()
        with self._lock:
            if not self._active:
                self._reset_state()
        return warmed

    def _warm_rungs(self) -> int:
        warmed = 0
        with self._lock, self._on_device(), torch.inference_mode():
            for b in self.buckets:
                ids = self._pad_ids([], b)
                enc = torch.zeros((b, self.enc_len), dtype=torch.int32,
                                  device=self.device)
                try:
                    args = (self._params, self._tokens, self._carries, ids)
                    if not self._step.warm(*args):
                        self._tokens, self._carries, _ = self._step(*args)
                    self._warmed.add(("step", b))
                    warmed += 1
                    args = (self._params, self._tokens, self._carries, enc,
                            ids)
                    if not self._prefill.warm(*args):
                        self._tokens, self._carries = self._prefill(*args)
                    self._warmed.add(("prefill", b))
                    warmed += 1
                except Exception:   # noqa: BLE001 — warm is best-effort
                    log.exception("decode warm-up failed for bucket %d",
                                  b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return warmed

    @property
    def aot_signatures(self) -> int:
        """Captured graphs of the step and the prefill; where no graph is
        captured (the CPU, ``compile.aot=false``), the rungs warmed."""
        captured = self._step.aot_signatures + self._prefill.aot_signatures
        return captured or len(self._warmed)

    # ------------------------------------------------------------ admission
    def admit(self, requests: List, now: Optional[float] = None
              ) -> int:
        """Prefill + copy up to ``len(self._free)`` new sequences into
        free slots (one bucket-padded prefill call).  Returns #admitted;
        the rest stay with the caller."""
        with self._lock:
            return self._admit(requests, now)

    def _admit(self, requests: List, now: Optional[float] = None) -> int:
        n = min(len(requests), len(self._free))
        if n == 0:
            return 0
        now = time.perf_counter() if now is None else now
        batch = requests[:n]
        slots = [self._free.pop(0) for _ in range(n)]
        bucket = self.bucket_for(n)
        enc = np.zeros((bucket, self.enc_len), np.int32)
        for i, r in enumerate(batch):
            row = np.asarray(r.data, np.int32).reshape(-1)
            if row.shape[0] != self.enc_len:
                # contract: fixed enc_len per endpoint (clients pad);
                # clamp/pad here so one odd record cannot poison the
                # whole pool call
                padded = np.zeros(self.enc_len, np.int32)
                padded[:min(row.shape[0], self.enc_len)] = \
                    row[:self.enc_len]
                row = padded
            enc[i] = row
        try:
            with self._on_device(), torch.inference_mode():
                ids = self._pad_ids(slots, bucket)
                self._tokens, self._carries = self._prefill(
                    self._params, self._tokens, self._carries,
                    torch.from_numpy(enc).to(self.device), ids)
        except BaseException as e:   # noqa: BLE001 — containment
            # a failed prefill fails exactly the batch it was
            # admitting — and CONSUMES it (the caller pops it off the
            # queue), because re-queueing a deterministically-poison
            # group would fail every future iteration forever.  The
            # state may hold a partial copy: rebuild.
            self._reset_state()
            self._free = sorted(set(self._free) | set(slots))
            for r in batch:
                self._m_retired.labels(self._endpoint_name,
                                       "error").inc()
                if not r.done:
                    r.fail(e)
            log.exception("prefill failed; %d admitting sequence(s) "
                          "failed and consumed", n)
            if not isinstance(e, Exception):
                raise      # process-death class: PEL-reclaim contract
            return n
        for r, slot in zip(batch, slots):
            budget = self.max_seq_len
            if getattr(r, "max_tokens", None):
                budget = max(1, min(int(r.max_tokens),
                                    self.max_seq_len))
            self._active[slot] = _ActiveSeq(
                request=r, max_tokens=budget, admitted_at=now,
                last_token_at=now)
            self.admit_log.append((self.iterations, slot))
            _mark(r, "prefill", t=now, slot=slot, bucket=bucket)
        self.admitted_total += n
        self._m_admitted.labels(self._endpoint_name).inc(n)
        self._m_occupancy.labels(self._endpoint_name).set(
            len(self._active) / self.capacity)
        return n

    # ------------------------------------------------------------ iteration
    def step_once(self) -> int:
        """One decode iteration over the active slots: gather → step →
        copy back → emit.  Retires EOS/budget-exhausted sequences and
        frees their slots.  Returns #tokens emitted."""
        with self._lock:
            return self._step_once()

    def _step_once(self) -> int:
        # sweep abandoned sequences first: a transport that timed a
        # request out already answered its client — decoding its
        # remaining tokens would burn device steps on a response
        # nobody reads (the generative twin of the batcher's
        # compose-time drop)
        for slot in [s for s, seq in self._active.items()
                     if seq.request.done]:
            self._active.pop(slot)
            self._free.append(slot)
            self.retire_log.append((self.iterations, slot))
            self._m_retired.labels(self._endpoint_name,
                                   "abandoned").inc()
        if not self._active:
            self._m_occupancy.labels(self._endpoint_name).set(0.0)
            return 0
        slots = sorted(self._active)
        bucket = self.bucket_for(len(slots))
        with self._on_device(), torch.inference_mode():
            ids = self._pad_ids(slots, bucket)
            self._tokens, self._carries, emitted = self._step(
                self._params, self._tokens, self._carries, ids)
            emitted = emitted.cpu().numpy()     # the iteration's ONE sync
        self.iterations += 1
        now = time.perf_counter()
        self._m_steps.labels(self._endpoint_name).inc()
        n_emitted = len(slots)
        self._m_tokens.labels(self._endpoint_name).inc(n_emitted)
        for lane, slot in enumerate(slots):
            seq = self._active[slot]
            tok = int(emitted[lane])
            first = not seq.tokens
            seq.tokens.append(tok)
            self._m_inter_token.observe(now - seq.last_token_at)
            if first:
                self._m_first_token.observe(
                    now - (seq.request.arrival or seq.admitted_at))
            seq.last_token_at = now
            _mark(seq.request, "decode_step", t=now,
                  iteration=self.iterations,
                  token_index=len(seq.tokens) - 1)
            cb = getattr(seq.request, "on_token", None)
            if cb is not None:
                try:
                    cb(len(seq.tokens) - 1, tok)
                except Exception:   # noqa: BLE001 — streaming is
                    pass            # best-effort, decode is not
            if (self.stop_sign is not None
                    and tok == self.stop_sign):
                self._retire(slot, "eos")
            elif len(seq.tokens) >= seq.max_tokens:
                self._retire(slot, "max_tokens")
        self._m_occupancy.labels(self._endpoint_name).set(
            len(self._active) / self.capacity)
        return n_emitted

    def _retire(self, slot: int, cause: str) -> None:
        seq = self._active.pop(slot)
        self._free.append(slot)
        self.retire_log.append((self.iterations, slot))
        self._m_retired.labels(self._endpoint_name, cause).inc()
        _mark(seq.request, "retire", cause=cause,
              tokens=len(seq.tokens))
        seq.request.complete(list(seq.tokens))

    # -------------------------------------------------------------- failure
    def fail_all(self, exc: BaseException) -> int:
        """The generative poison contract: the active sequences share
        one step call, so a failed iteration fails them ALL (each
        request carries the error to its transport) and the pool resets
        to empty — the endpoint is never wedged on corrupt state."""
        with self._lock:
            return self._fail_all(exc)

    def _fail_all(self, exc: BaseException) -> int:
        n = len(self._active)
        for slot, seq in list(self._active.items()):
            self._m_retired.labels(self._endpoint_name, "error").inc()
            if not seq.request.done:
                seq.request.fail(exc)
        self._active.clear()
        self._free = list(range(self.capacity))
        # the failed call may have copied part of its rows before
        # raising — rebuild, don't reuse
        self._reset_state()
        self._m_occupancy.labels(self._endpoint_name).set(0.0)
        return n


class GenerativeEndpoint(Endpoint):
    """A served *generative* model: a queue of sequences + the decode
    slot pool the scheduler iterates.  The batcher treats it like any
    endpoint for scheduling credits, but routes it through
    ``ModelExecutor.execute_decode`` (one decode ITERATION per credit)
    instead of the stateless batch compose."""

    generative = True

    def __init__(self, name: str, model, *, enc_len: int,
                 start_sign: int, stop_sign: Optional[int] = None,
                 max_seq_len: int = 32, slots: int = 4,
                 buckets=(), weight: int = 1,
                 request_deadline_ms: float = 0.0):
        super().__init__(name, model, top_n=1, buckets=buckets,
                         batch_size=slots,
                         input_shape=(int(enc_len),), weight=weight)
        self.pool = DecodeSlotPool(
            model, capacity=int(slots), enc_len=int(enc_len),
            start_sign=start_sign, stop_sign=stop_sign,
            max_seq_len=int(max_seq_len), buckets=self.buckets)
        self.pool._endpoint_name = name
        self.max_seq_len = int(max_seq_len)
        # generative admission control (the stateless path's shed
        # contract, applied at the slot-pool gate): a
        # sequence still QUEUED — not yet admitted into a slot — past
        # request_deadline_ms is shed before it burns a slot.  An
        # ADMITTED sequence is never shed: its slot is already paid
        # for and tokens may already be on the wire.  0 disables.
        self.request_deadline_ms = float(request_deadline_ms or 0.0)
        from analytics_zoo_torch.observability import get_registry
        self._m_shed = get_registry().counter(
            "serving_shed_total",
            "records shed by admission control instead of predicted",
            labels=("cause",))

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.pool.active_count)

    def warm(self) -> int:
        """Warm the pool's step and prefill at every bucket instead of
        the stateless predict rungs."""
        return self.pool.warm()

    # ----------------------------------------------------------- scheduling
    def backfill(self) -> int:
        """Admit queued sequences into free slots (whole queue-order,
        skipping requests a transport already timed out).  Queue pops
        are GIL-atomic deque ops — submit() appends under the
        batcher's lock, the executor thread pops here without it, the
        deque itself is the synchronization point."""
        self.shed_expired()
        admitted = 0
        while self.queue and self.pool._free:
            group = self.queue[0]
            live = [r for r in group if not r.done]
            if not live:
                self.queue.popleft()
                continue
            n = self.pool.admit(live)
            admitted += n
            if n < len(live):
                # pool full mid-group: keep the remainder queued
                group[:] = live[n:]
                break
            self.queue.popleft()
        return admitted

    def shed_expired(self) -> int:
        """Generative admission control (the stateless path's shed
        contract, applied at the slot-pool gate): a sequence still QUEUED — not yet admitted into a
        slot — past ``request_deadline_ms`` is failed with
        :class:`~.batcher.ShedError` and counted under
        ``serving_shed_total{cause="deadline"}`` before it burns a
        slot.  Runs every scheduler iteration, full pool included:
        that is exactly when queue waits age sequences out, and the
        client deserves its 504 now, not when a slot finally frees.
        An ADMITTED sequence is never shed — its slot is already paid
        for and tokens may already be on the wire.  Returns #shed."""
        ddl_s = self.request_deadline_ms / 1000.0
        if ddl_s <= 0 or not self.queue:
            return 0
        now = time.perf_counter()
        shed = 0
        for group in list(self.queue):
            for r in group:
                if r.done or not r.arrival \
                        or now - r.arrival <= ddl_s:
                    continue
                age_ms = (now - r.arrival) * 1e3
                self._m_shed.labels("deadline").inc()
                shed += 1
                r.fail(ShedError(
                    f"shed: deadline ({age_ms:.0f}ms queued, "
                    f"deadline {self.request_deadline_ms:.0f}ms) — "
                    f"sequence never admitted",
                    age_ms=age_ms,
                    deadline_ms=self.request_deadline_ms))
        return shed

    def run_iteration(self) -> int:
        """One scheduler iteration: step the active slots, retire
        finished sequences, and backfill the freed slots from the
        queue in the SAME iteration.  Returns #tokens emitted +
        #sequences admitted (0 = no work left)."""
        emitted = self.pool.step_once()
        admitted = self.backfill()
        if emitted == 0 and admitted:
            # freshly admitted into an idle pool: run their first
            # step now rather than waiting for the next credit —
            # first-token latency is the point of the fast path
            emitted = self.pool.step_once()
        return emitted + admitted
