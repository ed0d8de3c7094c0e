"""Optimizers with the reference's semantics (port of
``pipeline/api/keras/optimizers.py``).

The reference builds its optimizers from optax transformations.  The port
keeps optax's formulas op for op and its state layout, so that a state
carried from the JAX package fits one to one
(``interop.load_jax_opt_state``): a chain's state is a tuple of its
members' states, with

* ``ScaleByAdamState(count, mu, nu)`` — ``scale_by_adam``,
* ``TraceState(trace)`` — ``trace`` (momentum),
* ``ScaleByScheduleState(count)`` — a learning-rate schedule,
* ``EmptyState()`` — a stateless member (constant lr, weight decay).

Counts are int32 device tensors and schedules are float32 tensor
functions of them, so a step never reads a value back to the host.
``update`` is the unfused reference path (``train.fused_optimizer=false``
or ``ops.fused=off``); the trainer's default is the fused one-pass update
of ``ops/fused.py``.  RMSprop, Adagrad, Adadelta, Adamax and
AdamWeightDecay are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import torch

from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map,
)

INT32_MAX = 2 ** 31 - 1


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


class TraceState(NamedTuple):
    trace: dict


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


STATE_TYPES = (EmptyState, ScaleByAdamState, TraceState,
               ScaleByScheduleState)


def map_states(node, fn):
    """Rebuild an optimizer state, passing each state object through
    ``fn`` whole (no recursion into its trees)."""
    if isinstance(node, STATE_TYPES):
        return fn(node)
    if isinstance(node, tuple):
        return tuple(map_states(c, fn) for c in node)
    return node


def collect_states(node) -> List:
    """The state objects of an optimizer state, in order."""
    out = []
    map_states(node, lambda s: (out.append(s), s)[1])
    return out


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax ``safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < INT32_MAX, count + 1, count)


def global_norm(leaves) -> torch.Tensor:
    """L2 norm over every leaf (optax ``global_norm``), on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [g.float() for g in leaves])))


def _zeros_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device_of(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


# ----------------------------------------------- transformations (optax)
class _Transform(NamedTuple):
    init: Callable
    update: Callable       # (updates, state, params) -> (updates, state)


def _scale_by_adam(b1: float, b2: float, eps: float) -> _Transform:
    def init(params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return ScaleByAdamState(_zeros_count(_device_of(params)), zeros(),
                                zeros())

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                      state.nu)
        count_inc = safe_increment(state.count)
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                       mu, nu)
        return out, ScaleByAdamState(count_inc, mu, nu)
    return _Transform(init, update)


def _trace(decay: float, nesterov: bool) -> _Transform:
    def init(params):
        return TraceState(tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        new_trace = tree_map(lambda g, t: g + decay * t, updates,
                             state.trace)
        out = (tree_map(lambda g, t: g + decay * t, updates, new_trace)
               if nesterov else new_trace)
        return out, TraceState(new_trace)
    return _Transform(init, update)


def _add_decayed_weights(weight_decay: float) -> _Transform:
    def update(updates, state, params=None):
        return tree_map(lambda g, p: g + weight_decay * p, updates,
                        params), state
    return _Transform(lambda params: EmptyState(), update)


def _scale_by_learning_rate(lr) -> _Transform:
    """``-lr * updates``; a schedule keeps a count and is evaluated at its
    pre-increment value."""
    if not callable(lr):
        step = -1 * float(lr)
        return _Transform(lambda params: EmptyState(),
                          lambda u, s, p=None: (tree_map(
                              lambda g: step * g, u), s))

    def init(params):
        return ScaleByScheduleState(_zeros_count(_device_of(params)))

    def update(updates, state, params=None):
        step = -1 * lr(state.count)
        return (tree_map(lambda g: step * g, updates),
                ScaleByScheduleState(safe_increment(state.count)))
    return _Transform(init, update)


def _chain(*members: _Transform) -> _Transform:
    def init(params):
        return tuple(m.init(params) for m in members)

    def update(updates, state, params=None):
        new_state = []
        for m, s in zip(members, state):
            updates, s = m.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return _Transform(init, update)


# --------------------------------------------------------------- schedules
def fixed(lr: float) -> Callable:
    return lambda step: lr


def poly(lr: float, power: float, max_iteration: int) -> Callable:
    """BigDL SGD.Poly: lr * (1 - iter/max_iter)^power (optax
    ``polynomial_schedule`` to 0)."""
    if max_iteration <= 0:
        return lambda step: lr
    return _polynomial(lr, 0.0, power, max_iteration)


def _polynomial(init_value: float, end_value: float, power,
                transition_steps: int) -> Callable:
    def schedule(count):
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac ** power) + end_value
    return schedule


def warmup_then(base_lr: float, warmup_iterations: int,
                after: Callable) -> Callable:
    """Linear warmup 0→base_lr then hand off (optax ``join_schedules`` of
    a ``linear_schedule`` and ``after``)."""
    warm = (_polynomial(0.0, base_lr, 1, warmup_iterations)
            if warmup_iterations > 0 else (lambda step: 0.0))

    def schedule(step):
        return torch.where(step < warmup_iterations, warm(step),
                           after(step - warmup_iterations))
    return schedule


def plateau(lr: float, factor: float = 0.1, patience: int = 10):
    raise NotImplementedError(
        "metric-driven Plateau schedule is applied by the Estimator's "
        "training loop, not inside the step")


def _sched(learning_rate, schedule):
    if schedule is not None:
        return schedule
    if callable(learning_rate):
        return learning_rate
    return float(learning_rate)


class OptimMethod:
    """A named optimizer: a chain of transformations + its lr schedule.
    Subclasses record their constructor kwargs (``_init_kwargs``), which
    the fused update reads."""

    def __init__(self, tx: _Transform, name: str,
                 learning_rate: Union[float, Callable] = None):
        self.tx = tx
        self.name = name
        self.learning_rate = learning_rate

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        """(updates, new_state): the unfused optax path."""
        return self.tx.update(grads, opt_state, params)


class SGD(OptimMethod):
    """SGD + momentum + optional schedule + weight decay (BigDL optim.SGD
    semantics).  ``dampening`` has no optax counterpart: the fused update
    refuses it and the unfused update raises."""

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, schedule=None):
        self._init_kwargs = dict(
            learning_rate=learning_rate, momentum=momentum,
            dampening=dampening, nesterov=nesterov,
            weight_decay=weight_decay, schedule=schedule)
        lr = _sched(learning_rate, schedule)
        # optax.sgd: trace(momentum) or identity(), then the lr
        first = (_trace(momentum, nesterov) if momentum else
                 _Transform(lambda params: EmptyState(),
                            lambda u, s, p=None: (u, s)))
        members = ([_add_decayed_weights(weight_decay)]
                   if weight_decay else [])
        members.append(_chain(first, _scale_by_learning_rate(lr)))
        super().__init__(_chain(*members), "sgd", lr)

    def update(self, grads, opt_state, params):
        if self._init_kwargs["dampening"]:
            raise NotImplementedError(
                "SGD(dampening=...) has no counterpart in the reference's "
                "optax update")
        return super().update(grads, opt_state, params)


class Adam(OptimMethod):
    """Keras-semantics Adam (lr decay via ``decay`` per iteration)."""

    def __init__(self, lr: float = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, schedule=None):
        self._init_kwargs = dict(lr=lr, beta_1=beta_1, beta_2=beta_2,
                                 epsilon=epsilon, decay=decay,
                                 schedule=schedule)
        if schedule is None and decay > 0:
            schedule = lambda step: lr / (1.0 + decay * step)  # noqa: E731
        sched = _sched(lr, schedule)
        super().__init__(
            _chain(_scale_by_adam(beta_1, beta_2, epsilon),
                   _scale_by_learning_rate(sched)),
            "adam", sched)


def _not_ported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"optimizer {name} is not ported to the PyTorch package yet "
            "(ROADMAP.md, port queue); use SGD or Adam")
    return make


AdamWeightDecay = _not_ported("AdamWeightDecay")
RMSprop = _not_ported("RMSprop")
Adagrad = _not_ported("Adagrad")
Adadelta = _not_ported("Adadelta")
Adamax = _not_ported("Adamax")

_REGISTRY = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamWeightDecay,
    "adamweightdecay": AdamWeightDecay,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
}


def get(optimizer) -> Optional[OptimMethod]:
    if optimizer is None or isinstance(optimizer, OptimMethod):
        return optimizer
    name = str(optimizer).lower()
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown optimizer: {optimizer!r}") from None
