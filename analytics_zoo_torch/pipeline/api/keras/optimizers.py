"""Optimizers with the reference's semantics (port of
``pipeline/api/keras/optimizers.py``).

The reference builds its optimizers from optax transformations.  The port
keeps optax's formulas op for op and its state layout, so that a state
carried from the JAX package fits one to one
(``interop.load_jax_opt_state``): a chain's state is a tuple of its
members' states, with

* ``ScaleByAdamState(count, mu, nu)`` — ``scale_by_adam`` (and
  ``scale_by_adamax``, whose ``nu`` is the infinity moment),
* ``TraceState(trace)`` — ``trace`` (momentum),
* ``ScaleByRmsState(nu)`` — ``scale_by_rms`` (RMSprop),
* ``ScaleByRssState(sum_of_squares)`` — ``scale_by_rss`` (Adagrad),
* ``ScaleByAdaDeltaState(e_g, e_x)`` — ``scale_by_adadelta``,
* ``ScaleByScheduleState(count)`` — a learning-rate schedule,
* ``EmptyState()`` — a stateless member (constant lr, weight decay).

Counts are int32 device tensors and schedules are float32 tensor
functions of them, so a step never reads a value back to the host.
``update`` is the unfused reference path (``train.fused_optimizer=false``
or ``ops.fused=off``); the trainer's default is the fused one-pass update
of ``ops/fused.py``, which takes SGD and Adam only: AdamWeightDecay,
RMSprop, Adagrad, Adadelta and Adamax always run their chains here, as
the reference runs optax's.
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


class ScaleByRmsState(NamedTuple):
    nu: dict


class ScaleByRssState(NamedTuple):
    sum_of_squares: dict


class ScaleByAdaDeltaState(NamedTuple):
    e_g: dict
    e_x: dict


STATE_TYPES = (EmptyState, ScaleByAdamState, TraceState,
               ScaleByScheduleState, ScaleByRmsState, ScaleByRssState,
               ScaleByAdaDeltaState)


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


def _scale_by_adamax(b1: float, b2: float, eps: float) -> _Transform:
    """optax ``scale_by_adamax``: the first moment bias-corrected over an
    infinity moment ``max(|g| + eps, b2 * nu)``; ``ScaleByAdamState``."""
    def init(params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return ScaleByAdamState(_zeros_count(_device_of(params)), zeros(),
                                zeros())

    def update(updates, state, params=None):
        count_inc = safe_increment(state.count)
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: torch.maximum(torch.abs(g) + eps, b2 * t),
                      updates, state.nu)
        bc1 = 1 - b1 ** count_inc
        out = tree_map(lambda m, v: (m / bc1) / v, mu, nu)
        return out, ScaleByAdamState(count_inc, mu, nu)
    return _Transform(init, update)


def _scale_by_rms(decay: float, eps: float,
                  initial_scale: float = 0.0) -> _Transform:
    """optax ``scale_by_rms`` (eps inside the square root, no bias
    correction)."""
    def init(params):
        return ScaleByRmsState(tree_map(
            lambda p: torch.full_like(p, initial_scale), params))

    def update(updates, state, params=None):
        nu = tree_map(lambda g, t: (1 - decay) * (g * g) + decay * t,
                      updates, state.nu)
        out = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates)
        return out, ScaleByRmsState(nu)
    return _Transform(init, update)


def _scale_by_rss(initial_accumulator_value: float,
                  eps: float) -> _Transform:
    """optax ``scale_by_rss`` (Adagrad's root of the summed squares)."""
    def init(params):
        return ScaleByRssState(tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params))

    def update(updates, state, params=None):
        sums = tree_map(lambda g, t: g * g + t, updates,
                        state.sum_of_squares)
        out = tree_map(lambda t, g: torch.where(
            t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) * g,
            sums, updates)
        return out, ScaleByRssState(sums)
    return _Transform(init, update)


def _scale_by_adadelta(rho: float, eps: float) -> _Transform:
    """optax ``scale_by_adadelta``."""
    def init(params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return ScaleByAdaDeltaState(zeros(), zeros())

    def update(updates, state, params=None):
        e_g = tree_map(lambda g, t: (1 - rho) * (g * g) + rho * t, updates,
                       state.e_g)
        out = tree_map(lambda g, eg, ex: (torch.sqrt(ex + eps) /
                                          torch.sqrt(eg + eps)) * g,
                       updates, e_g, state.e_x)
        e_x = tree_map(lambda u, t: (1 - rho) * (u * u) + rho * t, out,
                       state.e_x)
        return out, ScaleByAdaDeltaState(e_g, e_x)
    return _Transform(init, update)


def _identity() -> _Transform:
    return _Transform(lambda params: EmptyState(),
                      lambda u, s, p=None: (u, s))


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
    return _polynomial(lr, 0.0, power, max_iteration)


def _polynomial(init_value: float, end_value: float, power,
                transition_steps: int) -> Callable:
    """optax ``polynomial_schedule``: constant when ``transition_steps``
    is not positive."""
    if transition_steps <= 0:
        return lambda count: init_value

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


def _join(schedules, boundaries) -> Callable:
    """optax ``join_schedules``: each schedule after its boundary, given
    the steps since it."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, after in zip(boundaries, schedules[1:]):
            out = torch.where(step < boundary, out, after(step - boundary))
        return out
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
    the fused update reads and by which the optimizer pickles: the
    transformations are closures, so a pickle rebuilds it from them (the
    NNFrames persistence, ``nnframes/nn_estimator.py``)."""

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

    def __reduce__(self):
        kwargs = getattr(self, "_init_kwargs", None)
        if kwargs is None:
            raise TypeError(
                f"{type(self).__name__} cannot be pickled: no recorded "
                "constructor args (custom OptimMethod instances must "
                "set self._init_kwargs or be rebuilt by hand)")
        return (_rebuild_optim, (type(self), dict(kwargs)))


def _rebuild_optim(cls, kwargs):
    return cls(**kwargs)


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
        first = _trace(momentum, nesterov) if momentum else _identity()
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


class AdamWeightDecay(OptimMethod):
    """BERT-style AdamW with linear warmup + linear decay: optax
    ``adamw`` (``scale_by_adam``, then ``add_decayed_weights`` on every
    leaf, then the lr); with ``total > 0`` the lr rises linearly from 0
    over ``warmup_portion * total`` steps, then falls linearly to 0 at
    ``total``."""

    def __init__(self, lr: float = 1e-3, warmup_portion: float = -1.0,
                 total: int = -1, schedule_name: str = "linear",
                 beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-6, weight_decay: float = 0.01):
        self._init_kwargs = dict(
            lr=lr, warmup_portion=warmup_portion, total=total,
            schedule_name=schedule_name, beta_1=beta_1, beta_2=beta_2,
            epsilon=epsilon, weight_decay=weight_decay)
        if total > 0:
            warm = int(max(warmup_portion, 0.0) * total)
            sched = _join([_polynomial(0.0, lr, 1, warm or 1),
                           _polynomial(lr, 0.0, 1, total - warm)],
                          [warm or 1])
        else:
            sched = lr
        super().__init__(
            _chain(_scale_by_adam(beta_1, beta_2, epsilon),
                   _add_decayed_weights(weight_decay),
                   _scale_by_learning_rate(sched)),
            "adamw", sched)


class RMSprop(OptimMethod):
    """optax ``rmsprop``: ``scale_by_rms``, the lr, then identity (no
    momentum)."""

    def __init__(self, lr: float = 1e-3, decay_rate: float = 0.9,
                 epsilon: float = 1e-8, schedule=None):
        self._init_kwargs = dict(lr=lr, decay_rate=decay_rate,
                                 epsilon=epsilon, schedule=schedule)
        sched = _sched(lr, schedule)
        super().__init__(
            _chain(_scale_by_rms(decay_rate, epsilon),
                   _scale_by_learning_rate(sched), _identity()),
            "rmsprop", sched)


class Adagrad(OptimMethod):
    """optax ``adagrad`` (accumulators start at 0.1)."""

    def __init__(self, lr: float = 1e-2, epsilon: float = 1e-10,
                 schedule=None):
        self._init_kwargs = dict(lr=lr, epsilon=epsilon,
                                 schedule=schedule)
        sched = _sched(lr, schedule)
        super().__init__(
            _chain(_scale_by_rss(0.1, epsilon),
                   _scale_by_learning_rate(sched)),
            "adagrad", sched)


class Adadelta(OptimMethod):
    """optax ``adadelta``: a (zero) weight decay, ``scale_by_adadelta``,
    then the lr."""

    def __init__(self, lr: float = 1.0, rho: float = 0.95,
                 epsilon: float = 1e-8):
        self._init_kwargs = dict(lr=lr, rho=rho, epsilon=epsilon)
        super().__init__(
            _chain(_add_decayed_weights(0.0), _scale_by_adadelta(rho, epsilon),
                   _scale_by_learning_rate(lr)),
            "adadelta", lr)


class Adamax(OptimMethod):
    """optax ``adamax``."""

    def __init__(self, lr: float = 2e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8):
        self._init_kwargs = dict(lr=lr, beta_1=beta_1, beta_2=beta_2,
                                 epsilon=epsilon)
        super().__init__(
            _chain(_scale_by_adamax(beta_1, beta_2, epsilon),
                   _scale_by_learning_rate(lr)),
            "adamax", lr)


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
