"""The fused kernel suite (port of ``ops/fused.py``): the fused optimizer
update and the bias-add→GeLU and LayerNorm→activation epilogues, and the
suite's mode key.

Each function has a CUDA kernel (``csrc/fused_adam.cu``,
``csrc/fused_sgd.cu``, ``csrc/bias_gelu.cu``, ``csrc/layernorm_act.cu``)
and a plain PyTorch version beside it, in the kernel's order of
operations.

* **Fused optimizer update** (``build_fused_update``): clip → moments →
  bias correction → apply in one pass over every float32 leaf, in place
  on the parameter and its moments (the reference aliases them in its
  Pallas call; here the update writes them where they lie).  The optimizer
  state keeps optax's layout, so a state carried from the JAX package
  fits one to one.  On the card a step is one multi-tensor launch
  (``adam_multi_update``, ``sgd_multi_update``; the leaf table of
  ``ops/multi_tensor.py``) that computes the step's scalars (count + 1,
  bias corrections, clip scale) in the kernel from the count, the norm
  and the step size in device memory: the step never syncs the host.  The
  one-leaf updates take their scalars from a 4-float buffer
  (``step_scalars``), through the same kernel.
* **Epilogues** (``bias_gelu``, ``layernorm_act``): forward by the
  kernel; the gradient is autograd of the plain version (the reference
  defines no backward kernel for them: XLA differentiates its lax form).

Mode selection (``ops.fused`` config key):

* ``auto`` (default) — the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors.
* ``torch`` — the plain versions everywhere (the reference's ``lax``).
* ``off`` — the suite is off; call sites take their unfused forms (the
  trainer runs the optimizer's own ``update``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from analytics_zoo_torch.compile.engine import register_trace_key
from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.ops import multi_tensor as mt

MODES = ("auto", "torch", "off")


def _mode() -> str:
    from analytics_zoo_torch.common.config import get_config
    m = str(get_config().get("ops.fused", "auto") or "auto").lower()
    if m not in MODES:
        raise ValueError(f"ops.fused={m!r}; the port takes one of {MODES}")
    return m


# a captured program bakes in the route it took (compile/engine.py)
register_trace_key(_mode)


def fused_enabled() -> bool:
    """Whether the fused call sites should fire at all."""
    return _mode() != "off"


def use_kernel(x: torch.Tensor) -> bool:
    """Kernel or plain version for this tensor: the kernel exactly when
    the tensor lies on the card and the mode is ``auto``."""
    return x.is_cuda and _mode() == "auto"


def _check_cuda_f32(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: the kernel takes float32, "
                             f"{name} is {t.dtype}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs on different devices {devices}")


def _check_no_grad_path(kernel: str, entry: str, *tensors) -> None:
    """A kernel wrapper's output has no gradient path: refuse to drop one
    silently (the differentiable entry goes through autograd)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} is forward-only: its output has no "
                           f"gradient path; call {entry} for a "
                           "differentiable result")


# ===================================================== optimizer kernels
CLIP_SCALE, CLIP_CONST, WEIGHT_DECAY, NESTEROV, TRACE = 1, 2, 4, 8, 16


def step_scalars(clip_scale, step_size, bias_corr1=0.0, bias_corr2=0.0,
                 device=None) -> torch.Tensor:
    """The 4-float buffer ``[clip_scale, step_size, bc1, bc2]`` the
    one-leaf updates read (the reference's SMEM scalars).  Each entry is
    a Python number or a 0-dim tensor already on ``device``; numbers are
    filled on the device, so building it never syncs the host."""
    def scalar(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.stack([scalar(1.0 if clip_scale is None else clip_scale),
                        scalar(step_size), scalar(bias_corr1),
                        scalar(bias_corr2)])


def clip_scale_of(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """l2-norm clipping's scale ``min(1, a / (gnorm + 1e-12))``, as the
    trainer computes it (``a / t`` is ``t.reciprocal() * a`` in PyTorch,
    and the multi-tensor kernels repeat that; a NaN norm gives NaN)."""
    return torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)


def adam_scalars(count, step_size, b1: float, b2: float, gnorm=None,
                 clip_norm: float = 1.0):
    """Plain version of the step's Adam scalars, which the multi-tensor
    kernel computes in each block: ``(count + 1 saturating,
    step_scalars(clip_scale, step_size, 1 - b1**count_inc,
    1 - b2**count_inc))``, in float32 on the device."""
    from analytics_zoo_torch.pipeline.api.keras.optimizers import (
        safe_increment)
    count_inc = safe_increment(count)
    clip_scale = None if gnorm is None else clip_scale_of(gnorm, clip_norm)
    return count_inc, step_scalars(clip_scale, step_size,
                                   1 - b1 ** count_inc, 1 - b2 ** count_inc,
                                   count.device)


def _prologue(p, g, scal, weight_decay, clip_const, use_clip_scale):
    if use_clip_scale:
        g = g * scal[0]
    if clip_const is not None:
        g = torch.clamp(g, clip_const[0], clip_const[1])
    if weight_decay:
        g = g + weight_decay * p
    return g


def _flags(weight_decay, clip_const, use_clip_scale) -> int:
    return ((CLIP_SCALE if use_clip_scale else 0) |
            (CLIP_CONST if clip_const is not None else 0) |
            (WEIGHT_DECAY if weight_decay else 0))


def _check_leaf(kernel: str, scal, **leaf) -> None:
    """The leaf tensors (param, grad, moments) share one shape and are
    contiguous float32 CUDA tensors on one device, as is ``scal``."""
    _check_cuda_f32(kernel, scal=scal, **leaf)
    if scal.shape != (4,):
        raise ValueError(f"{kernel}: scal must hold 4 floats, got "
                         f"{tuple(scal.shape)}")
    shape = leaf["p"].shape
    for name, t in leaf.items():
        if t.shape != shape:
            raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)} != "
                             f"p shape {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous (the "
                             "kernel updates in place)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _step_sources(kernel: str, device, step_size, gnorm):
    """The step size as (pointer, value) and the norm's pointer, each
    tensor checked to be a float32 scalar on ``device``."""
    for name, t in (("step_size", step_size), ("gnorm", gnorm)):
        if isinstance(t, torch.Tensor) and (
                t.device != device or t.dtype != torch.float32 or
                t.numel() != 1):
            raise ValueError(f"{kernel}: {name} must be a float32 scalar "
                             f"tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if isinstance(step_size, torch.Tensor):
        return step_size.data_ptr(), 0.0, _ptr(gnorm)
    return None, float(step_size), _ptr(gnorm)


def _adam_plain(p, g, mu, nu, scal, b1, b2, eps, weight_decay, clip_const,
                use_clip_scale):
    g = _prologue(p, g, scal, weight_decay, clip_const, use_clip_scale)
    # optax.tree_update_moment order: (1-decay)*(g**order) + decay*t
    mu_n = (1.0 - b1) * g + b1 * mu
    nu_n = (1.0 - b2) * (g * g) + b2 * nu
    mh = mu_n / scal[2]
    vh = nu_n / scal[3]
    u = mh / (torch.sqrt(vh) + eps)
    p_n = p + scal[1] * u
    p.copy_(p_n)
    mu.copy_(mu_n)
    nu.copy_(nu_n)


def _sgd_plain(p, g, trace, scal, momentum, nesterov, weight_decay,
               clip_const, use_clip_scale):
    g = _prologue(p, g, scal, weight_decay, clip_const, use_clip_scale)
    if trace is not None:
        tr = g + momentum * trace           # optax.trace: f(g, t)
        u = g + momentum * tr if nesterov else tr
        trace.copy_(tr)
    else:
        u = g
    p.copy_(p + scal[1] * u)


def adam_leaf_update(p, g, mu, nu, scal, *, b1: float, b2: float,
                     eps: float, weight_decay: float = 0.0,
                     clip_const: Optional[Tuple[float, float]] = None,
                     use_clip_scale: bool = False):
    """One-leaf fused Adam step, in place on ``p``, ``mu`` and ``nu``
    (returned).  Reproduces ``scale_by_adam → scale_by_learning_rate →
    apply_updates`` op for op; ``scal`` is ``step_scalars(clip_scale,
    step_size, 1 - b1**count, 1 - b2**count)`` with the NEGATIVE
    learning rate as ``step_size``.  On the card: the multi-tensor kernel
    with a one-leaf table, reading its scalars from ``scal``."""
    if use_kernel(p):
        name = "fused_adam"
        _check_leaf(name, scal, p=p, g=g, mu=mu, nu=nu)
        (rows, _), = mt.leaf_tables(
            [[p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr()]],
            [p.numel()])
        lo, hi = clip_const if clip_const is not None else (0.0, 0.0)
        kernels.launch(name, p.device, rows.ctypes.data, len(rows),
                       scal.data_ptr(), None, None, None, None, None, 0.0,
                       0.0, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                       float(weight_decay), float(lo), float(hi),
                       _flags(weight_decay, clip_const, use_clip_scale))
        return p, mu, nu
    _adam_plain(p, g, mu, nu, scal, b1, b2, eps, weight_decay, clip_const,
                use_clip_scale)
    return p, mu, nu


def sgd_leaf_update(p, g, trace, scal, *, momentum: float, nesterov: bool,
                    weight_decay: float = 0.0,
                    clip_const: Optional[Tuple[float, float]] = None,
                    use_clip_scale: bool = False):
    """One-leaf fused SGD(+momentum) step mirroring ``trace → scale`` +
    ``apply_updates``, in place on ``p`` and ``trace`` (returned; ``trace``
    is None without momentum).  ``scal`` is ``step_scalars(clip_scale,
    step_size)``.  On the card: the multi-tensor kernel with a one-leaf
    table."""
    if use_kernel(p):
        name = "fused_sgd"
        moments = {} if trace is None else {"trace": trace}
        _check_leaf(name, scal, p=p, g=g, **moments)
        (rows, _), = mt.leaf_tables(
            [[p.data_ptr(), g.data_ptr(), _ptr(trace) or 0]], [p.numel()])
        kernels.launch(name, p.device, rows.ctypes.data, len(rows),
                       scal.data_ptr(), None, None, 0.0, 0.0,
                       *_sgd_hyper(momentum, nesterov, weight_decay,
                                   clip_const, use_clip_scale,
                                   trace is not None))
        return p, trace
    _sgd_plain(p, g, trace, scal, momentum, nesterov, weight_decay,
               clip_const, use_clip_scale)
    return p, trace


def _sgd_hyper(momentum, nesterov, weight_decay, clip_const, use_clip_scale,
               has_trace):
    """zoo_multi_sgd's momentum, wd, lo, hi and flags."""
    lo, hi = clip_const if clip_const is not None else (0.0, 0.0)
    flags = (_flags(weight_decay, clip_const, use_clip_scale) |
             (NESTEROV if nesterov else 0) | (TRACE if has_trace else 0))
    return float(momentum), float(weight_decay), float(lo), float(hi), flags


def adam_multi_update(ps, gs, mus, nus, count, step_size, *, b1: float,
                      b2: float, eps: float, weight_decay: float = 0.0,
                      clip_const: Optional[Tuple[float, float]] = None,
                      gnorm: Optional[torch.Tensor] = None,
                      clip_norm: float = 1.0,
                      cache: Optional[mt.TableCache] = None,
                      scalars_out: Optional[torch.Tensor] = None):
    """One fused Adam step over every leaf, in place on ``ps``, ``mus`` and
    ``nus``; returns the new count (a new int32 0-dim tensor).

    ``count`` is ``ScaleByAdamState.count`` before the step, on the
    leaves' device; ``step_size`` the NEGATIVE learning rate, a number or
    a float32 0-dim tensor (a schedule's); ``gnorm`` the global gradient
    norm under l2-norm clipping to ``clip_norm``, else None.  On the card
    one launch (a leaf set longer than a table: as few as fit) computes
    the step's scalars and updates every leaf; ``cache`` keeps the leaf
    table from step to step.  ``scalars_out`` (4 float32s), when given,
    receives ``[clip_scale, step_size, bc1, bc2]`` as the update computed
    them.  Elsewhere the plain versions run leaf by leaf."""
    use_clip_scale = gnorm is not None
    if use_kernel(count):
        name = "fused_adam"
        dev = count.device
        if count.dtype != torch.int32 or count.numel() != 1:
            raise ValueError(f"{name}: count must be an int32 scalar, got "
                             f"{count.dtype} {tuple(count.shape)}")
        step_ptr, step_value, gnorm_ptr = _step_sources(name, dev,
                                                        step_size, gnorm)
        if scalars_out is not None:
            _check_cuda_f32(name, scalars_out=scalars_out)
            if scalars_out.shape != (4,) or scalars_out.device != dev:
                raise ValueError(f"{name}: scalars_out must hold 4 floats "
                                 f"on {dev}")
        leaf_set = (cache or mt.TableCache()).get([ps, None, mus, nus])
        if leaf_set.device != dev:
            raise ValueError(f"{name}: count on {dev}, leaves on "
                             f"{leaf_set.device}")
        count_inc = torch.empty((), dtype=torch.int32, device=dev)
        lo, hi = clip_const if clip_const is not None else (0.0, 0.0)
        flags = _flags(weight_decay, clip_const, use_clip_scale)
        for address, rows in leaf_set.fill(gs):
            kernels.launch(name, dev, address, rows, None, count.data_ptr(),
                           count_inc.data_ptr(), gnorm_ptr, step_ptr,
                           _ptr(scalars_out), step_value, float(clip_norm),
                           b1, 1.0 - b1, b2, 1.0 - b2, eps,
                           float(weight_decay), float(lo), float(hi), flags)
        return count_inc
    count_inc, scal = adam_scalars(count, step_size, b1, b2, gnorm,
                                   clip_norm)
    for p, g, m, v in zip(ps, gs, mus, nus):
        _adam_plain(p, g, m, v, scal, b1, b2, eps, weight_decay, clip_const,
                    use_clip_scale)
    if scalars_out is not None:
        scalars_out.copy_(scal)
    return count_inc


def sgd_multi_update(ps, gs, traces, step_size, *, momentum: float,
                     nesterov: bool, weight_decay: float = 0.0,
                     clip_const: Optional[Tuple[float, float]] = None,
                     gnorm: Optional[torch.Tensor] = None,
                     clip_norm: float = 1.0,
                     cache: Optional[mt.TableCache] = None) -> None:
    """One fused SGD(+momentum) step over every leaf, in place on ``ps``
    and ``traces`` (None without momentum).  ``step_size``, ``gnorm``,
    ``clip_norm`` and ``cache`` as for ``adam_multi_update``: on the card
    one launch a step; elsewhere the plain versions leaf by leaf."""
    use_clip_scale = gnorm is not None
    if ps and use_kernel(ps[0]):
        name = "fused_sgd"
        dev = ps[0].device
        step_ptr, step_value, gnorm_ptr = _step_sources(name, dev,
                                                        step_size, gnorm)
        leaf_set = (cache or mt.TableCache()).get([ps, None, traces])
        hyper = _sgd_hyper(momentum, nesterov, weight_decay, clip_const,
                           use_clip_scale, traces is not None)
        for address, rows in leaf_set.fill(gs):
            kernels.launch(name, dev, address, rows, None, gnorm_ptr,
                           step_ptr, step_value, float(clip_norm), *hyper)
        return
    clip_scale = None if gnorm is None else clip_scale_of(gnorm, clip_norm)
    scal = step_scalars(clip_scale, step_size,
                        device=ps[0].device if ps else None)
    for p, g, t in zip(ps, gs, traces or [None] * len(ps)):
        _sgd_plain(p, g, t, scal, momentum, nesterov, weight_decay,
                   clip_const, use_clip_scale)


def build_fused_update(optim, clip=None) -> Optional[Callable]:
    """Return ``update(grads, opt_state, params) -> (params, opt_state)``
    fusing clip+moments+apply into one pass over every leaf, in place, or
    None when the (optimizer, clip) combination isn't supported — the
    trainer then runs the optimizer's own ``update``.

    Supported: ``SGD`` (momentum/nesterov/weight_decay, float or schedule
    lr, dampening 0) and ``Adam`` (float or schedule lr incl. the Keras
    ``decay`` form) from ``pipeline/api/keras/optimizers.py``; ``clip`` is
    a trainer ``ClipSpec`` (const or l2norm) or None.  The state keeps
    its layout: the moments are updated where they lie and the counts
    are replaced.  On the card a step is one multi-tensor launch (with an
    l2-norm clip, the global norm before it; with a schedule, the
    schedule's ops before it and its count's increment after), the leaf
    table kept from step to step."""
    from analytics_zoo_torch.pipeline.api.keras import optimizers as opt
    if optim is None or not fused_enabled():
        return None
    kind = type(optim).__name__
    kw = getattr(optim, "_init_kwargs", None)
    if kind not in ("SGD", "Adam") or kw is None:
        return None
    if kind == "SGD" and kw.get("dampening"):
        return None
    if clip is not None and clip.kind not in ("const", "l2norm"):
        return None
    lr = optim.learning_rate
    has_sched = callable(lr)

    # validate the state layout once on a tiny tree: anything beyond
    # {Trace|ScaleByAdam} + optional ScaleBySchedule + empties means a
    # transformation this update does not reproduce — decline
    probe = opt.collect_states(optim.init({"w": torch.zeros(8)}))
    traces = [s for s in probe if isinstance(s, opt.TraceState)]
    adams = [s for s in probe if isinstance(s, opt.ScaleByAdamState)]
    scheds = [s for s in probe if isinstance(s, opt.ScaleByScheduleState)]
    if kind == "Adam" and (len(adams) != 1 or traces):
        return None
    if kind == "SGD" and (adams or len(traces) > 1):
        return None
    if len(scheds) > (1 if has_sched else 0):
        return None

    weight_decay = float(kw.get("weight_decay") or 0.0) \
        if kind == "SGD" else 0.0
    momentum = float(kw.get("momentum") or 0.0) if kind == "SGD" else 0.0
    nesterov = bool(kw.get("nesterov")) if kind == "SGD" else False
    b1 = float(kw.get("beta_1", 0.9)) if kind == "Adam" else 0.0
    b2 = float(kw.get("beta_2", 0.999)) if kind == "Adam" else 0.0
    eps = float(kw.get("epsilon", 1e-8)) if kind == "Adam" else 0.0
    clip_const = (float(clip.a), float(clip.b)) \
        if (clip is not None and clip.kind == "const") else None
    clip_norm = float(clip.a) if (clip is not None and
                                  clip.kind == "l2norm") else None
    cache = mt.TableCache()

    def update(grads, opt_state, params):
        from analytics_zoo_torch.pipeline.api.keras.topology import (
            tree_leaves)
        # a convolution's kernel gradient comes back through the permute
        # from the (*K, Cin, Cout) kernel to the (Cout, Cin, *K) weight the
        # convolution takes, strided; the kernels read each leaf densely
        flat_p = tree_leaves(params)
        flat_g = [g.contiguous() for g in tree_leaves(grads)]
        # one read sweep for the global norm — the only pre-pass left
        gnorm = None if clip_norm is None else opt.global_norm(flat_g)
        common = dict(gnorm=gnorm, clip_norm=clip_norm or 1.0,
                      clip_const=clip_const, cache=cache)

        states = opt.collect_states(opt_state)
        sched_state = next((s for s in states if isinstance(
            s, opt.ScaleByScheduleState)), None)
        if has_sched:
            if sched_state is None:
                raise ValueError("schedule lr without schedule state")
            # scale_by_schedule: step_size = fn(count) PRE-increment
            step_size = (-1 * lr(sched_state.count)).to(torch.float32)
        else:
            step_size = -1 * float(lr)

        if kind == "Adam":
            st = next(s for s in states
                      if isinstance(s, opt.ScaleByAdamState))
            count_inc = adam_multi_update(
                flat_p, flat_g, tree_leaves(st.mu), tree_leaves(st.nu),
                st.count, step_size, b1=b1, b2=b2, eps=eps, **common)
        else:
            trace_state = next((s for s in states
                                if isinstance(s, opt.TraceState)), None)
            sgd_multi_update(
                flat_p, flat_g, None if trace_state is None
                else tree_leaves(trace_state.trace), step_size,
                momentum=momentum, nesterov=nesterov,
                weight_decay=weight_decay, **common)

        def rebuild(s):
            if isinstance(s, opt.ScaleByAdamState):
                return opt.ScaleByAdamState(count=count_inc, mu=s.mu,
                                            nu=s.nu)
            if isinstance(s, opt.ScaleByScheduleState):
                return opt.ScaleByScheduleState(
                    count=opt.safe_increment(s.count))
            return s
        return params, opt.map_states(opt_state, rebuild)

    return update


# ------------------------------------------------------------- bias→GeLU
def bias_gelu_ref(x, bias):
    """Plain version: ``gelu_tanh(x + bias)``."""
    return acts.gelu(x + bias)


def bias_gelu_kernel(x, bias):
    """``gelu_tanh(x + bias)`` by the CUDA kernel; x (..., d), bias (d,).
    Forward only: ``bias_gelu`` is the differentiable entry."""
    name = "bias_gelu"
    _check_cuda_f32(name, x=x, bias=bias)
    _check_no_grad_path(name, "bias_gelu", x, bias)
    d = x.shape[-1]
    if bias.shape != (d,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != ({d},)")
    x, bias = x.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    kernels.launch(name, x.device, x.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), rows, d)
    return out


def _grad_of_plain(plain, inputs, needs, dout):
    """Gradients of ``plain(*inputs)`` by autograd, for the inputs marked
    in ``needs`` (None for the others): the backward of a kernel whose
    reference has no backward kernel."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        out = plain(*leaves)
        wanted = [x for x, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, dout))
    return tuple(next(grads) if n else None for n in needs)


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_gelu_kernel(x, bias)

    @staticmethod
    def backward(ctx, dout):
        return _grad_of_plain(bias_gelu_ref, ctx.saved_tensors,
                              ctx.needs_input_grad, dout)


def bias_gelu(x, bias):
    """Fused bias-add→GeLU epilogue (the dense/FFN tail); differentiable."""
    if use_kernel(x):
        return _BiasGelu.apply(x, bias)
    return bias_gelu_ref(x, bias)


# --------------------------------------------------------- LayerNorm→act
KERNEL_ACTIVATIONS = {None: 0, acts.gelu: 1}


def layernorm_act_ref(x, gamma, beta, eps: float = 1e-5,
                      activation: Optional[Callable] = None):
    """Plain version, in the reference's lax order: biased variance,
    ``(x - mean) / sqrt(var + eps) * gamma + beta``, cast, activation."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    y = (y * gamma + beta).to(x.dtype)
    if activation is not None:
        y = activation(y)
    return y


def layernorm_act_kernel(x, gamma, beta, eps: float = 1e-5,
                         activation: Optional[Callable] = None):
    """LayerNorm→activation by the CUDA kernel; activation None or gelu.
    Forward only: ``layernorm_act`` is the differentiable entry."""
    name = "layernorm_act"
    _check_cuda_f32(name, x=x, gamma=gamma, beta=beta)
    _check_no_grad_path(name, "layernorm_act", x, gamma, beta)
    if activation not in KERNEL_ACTIVATIONS:
        raise ValueError(f"{name}: the kernel applies no activation or "
                         f"tanh-GeLU, not {activation}")
    d = x.shape[-1]
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"{name}: gamma/beta must be ({d},), got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    kernels.launch(name, x.device, x.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr(), out.data_ptr(), rows, d, float(eps),
                   KERNEL_ACTIVATIONS[activation])
    return out


class _LayerNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, activation):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.activation = eps, activation
        return layernorm_act_kernel(x, gamma, beta, eps, activation)

    @staticmethod
    def backward(ctx, dout):
        def plain(x, gamma, beta):
            return layernorm_act_ref(x, gamma, beta, ctx.eps, ctx.activation)
        return _grad_of_plain(plain, ctx.saved_tensors,
                              ctx.needs_input_grad[:3], dout) + (None, None)


def layernorm_act(x, gamma, beta, eps: float = 1e-5,
                  activation: Optional[Callable] = None):
    """Fused LayerNorm→activation; differentiable."""
    if use_kernel(x):
        return _LayerNormAct.apply(x, gamma, beta, eps, activation)
    return layernorm_act_ref(x, gamma, beta, eps=eps, activation=activation)
