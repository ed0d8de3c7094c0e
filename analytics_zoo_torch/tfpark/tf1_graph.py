"""TF1 train_op recognition + canonical-graph recompilation (port of the
JAX package's ``tfpark/tf1_graph.py``).

There is no TF session in the hot loop, so the in-graph update op cannot
be "kept".  This module RECOGNIZES the canonical ``Optimizer.minimize`` /
``apply_gradients`` graph shapes — the ``Apply*``/``ResourceApply*``
training ops ``minimize`` emits — and maps them onto the matching native
OptimMethod (same update rule, same hyperparameters, read out of the
graph).  The forward/loss subgraph is recompiled op-by-op into PyTorch
ops (the TorchNet pattern, net/torch_net.py) behind a tight whitelist:
MatMul/BiasAdd stacks with standard activations and the canonical loss
heads.  ANYTHING outside the canonical shapes refuses loudly with the
offending op named.  The graph is read through TensorFlow, imported only
inside the functions that read it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


def _exotic(what: str) -> "NotImplementedError":
    return NotImplementedError(
        f"from_train_op only recognizes canonical TF1 "
        f"Optimizer.minimize/apply_gradients graphs; {what}. "
        "Migrate to TFOptimizer.from_loss(model, criterion, dataset, "
        "optim_method=...) for anything richer.")


# ---------------------------------------------------------------- optimizer
# training-op input layouts (tensorflow/core/ops/training_ops.cc);
# Resource* variants share them with a VarHandleOp in slot 0
_APPLY_SPECS = {
    "ApplyGradientDescent": dict(kind="sgd", var=0, grad=2, lr=1),
    "ApplyMomentum": dict(kind="momentum", var=0, grad=3, lr=2,
                          momentum=4),
    "ApplyKerasMomentum": dict(kind="momentum", var=0, grad=3, lr=2,
                               momentum=4),
    "ApplyAdam": dict(kind="adam", var=0, grad=9, lr=5, beta1=6,
                      beta2=7, epsilon=8),
    "ApplyAdagrad": dict(kind="adagrad", var=0, grad=3, lr=2),
    "ApplyAdagradV2": dict(kind="adagrad", var=0, grad=4, lr=2,
                           epsilon=3),
    "ApplyRMSProp": dict(kind="rmsprop", var=0, grad=7, lr=3, rho=4,
                         momentum=5, epsilon=6),
}
_APPLY_SPECS.update({f"Resource{k}": v for k, v in _APPLY_SPECS.items()})

# op types minimize() wraps around the Apply ops (grouping, the
# optional global_step bump) — safe to traverse / ignore
_WRAPPER_TYPES = ("NoOp", "Identity", "Group")
_IGNORED_TYPES = ("AssignAdd", "AssignAddVariableOp", "Const",
                  "ReadVariableOp", "VarHandleOp")
# optimizer bookkeeping writes (Adam's beta-power bump) — ignorable
# ONLY when the target is one of the Apply ops' own accumulators
_ASSIGN_TYPES = ("Assign", "AssignSub", "AssignVariableOp",
                 "AssignSubVariableOp")


def _collect_apply_ops(train_op) -> List:
    """The Apply*/ResourceApply* ops under a canonical train_op."""
    seen, out, assigns, stack = set(), [], [], [train_op]
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        if op.type in _APPLY_SPECS:
            out.append(op)
        elif op.type in _WRAPPER_TYPES:
            stack.extend(op.control_inputs)
            stack.extend(t.op for t in op.inputs)
        elif op.type in _ASSIGN_TYPES:
            # do NOT descend value inputs: Adam's beta-power bump is
            # Assign(handle, Mul(...)) and the Mul is bookkeeping, not
            # an exotic op; the own-state check below still polices
            # WHAT gets written
            assigns.append(op)
            stack.extend(op.control_inputs)
        elif op.type in _IGNORED_TYPES:
            # inputs too: minimize(global_step=...) hangs the update
            # group off a control dep of the AssignAdd's Const input
            stack.extend(op.control_inputs)
            stack.extend(t.op for t in op.inputs)
        else:
            raise _exotic(
                f"op {op.name!r} (type {op.type}) is not part of one")
    if not out:
        raise _exotic(
            f"no Apply*/ResourceApply* training op found under "
            f"{train_op.name!r}")
    # any Assign inside the train op must be the optimizer writing its
    # OWN accumulators (e.g. Adam's beta powers, which are inputs of
    # the Apply ops); a user-grouped side-effect assign would be
    # silently dropped by recompilation, so it refuses instead
    def _src_name(t):
        # dereference reads: the Apply op consumes beta_power VALUES
        # (ReadVariableOp), the Assign writes the HANDLE
        op = t.op
        while op.type in ("ReadVariableOp", "Identity") and op.inputs:
            op = op.inputs[0].op
        return op.name

    own_state = {_src_name(t) for a in out for t in a.inputs}
    for a in assigns:
        target = a.inputs[0].op.name
        if target not in own_state:
            raise _exotic(
                f"op {a.name!r} (type {a.type}) writes "
                f"{target!r}, which is not optimizer state")
    return out


def recognize_optimizer(train_op, sess):
    """train_op → (native OptimMethod, [variable ops]) or refuse."""
    from analytics_zoo_torch.pipeline.api.keras import optimizers as opt

    apply_ops = _collect_apply_ops(train_op)
    kinds = {op.type for op in apply_ops}
    if len(kinds) > 1:
        raise _exotic(f"mixed training-op types {sorted(kinds)}")
    spec = _APPLY_SPECS[apply_ops[0].type]
    op0 = apply_ops[0]

    # the grads fed to the Apply ops must be minimize()'s own raw
    # autodiff outputs (the "gradients*/" name scope tf.gradients
    # creates) — a user-transformed gradient (clip_by_norm, scaling)
    # fed through apply_gradients would be silently replaced by the
    # native engine's plain d(loss)/d(var) otherwise
    for op in apply_ops:
        g = op.inputs[_APPLY_SPECS[op.type]["grad"]].op
        if not g.name.startswith("gradients"):
            raise _exotic(
                f"gradient {g.name!r} (type {g.type}) feeding "
                f"{op.name!r} is not a raw minimize() gradient — "
                "transformed gradients would be silently dropped")

    def hyper(slot_key):
        # hyperparameters must be graph CONSTANTS: an lr schedule
        # (exponential_decay & co.) would be frozen at its step-0
        # value — refuse rather than silently detach the schedule
        t = op0.inputs[spec[slot_key]]
        if t.op.type not in ("Const",):
            raise _exotic(
                f"optimizer input {slot_key}={t.op.name!r} (type "
                f"{t.op.type}) is not a constant — schedules/dynamic "
                "hyperparameters would be frozen at their current "
                "value")
        return float(sess.run(t))

    kind = spec["kind"]
    if kind == "sgd":
        method = opt.SGD(learning_rate=hyper("lr"))
    elif kind == "momentum":
        method = opt.SGD(learning_rate=hyper("lr"),
                         momentum=hyper("momentum"),
                         nesterov=bool(op0.get_attr("use_nesterov")))
    elif kind == "adam":
        method = opt.Adam(lr=hyper("lr"), beta_1=hyper("beta1"),
                          beta_2=hyper("beta2"),
                          epsilon=hyper("epsilon"))
    elif kind == "adagrad":
        kw = {"epsilon": hyper("epsilon")} if "epsilon" in spec else {}
        method = opt.Adagrad(lr=hyper("lr"), **kw)
    else:  # rmsprop
        if hyper("momentum") != 0.0:
            raise _exotic("RMSProp with momentum has no native "
                          "equivalent")
        method = opt.RMSprop(lr=hyper("lr"), decay_rate=hyper("rho"),
                             epsilon=hyper("epsilon"))
    variables = [op.inputs[spec["var"]].op for op in apply_ops]
    return method, variables


# ------------------------------------------------------------- loss head
_LOSS_HEADS = {
    "SparseSoftmaxCrossEntropyWithLogits":
        "sparse_categorical_crossentropy_with_logits",
    "SoftmaxCrossEntropyWithLogits":
        "categorical_crossentropy_with_logits",
}


def split_loss(loss):
    """loss tensor → (logits_tensor, labels_placeholder, criterion
    name) for the canonical heads:

    * ``reduce_mean(sparse_softmax_cross_entropy_with_logits)``
    * ``reduce_mean(softmax_cross_entropy_with_logits)``
    * ``reduce_mean(squared_difference(pred, y))`` (either order)
    """
    op = loss.op
    if op.type != "Mean":
        raise _exotic(f"loss head {op.name!r} (type {op.type}) is not "
                      "a reduce_mean over a recognized criterion")
    inner = op.inputs[0].op
    if inner.type in _LOSS_HEADS:
        # logits at input 0 ("features"), labels at input 1
        return (inner.inputs[0], inner.inputs[1],
                _LOSS_HEADS[inner.type])
    if inner.type == "SquaredDifference":
        a, b = inner.inputs[0], inner.inputs[1]
        if b.op.type == "Placeholder" and a.op.type != "Placeholder":
            return a, b, "mse"
        if a.op.type == "Placeholder" and b.op.type != "Placeholder":
            return b, a, "mse"
        raise _exotic("squared_difference needs exactly one "
                      "placeholder side (the labels)")
    raise _exotic(f"criterion op {inner.name!r} (type {inner.type}) "
                  "is not recognized")


# ---------------------------------------------------------------- emitter
_ACTIVATIONS = {
    "Relu": lambda x: torch.clamp(x, min=0.0),
    "Relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "Tanh": torch.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "Elu": lambda x: torch.where(x > 0, x, torch.expm1(x)),
    "Softmax": lambda x: torch.exp(x - torch.amax(x, -1, keepdim=True))
    / torch.sum(torch.exp(x - torch.amax(x, -1, keepdim=True)), -1,
                keepdim=True),
}


def _as_tensor(v) -> torch.Tensor:
    """A graph constant or variable value as a tensor, 64-bit values
    narrowed as JAX narrows them without x64."""
    arr = np.asarray(v)
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}
    return torch.from_numpy(np.array(arr, dtype=narrow.get(arr.dtype,
                                                            arr.dtype)))
_VAR_TYPES = ("VarHandleOp", "VariableV2", "Variable")


class TF1GraphNet(Layer):
    """A TF1 logits subgraph recompiled to PyTorch ops, as a trainable Layer
    (the TorchNet pattern for TF1 graphs): variables become params,
    the single non-label Placeholder becomes the layer input."""

    def __init__(self, logits, x_placeholder, values: Dict[str, np.ndarray],
                 constants: Dict[str, np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self._logits = logits
        self._x_name = x_placeholder.op.name
        self._values = values
        # frozen (non-trained) variables: not touched by the train_op,
        # so they embed as constants — same semantics as the TF graph
        self._constants = dict(constants or {})
        self._out_shape = tuple(
            None if d is None else int(d)
            for d in logits.shape.as_list())
        # validate the whole subgraph up front — a refusal at fit()
        # time would be far harder to act on
        self._emit({}, None, dry=True)

    def build(self, rng, input_shape) -> Params:
        return {name: _as_tensor(v) for name, v in self._values.items()}

    def call(self, params, x, training=False, rng=None):
        return self._emit(params, torch.as_tensor(x))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._out_shape[1:]

    # ------------------------------------------------------------ internals
    def _emit(self, params, x, dry: bool = False):
        """Evaluate the TF subgraph as PyTorch ops (graph metadata is
        read in Python; only tensors flow)."""
        import tensorflow as tf

        memo = {}

        def ev(t):
            key = t.ref()
            if key in memo:
                return memo[key]
            op = t.op
            if op.type == "Placeholder":
                if op.name != self._x_name:
                    raise _exotic(
                        f"unexpected extra placeholder {op.name!r} in "
                        "the logits graph")
                val = x
            elif op.type == "Const":
                val = _as_tensor(tf.make_ndarray(op.get_attr("value"))
                                 ).to(x.device)
            elif op.type in ("Identity", "ReadVariableOp"):
                val = ev(op.inputs[0])
            elif op.type in _VAR_TYPES:
                if op.name in self._constants:
                    val = _as_tensor(self._constants[op.name]).to(
                        x.device)
                elif op.name in self._values:
                    val = _as_tensor(self._values[op.name]) if dry \
                        else params[op.name]
                else:
                    raise _exotic(
                        f"variable {op.name!r} is neither trained by "
                        "the train_op nor snapshotted as a constant")
            elif op.type == "MatMul":
                if op.get_attr("transpose_a") or \
                        op.get_attr("transpose_b"):
                    raise _exotic(f"MatMul {op.name!r} with transpose")
                val = ev(op.inputs[0]) @ ev(op.inputs[1])
            elif op.type in ("BiasAdd", "Add", "AddV2"):
                val = ev(op.inputs[0]) + ev(op.inputs[1])
            elif op.type == "Sub":
                val = ev(op.inputs[0]) - ev(op.inputs[1])
            elif op.type == "Mul":
                val = ev(op.inputs[0]) * ev(op.inputs[1])
            elif op.type in _ACTIVATIONS:
                val = _ACTIVATIONS[op.type](ev(op.inputs[0]))
            else:
                raise _exotic(
                    f"op {op.name!r} (type {op.type}) in the logits "
                    "graph is outside the canonical whitelist")
            memo[key] = val
            return val

        if dry:
            # shape-only validation pass: substitute zeros for x
            x = torch.zeros([1] + [int(d) if d is not None else 1
                                   for d in self._x_shape()[1:]],
                            dtype=torch.float32)
        return ev(self._logits)

    def _x_shape(self):
        g = self._logits.graph
        ph = g.get_operation_by_name(self._x_name)
        return tuple(ph.outputs[0].shape.as_list())


def recompile_train_op(train_op, loss, sess):
    """→ (TF1GraphNet, criterion_name, optim_method).

    The one-call façade ``TFOptimizer.from_train_op`` uses: recognize
    the optimizer, split the loss head, recompile the logits subgraph,
    snapshot variable values from the session."""
    method, var_ops = recognize_optimizer(train_op, sess)
    logits, labels, criterion = split_loss(loss)
    if labels.op.type != "Placeholder":
        raise _exotic(
            f"labels {labels.op.name!r} (type {labels.op.type}) must "
            "be a Placeholder")
    values = {op.name: np.asarray(sess.run(op.outputs[0]))
              if op.type != "VarHandleOp"
              else _read_resource_var(op, sess)
              for op in var_ops}
    # find the input placeholder: the one feeding logits that is not
    # the labels; snapshot frozen variables (in the logits graph but
    # not trained by the train_op) as constants along the way
    x_ph, frozen_ops = _scan_logits_graph(logits, labels)
    constants = {op.name: np.asarray(sess.run(op.outputs[0]))
                 if op.type != "VarHandleOp"
                 else _read_resource_var(op, sess)
                 for op in frozen_ops if op.name not in values}
    in_shape = x_ph.shape.as_list()[1:]
    if any(d is None for d in in_shape):
        raise _exotic(
            f"input placeholder {x_ph.op.name!r} has unknown "
            f"non-batch dims {in_shape}")
    net = TF1GraphNet(logits, x_ph, values, constants=constants,
                      input_shape=tuple(int(d) for d in in_shape))
    return net, criterion, method


def _read_resource_var(handle_op, sess):
    """Value of a resource variable given its VarHandleOp."""
    graph = handle_op.graph
    for v in graph.get_collection("variables"):
        if v.op.name == handle_op.name:
            return np.asarray(sess.run(v))
    # fall back to the conventional read op minimize() leaves behind
    try:
        read = graph.get_tensor_by_name(handle_op.name + "/Read/"
                                        "ReadVariableOp:0")
        return np.asarray(sess.run(read))
    except Exception:
        raise _exotic(
            f"cannot read resource variable {handle_op.name!r}")


def _scan_logits_graph(logits, labels):
    """-> (x placeholder tensor, [variable ops in the subgraph])."""
    seen, phs, var_ops, stack = set(), [], [], [logits.op]
    while stack:
        op = stack.pop()
        if id(op) in seen:
            continue
        seen.add(id(op))
        if op.type == "Placeholder":
            phs.append(op)
        elif op.type in _VAR_TYPES:
            var_ops.append(op)
        stack.extend(t.op for t in op.inputs)
    phs = [p for p in phs if p.name != labels.op.name]
    if len(phs) != 1:
        raise _exotic(
            f"expected exactly one input placeholder, found "
            f"{[p.name for p in phs]}")
    return phs[0].outputs[0], var_ops
