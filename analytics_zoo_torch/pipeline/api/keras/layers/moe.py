"""Mixture-of-Experts, one device (port of
``pipeline/api/keras/layers/moe.py``).

The public GShard/Switch formulation: a learned router picks top-k
experts per token, tokens dispatch to per-expert buffers of ``capacity``
slots through one-hot products (dense dispatch: static shapes, no gather
or scatter), the expert FFNs run batched over a stacked expert dimension,
and a combine product returns the gated outputs.  A token past its
expert's capacity is dropped: its slot mask is built by comparison with
``arange(capacity)``, which gives the zero row ``jax.nn.one_hot`` gives
there (``F.one_hot`` would raise).  Ties in the router go to the first
expert, as ``argmax`` does in both packages.

Dtypes follow the reference's promotion under the bf16 policy: the
router product and the second expert product take bf16 operands and a
bf16 result; the dispatch and the first expert product take a float32
operand beside a bf16-rounded one, so they run in float32; the combine
is float32.

The reference shards the stacked expert weights on the mesh's
``expert`` axis; the port has no mesh yet, so the layer runs on one
device and keeps the axis's name (``EXPERT_AXIS``) for that day.  The
router's load-balancing auxiliary loss (Switch eq. 4) comes with the
output from ``call_with_aux``, and ``aux_loss()`` returns the last
forward's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import get_policy
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params

EXPERT_AXIS = "expert"


def _low_matmul(a, b):
    """``a @ b`` with both operands rounded to the compute dtype and the
    result in it (a bf16 matmul's promotion in JAX); on the CPU the
    product of the rounded values is taken in float32, then rounded."""
    cd = get_policy().compute_dtype
    if cd == torch.float32:
        return a.float() @ b.float()
    ac, bc = a.to(cd), b.to(cd)
    if ac.is_cuda:
        return ac @ bc
    return (ac.float() @ bc.float()).to(cd)


def _rounded(t):
    """``t`` rounded to the compute dtype, widened back to float32."""
    return t.to(get_policy().compute_dtype).float()


class MoE(Layer):
    """Switch/GShard feed-forward: router → top-k dispatch → per-expert
    2-layer FFN → gated combine.  Input (..., d) keeps its shape."""

    def __init__(self, num_experts: int, hidden_dim: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 activation="relu", init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2")
        self.num_experts = int(num_experts)
        self.hidden_dim = int(hidden_dim)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.activation = acts.get(activation)
        self.kernel_init = init
        self._last_aux = None
        self._trace_aux = None

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        e, h = self.num_experts, self.hidden_dim
        params: Params = {}
        self.add_weight(params, rng, "router", (d, e),
                        init=self.kernel_init)
        self.add_weight(params, rng, "w1", (e, d, h),
                        init=self.kernel_init)
        self.add_weight(params, rng, "b1", (e, h), init="zero")
        self.add_weight(params, rng, "w2", (e, h, d),
                        init=self.kernel_init)
        self.add_weight(params, rng, "b2", (e, d), init="zero")
        return params

    def _capacity(self, tokens: int) -> int:
        """Slots per expert for ``tokens`` tokens."""
        return max(int(math.ceil(
            tokens * self.top_k / self.num_experts * self.capacity_factor)),
            1)

    def _route(self, probs, tokens: int):
        """probs (T, E) → (combine (T, E, C), aux scalar)."""
        e = self.num_experts
        cap = self._capacity(tokens)
        slots = torch.arange(cap, device=probs.device)

        def one_round(probs, taken):
            """Assign each token its best remaining expert with capacity
            bookkeeping; returns the gate-weighted combine slab."""
            expert = torch.argmax(probs, dim=-1)                  # (T,)
            gate = torch.amax(probs, dim=-1)                      # (T,)
            onehot = F.one_hot(expert, e).to(probs.dtype)         # (T, E)
            # position of each token within its expert's buffer
            pos = torch.cumsum(onehot, dim=0) - 1.0 + taken[None, :]
            pos_tok = torch.sum(pos * onehot, dim=-1)             # (T,)
            keep = pos_tok < cap
            slot = (pos_tok.to(torch.int32)[:, None] == slots[None, :]
                    ).to(probs.dtype)                             # (T, C)
            combine = (gate * keep)[:, None, None] \
                * onehot[:, :, None] * slot[:, None, :]           # (T,E,C)
            new_taken = taken + torch.sum(onehot * keep[:, None], dim=0)
            return combine, onehot, new_taken

        taken = torch.zeros((e,), dtype=probs.dtype, device=probs.device)
        combine, onehot1, taken = one_round(probs, taken)
        if self.top_k == 2:
            probs2 = probs * (1.0 - onehot1)      # mask the 1st choice
            combine2, _, taken = one_round(probs2, taken)
            combine = combine + combine2
        # Switch load-balancing loss: E * sum_e f_e * p_e
        f = torch.mean(onehot1, dim=0)            # fraction routed
        p = torch.mean(probs, dim=0)              # mean router prob
        aux = e * torch.sum(f * p)
        return combine, aux

    def _call_impl(self, params, x, training=False, rng=None):
        shape = x.shape
        d = shape[-1]
        xt = x.reshape(-1, d)                     # (T, d)
        t = xt.shape[0]

        logits = _low_matmul(xt, params["router"])
        probs = torch.softmax(logits.float(), dim=-1)
        combine, aux = self._route(probs, t)
        self._trace_aux = aux
        self._last_aux = aux
        dispatch = (combine > 0).to(xt.dtype)     # (T, E, C)

        # dispatch → per-expert buffers (E, C, d)
        buf = torch.einsum("tec,td->ecd", dispatch.float(), _rounded(xt))
        h = torch.einsum("ecd,edh->ech", buf, _rounded(params["w1"])) \
            + params["b1"][:, None, :]
        h = self.activation(h) if self.activation else h
        out = _low_matmul(h, params["w2"]) + params["b2"][:, None, :]
        y = torch.einsum("tec,eco->to", combine.to(out.dtype), out)
        return y.reshape(shape).to(x.dtype)

    def aux_loss(self):
        """Load-balancing loss of the most recent forward (add to the
        objective, scaled ~1e-2), or use ``call_with_aux``."""
        if self._last_aux is None:
            raise ValueError(
                "aux_loss(): no forward has run — use call_with_aux(params, "
                "x) to get (output, aux) together")
        return self._last_aux

    def call_with_aux(self, params, x, training=False, rng=None):
        """(output, load_balancing_aux) of one forward."""
        y = self._call_impl(params, x, training=training, rng=rng)
        return y, self._trace_aux

    call = _call_impl

    def compute_output_shape(self, input_shape):
        return input_shape
