"""The float32 flash kernels at head_dim 192 and 256, held on the CPU.

``csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd.cu`` take
float32 q, k, v at head_dim 192 and 256 as well as 64 and 128 (the
reference routes any multiple of 64 to its Pallas kernels while
``t * head_dim <= 4096 * 128``).  The kernels cannot run here, so:

- the plain versions (``flash_attention_ref`` and the backward's) against
  the Pallas kernels in interpret mode (``_flash_fwd_impl``; ``jax.vjp``
  through ``flash_attention``), at T = 256, causal and not;
- the kernels' split-TF32 arithmetic, emulated in PyTorch
  (``test_torch_flash_split_tf32.py``), against the same, within the
  tolerances the card holds the kernels to: the longer sums over d keep
  them;
- a transformer ``TextClassifier`` whose heads are 256 and 192 wide
  (``token_length=256, n_head=1`` and ``token_length=384, n_head=2``),
  against the JAX package from the same weights: ``predict``, one Adam
  step's params and three steps' losses.  Here both packages take dense
  attention (a CPU tensor; ``pallas_supported()`` is False); on the card
  the port's layer routes these widths to the kernels
  (``kernel_supports``), as the reference routes them to Pallas.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_fwd_impl, _resolve_blocks, flash_attention as j_flash,
)
from analytics_zoo_tpu.parallel.trainer import DistributedTrainer as JTrainer
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.inference.inference_model import (
    InferenceModel as JInferenceModel,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import flash_attention as tfa
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import (
    MultiHeadSelfAttention,
)
from analytics_zoo_torch.pipeline.inference import InferenceModel

from test_torch_flash_split_tf32 import (
    BWD_TOL, FWD_LSE_TOL, FWD_TOL, split_backward, split_forward,
)

WIDE = (192, 256)
T = 256
# the plain versions against the Pallas kernels: one float32 formula in
# two orders of summation
PLAIN_ATOL = 1e-5
LOSS = "sparse_categorical_crossentropy_with_logits"
PREDICT_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-6
# Adam's first update is lr * g / (|g| + epsilon): at epsilon 1e-8 a
# gradient element that cancels to ~1e-9 moves by ~lr whatever its last
# ulps, so two correct sums in other orders give updates up to 2 * lr
# apart (seen: 2.6e-5 on 2 of 65,536 embedding elements).  At epsilon
# 1e-3 an update's slope in g is at most lr / epsilon = 1, and one step's
# params hold to 1e-6 (tests/test_torch_regularizers.py does the same).
ADAM = dict(lr=1e-3, epsilon=1e-3)
LOSS_ATOL = 1e-4
# (token_length, n_head): heads of 256 and of 192
MODELS = [(256, 1), (384, 2)]


def _inputs(d, causal, n, salt):
    rs = np.random.RandomState(d + 2 * causal + salt)
    return [rs.randn(1, 2, T, d).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_plain_forward_matches_pallas_forward(d, causal):
    q, k, v = _inputs(d, causal, 3, 0)
    blocks = _resolve_blocks(T, 256, 256)
    jo, jl = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             (causal, d ** -0.5, *blocks, True))
    o, lse = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in
                                       (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=PLAIN_ATOL,
                               rtol=0, err_msg="O")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=PLAIN_ATOL,
                               rtol=0, err_msg="LSE")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_plain_backward_matches_pallas_vjp(d, causal):
    q, k, v, do = _inputs(d, causal, 4, 1)
    _, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=PLAIN_ATOL, rtol=0,
                                   err_msg=name)
    # and through the op's autograd, which takes the same plain versions here
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal)
    for g, w in zip(torch.autograd.grad(out, leaves, tdo), got):
        assert torch.equal(g, w)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_split_tf32_forward_keeps_the_card_tolerance(d, causal):
    q, k, v = _inputs(d, causal, 3, 2)
    blocks = _resolve_blocks(T, 256, 256)
    jo, jl = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             (causal, d ** -0.5, *blocks, True))
    o, lse = split_forward(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), err_msg="O",
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), err_msg="LSE",
                               **FWD_LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_split_tf32_backward_keeps_the_card_tolerance(d, causal):
    q, k, v, do = _inputs(d, causal, 4, 3)
    _, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = split_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                         causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


# ------------------------------------------------ a model at these widths
@pytest.fixture
def _port_f32(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _config(token_length, n_head):
    return dict(class_num=5, token_length=token_length, sequence_length=T,
                encoder="transformer", n_head=n_head, n_block=2,
                max_words_num=100)


def _zero_dropout(model):
    for layer in model.model.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0


def _both_models(token_length, n_head):
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**_config(token_length, n_head))
    _zero_dropout(jmodel)
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**_config(token_length, n_head))
    _zero_dropout(tmodel)
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    heads = [l for l in tmodel.model.layers
             if isinstance(l, MultiHeadSelfAttention)]
    assert heads and all(l.head_dim == token_length // n_head for l in heads)
    return jmodel, tmodel


@pytest.mark.parametrize("token_length,n_head", MODELS)
def test_text_classifier_predict_matches_reference(_port_f32, token_length,
                                                    n_head):
    jmodel, tmodel = _both_models(token_length, n_head)
    x = np.random.RandomState(0).randint(0, 101, size=(4, T))
    want = JInferenceModel().load_zoo(jmodel).predict(x, batch_size=4)
    got = InferenceModel().load_zoo(tmodel).predict(x, batch_size=4)
    assert got.shape == (4, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=PREDICT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("token_length,n_head", MODELS)
def test_text_classifier_adam_steps_match_reference(_port_f32, token_length,
                                                     n_head):
    """One Adam step's params within 1e-6 (at ``ADAM``'s epsilon), then
    two more: each of the three steps' losses within 1e-4."""
    jmodel, tmodel = _both_models(token_length, n_head)
    rs = np.random.RandomState(3)
    x, y = rs.randint(0, 101, size=(8, T)), rs.randint(0, 5, size=(8,))
    jtr = JTrainer(jmodel.model, jobj.get(LOSS),
                   optim_method=jopt.Adam(**ADAM))
    ttr = DistributedTrainer(tmodel.model, tobj.get(LOSS),
                             optim_method=topt.Adam(**ADAM))
    jv, tv = jmodel.get_variables(), tmodel.get_variables()
    jp, js = jtr.place_params(jv["params"]), jtr.replicate(jv["state"])
    jo = jtr.init_opt_state(jp)
    tp, ts = ttr.place_params(tv["params"]), ttr.replicate(tv["state"])
    to = ttr.init_opt_state(tp)
    jb, tb = jtr.put_batch((x, y)), ttr.put_batch((x, y))
    for i in range(3):
        jp, jo, js, jloss = jtr.train_step(
            jp, jo, js, jb, jax.random.fold_in(jax.random.PRNGKey(0), i))
        tp, to, ts, tloss = ttr.train_step(tp, to, ts, tb,
                                           step_generator(0, i, "cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   atol=LOSS_ATOL, rtol=0)
        if i == 0:
            want = jax.device_get(jp)
            for layer in sorted(want):
                for name in sorted(want[layer]):
                    np.testing.assert_allclose(
                        tp[layer][name].detach().numpy(),
                        np.asarray(want[layer][name]),
                        atol=STEP_PARAM_ATOL, rtol=0,
                        err_msg=f"{layer}/{name}")
