"""PyTorch port, ``compile/engine.py`` on the CPU: ``engine_jit``'s
signature, its routes, and the capture-and-replay bookkeeping through a
stand-in for ``torch.cuda.CUDAGraph``.

The stand-in takes CPU tensors.  Its capture runs the captured call once
and then puts back every static input and registered generator as it
was (a real capture executes nothing); its replay re-runs that same call
on the static buffers, with every non-tensor argument frozen at capture
and kernel launches not counted (a replay runs no Python), and writes the
results into the tensors the capture returned (a graph writes its pool).
So the stand-in fails where a real graph would: a Python scalar that
changed, a generator not re-seeded, an output the next replay
overwrites, state fed back but not copied in, a param rebound behind the
graph's back, launches not added per replay.  A host read inside the
capture raises, as CUDA refuses it."""

import contextlib
import threading
import weakref

import numpy as np
import pytest
import torch

from analytics_zoo_torch import init_zoo_context
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.compile import engine as eng
from analytics_zoo_torch.compile import EngineJit, call_signature, engine_jit
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, step_generator)
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import objectives
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, fold_name
from analytics_zoo_torch.pipeline.api.keras.layers import (
    BatchNormalization, Dense, Dropout)
from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves


class StandInGraph:
    def __init__(self):
        self.run = None
        self.outs = None
        self.registered = []
        self.replays = 0


class StandInStream:
    """A stream of the stand-in backend: a key, as ``cuda_stream`` is."""
    keys = iter(range(1, 1 << 30))

    def __init__(self):
        self.key = next(self.keys)


class StandInGraphs:
    """The graph backend of these tests (see the module docstring).  Each
    thread has a current stream, the default one (key 0) unless a block
    of ``on_stream`` or a capture sets another."""

    def __init__(self):
        self.capturing = False
        self._graphs = []
        self.pools = []
        self._users = {}            # pool -> graphs captured into it alive
        self.default = StandInStream()
        self.default.key = 0
        self._local = threading.local()

    @property
    def graphs(self):
        """The graphs alive, in the order they were made."""
        return [g for g in (r() for r in self._graphs) if g is not None]

    def _release(self, pool):
        self._users[pool] -= 1

    def applies(self, device):
        return device.type == "cpu"

    def new_pool(self, device):
        pool = object()
        self.pools.append(pool)
        return pool

    def new_graph(self):
        g = StandInGraph()
        self._graphs.append(weakref.ref(g))
        return g

    def register(self, graph, gen):
        graph.registered.append(gen)

    def side_stream(self, device):
        return StandInStream()

    def current_stream(self, device=None):
        return getattr(self._local, "stream", self.default)

    def stream_key(self, stream):
        return stream.key

    def launch(self, name):
        """A kernel wrapper's count, on the thread's current stream."""
        kernels._count(name, self.current_stream().key)

    @contextlib.contextmanager
    def on_stream(self, stream):
        prev = self.current_stream()
        self._local.stream = stream
        try:
            yield
        finally:
            self._local.stream = prev

    def capture(self, graph, pool, stream, run, inputs=()):
        # as CUDA's allocators: a pool whose graphs all died takes no
        # capture
        if self._users.get(pool, 1) == 0:
            raise RuntimeError("INTERNAL ASSERT FAILED: use_count > 0")
        self._users[pool] = self._users.get(pool, 0) + 1
        weakref.finalize(graph, self._release, pool)
        static = list(inputs)
        saved = [t.clone() for t in static]
        states = [g.get_state() for g in graph.registered]
        self.capturing = True
        try:
            with self.on_stream(stream):
                out = run()
        finally:
            self.capturing = False
            with torch.no_grad():
                for t, s in zip(static, saved):
                    t.copy_(s)
            for g, s in zip(graph.registered, states):
                g.set_state(s)
        graph.run, graph.outs = run, out
        return out, 0

    def replay(self, graph):
        # a replay runs no Python: the re-run's launches are not counted
        private = StandInStream()
        with kernels.record_launches(private.key), self.on_stream(private):
            new = graph.run()
        graph.replays += 1
        old_leaves, new_leaves = [], []
        eng._flatten(graph.outs, old_leaves)
        eng._flatten(new, new_leaves)
        with torch.no_grad():
            for o, n in zip(old_leaves, new_leaves):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)



def host_read(t):
    """``float(t)``, refused inside a capture as CUDA refuses it."""
    if eng._backend.capturing:
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    return float(t)


@pytest.fixture
def graphs():
    init_zoo_context(device="cpu")
    backend = StandInGraphs()
    prev = eng.set_graph_backend(backend)
    yield backend
    eng.set_graph_backend(prev)
    tconfig.get_config().set("compile.aot", True)


def _errors(kind):
    return get_registry().counter(
        "compile_cache_errors_total", labels=("kind",)).labels(kind).value


# ------------------------------------------------------------- signature
def test_signature_keys_structure_shapes_scalars_and_statics():
    a = torch.zeros(2, 3)
    g = torch.Generator().manual_seed(1)
    base = call_signature(({"w": a}, 1.5, g, "x"), static_argnums=(3,))
    assert base == call_signature(({"w": torch.ones(2, 3)}, 1.5,
                                   torch.Generator(), "x"), (3,))
    for other in (({"w": torch.zeros(3, 3)}, 1.5, g, "x"),
                  ({"w": a.double()}, 1.5, g, "x"),
                  ({"v": a}, 1.5, g, "x"),
                  ([a], 1.5, g, "x"),
                  ({"w": a}, 2.5, g, "x"),          # a scalar by VALUE
                  ({"w": a}, 1.5, g, "y")):         # a static by value
        assert call_signature(other, (3,)) != base


def test_the_real_backend_takes_no_cpu_tensor_and_runs_eagerly():
    init_zoo_context(device="cpu")
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    ej = engine_jit(fn, key_hint="cpu")
    assert torch.equal(ej(torch.ones(3)), torch.full((3,), 2.0))
    assert ej.warm(torch.ones(3)) is False
    assert ej.aot_signatures == 0 and calls == [1]


# ---------------------------------------------------------- capture/replay
def _sgd_step(w, x, lr):
    """Updates ``w`` in place (a donated param) and returns a loss."""
    loss = ((x @ w) ** 2).mean()
    grad = 2 * x.t() @ (x @ w) / x.numel()
    w.sub_(lr * grad)
    return w, loss


def test_replays_are_bit_identical_to_eager_calls(graphs):
    rs = np.random.RandomState(0)
    w0 = torch.from_numpy(rs.randn(4, 2).astype(np.float32))
    xs = [torch.from_numpy(rs.randn(8, 4).astype(np.float32))
          for _ in range(5)]
    w_eager = w0.clone()
    eager = [float(_sgd_step(w_eager, x, 0.1)[1]) for x in xs]
    ej = engine_jit(_sgd_step, donate_argnums=(0,), key_hint="sgd")
    w = w0.clone()
    got = []
    for x in xs:
        w, loss = ej(w, x, 0.1)
        got.append(float(loss))
    assert got == eager
    assert torch.equal(w, w_eager)
    assert ej.aot_signatures == 1 and len(graphs.graphs) == 1
    assert graphs.graphs[0].replays == 5


def test_a_python_scalar_keys_the_signature_by_value(graphs):
    ej = engine_jit(lambda x, s: x * s, key_hint="scale")
    x = torch.arange(4.0)
    assert torch.equal(ej(x, 2.0), x * 2.0)
    assert torch.equal(ej(x, 3.0), x * 3.0)        # not the baked 2.0
    assert torch.equal(ej(x, 2.0), x * 2.0)
    assert ej.aot_signatures == 2


def test_an_input_the_caller_keeps_is_never_written(graphs):
    """A batch at a position not donated is copied into the engine's own
    buffer: the caller's tensors keep their values (the eval cache)."""
    ej = engine_jit(lambda p, b: p + b.sum(), donate_argnums=(0,),
                    key_hint="batch")
    p = torch.zeros(2)
    batches = [torch.full((3,), float(i)) for i in range(3)]
    outs = [ej(p, b) for b in batches]
    assert [float(o[0]) for o in outs] == [0.0, 3.0, 6.0]
    assert [float(b[0]) for b in batches] == [0.0, 1.0, 2.0]


def test_outputs_are_not_overwritten_by_the_next_replay(graphs):
    """The Estimator keeps the first step's loss as ``loss_sum = loss``."""
    ej = engine_jit(lambda x: (x * x).sum(), key_hint="loss")
    loss_sum = ej(torch.tensor([1.0, 2.0]))
    first = loss_sum
    loss_sum = loss_sum + ej(torch.tensor([3.0, 4.0]))
    assert float(first) == 5.0 and float(loss_sum) == 30.0


def test_a_rebound_param_is_copied_into_the_captured_tensor(graphs):
    ej = engine_jit(_sgd_step, donate_argnums=(0,), key_hint="rebind")
    x = torch.ones(8, 4)
    w = torch.ones(4, 2)
    w, _ = ej(w, x, 0.1)
    fresh = torch.full((4, 2), 0.5)
    want, want_loss = _sgd_step(fresh.clone(), x, 0.1)
    got, loss = ej(fresh, x, 0.1)
    assert torch.equal(got, want) and float(loss) == float(want_loss)
    assert got is w                      # the captured tensor, updated


def test_launches_are_added_per_replay_and_not_for_warm_or_capture(graphs):
    def fn(x):
        graphs.launch("bias_gelu")
        graphs.launch("bias_gelu")
        return x + 1
    ej = engine_jit(fn, key_hint="launch")
    kernels.reset_launch_counts()
    x = torch.zeros(3)
    assert ej.warm(x) is True
    assert kernels.launch_counts()["bias_gelu"] == 0
    for _ in range(3):
        ej(x)
    assert kernels.launch_counts()["bias_gelu"] == 6
    assert eng.CAPTURE_LOG[-1]["launches"] == {"bias_gelu": 2}


def test_another_threads_launches_and_replays_count_during_a_capture(
        graphs):
    """Only launches on the capturing engine's stream go to its record:
    another thread's launch, or its replay of another program, during
    the warm-up or the capture ran, and counts as it would."""
    def other(x):
        graphs.launch("layernorm_act")
        return x * 3
    other_ej = engine_jit(other, key_hint="other")
    x = torch.zeros(3)
    other_ej.warm(x)

    def fn(x):
        graphs.launch("bias_gelu")
        for work in (lambda: graphs.launch("fused_adam"),
                     lambda: other_ej(x)):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        return x + 1
    ej = engine_jit(fn, key_hint="threads")
    kernels.reset_launch_counts()
    assert ej.warm(x) is True
    # the warm-up and the capture each ran both threads' work once
    counts = kernels.launch_counts()
    assert (counts["bias_gelu"], counts["fused_adam"],
            counts["layernorm_act"]) == (0, 2, 2)
    assert eng.CAPTURE_LOG[-1]["launches"] == {"bias_gelu": 1}
    ej(x)
    assert kernels.launch_counts()["bias_gelu"] == 1


def test_warm_runs_no_step(graphs):
    w = torch.ones(4, 2)
    x = torch.ones(8, 4)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()

    def fn(w, x, g):
        w.add_(torch.rand(w.shape, generator=g))
        return w
    ej = engine_jit(fn, donate_argnums=(0,), key_hint="warm")
    assert ej.warm(w, x, gen) is True
    assert torch.equal(w, torch.ones(4, 2))
    assert torch.equal(gen.get_state(), state)
    assert ej.aot_signatures == 1
    ej(w, x, gen)
    assert ej.aot_signatures == 1 and len(graphs.graphs) == 1
    assert torch.equal(
        w, torch.ones(4, 2) + torch.rand(
            (4, 2), generator=torch.Generator().manual_seed(3)))


def test_aot_bakes_the_static_arguments(graphs):
    ej = engine_jit(lambda x, k: x + k, static_argnums=(1,),
                    key_hint="aot")
    call = ej.aot(torch.zeros(2), 5)
    assert torch.equal(call(torch.ones(2)), torch.full((2,), 6.0))
    assert ej.aot_signatures == 1


def test_signatures_of_one_engine_share_one_pool(graphs):
    ej = engine_jit(lambda x: x * 2, key_hint="pool")
    ej(torch.zeros(2))
    ej(torch.zeros(3))
    assert ej.aot_signatures == 2 and len(graphs.pools) == 1


def test_compile_aot_false_turns_the_whole_path_off(graphs):
    tconfig.get_config().set("compile.aot", False)
    ej = engine_jit(lambda x: x + 1, key_hint="off")
    assert ej.warm(torch.zeros(2)) is False
    assert torch.equal(ej(torch.zeros(2)), torch.ones(2))
    assert ej.aot_signatures == 0 and graphs.graphs == []


def test_a_failed_capture_runs_that_signature_eagerly(graphs):
    calls = []

    def fn(x):
        calls.append(1)
        if host_read(x.sum()) > 100:        # a host read: capture refuses
            return x
        return x * 2
    ej = engine_jit(fn, key_hint="sync")
    before = _errors("capture")
    for _ in range(3):
        assert torch.equal(ej(torch.ones(2)), torch.full((2,), 2.0))
    assert _errors("capture") == before + 1
    assert ej.aot_signatures == 0
    # warm-up, the failed capture, then three eager calls
    assert len(calls) == 5
    # another signature of the same function is not affected
    assert ej.warm(torch.ones(3)) is False


def test_an_execution_error_propagates_and_is_not_absorbed(graphs):
    def fn(x, flag):
        if not eng._backend.capturing and bool(flag.item()):
            raise RuntimeError("device fault")
        return x + 1
    ej = engine_jit(fn, key_hint="fault")
    flag = torch.zeros(())
    ej(torch.zeros(2), flag)
    with pytest.raises(RuntimeError, match="device fault"):
        ej(torch.zeros(2), torch.ones(()))
    assert ej.aot_signatures == 1
    assert torch.equal(ej(torch.zeros(2), flag), torch.ones(2))


def test_a_warm_up_error_propagates(graphs):
    def fn(x):
        raise ValueError("bad shapes")
    with pytest.raises(ValueError, match="bad shapes"):
        engine_jit(fn, key_hint="bad")(torch.zeros(2))


def test_warm_on_a_thread_then_replay_on_another(graphs):
    ej = engine_jit(lambda x: x - 1, key_hint="thread")
    x = torch.zeros(4)
    t = threading.Thread(target=ej.warm, args=(x,))
    t.start()
    t.join()
    assert ej.aot_signatures == 1
    assert torch.equal(ej(torch.ones(4)), torch.zeros(4))


# ------------------------------------------------------------ generators
def test_derived_generators_are_reseeded_before_every_replay(graphs):
    """Dropout through ``fold_name``: consecutive replays draw the eager
    steps' masks, not the captured step's again."""
    def fn(x, rng):
        g = fold_name(fold_name(rng, "block"), "dropout")
        return x * (torch.rand(x.shape, generator=g) > 0.5)
    x = torch.ones(64)
    eager = [fn(x, step_generator(0, i, "cpu")) for i in range(4)]
    assert not torch.equal(eager[0], eager[1])
    ej = engine_jit(fn, key_hint="dropout")
    got = [ej(x, step_generator(0, i, "cpu")) for i in range(4)]
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    # the drawn generator registered; the undrawn parent only re-derived
    assert len(graphs.graphs[0].registered) == 1


def _bn_dropout_model():
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(8, activation="relu", input_shape=(6,)))
    m.add(BatchNormalization())
    m.add(Dropout(0.3))
    m.add(Dense(1))
    m.init(torch.Generator().manual_seed(0))
    return m


def _run_steps(model, n, aot):
    tconfig.get_config().set("compile.aot", aot)
    tr = DistributedTrainer(model, objectives.get("mse"),
                            optim_method=Adam(lr=1e-2))
    params = tr.place_params(model.get_variables()["params"])
    state = tr.replicate(model.get_variables()["state"])
    opt_state = tr.init_opt_state(params)
    rs = np.random.RandomState(1)
    losses = []
    for i in range(n):
        batch = tr.put_batch((rs.randn(16, 6).astype(np.float32),
                              rs.randn(16, 1).astype(np.float32)))
        params, opt_state, state, loss = tr.train_step_at(
            params, opt_state, state, batch, 7, i)
        losses.append(loss)
    return tr, params, opt_state, state, [float(v) for v in losses]


def test_adam_count_and_batchnorm_state_fed_back_match_eager(graphs):
    """Five Adam steps of a BatchNormalization + Dropout model: the fresh
    count and moving statistics each step returns are copied into the
    captured inputs, and the dropout masks follow the steps."""
    model = _bn_dropout_model()
    _, pe, oe, se, le = _run_steps(model, 5, aot=False)
    tr, pg, og, sg, lg = _run_steps(model, 5, aot=True)
    assert tr._train_step_at.aot_signatures == 1
    assert lg == le
    for a, b in zip(tree_leaves((pg, sg)), tree_leaves((pe, se))):
        assert torch.equal(a, b)
    counts = [l for l in tree_leaves(og) if l.dtype == torch.int32]
    assert [int(c) for c in counts] == [5]
    for a, b in zip(tree_leaves(og), tree_leaves(oe)):
        assert torch.equal(a, b)


def test_the_trainer_warm_start_captures_without_a_step(graphs):
    model = _bn_dropout_model()
    tr = DistributedTrainer(model, objectives.get("mse"),
                            optim_method=Adam(lr=1e-2))
    params = tr.place_params(model.get_variables()["params"])
    before = [p.clone() for p in tree_leaves(params)]
    state = tr.replicate(model.get_variables()["state"])
    opt_state = tr.init_opt_state(params)
    host = (np.zeros((16, 6), np.float32), np.zeros((16, 1), np.float32))
    assert tr.warm_start(params, opt_state, state, host, 7) is True
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  before))
    assert tr._dispatch_count == 0
    tr.train_step_at(params, opt_state, state, tr.put_batch(host), 7, 0)
    assert tr._train_step_at.aot_signatures == 1 and \
        len(graphs.graphs) == 1


def test_engine_jit_is_an_engine_jit():
    assert isinstance(engine_jit(lambda x: x), EngineJit)


# ------------------------------------------------------- borrowed weights
def test_borrowed_weights_are_never_written_and_new_ones_capture_again(
        graphs):
    ej = engine_jit(lambda w, x: x @ w, borrow_argnums=(0,),
                    key_hint="borrow")
    rs = np.random.RandomState(2)
    a = torch.from_numpy(rs.randn(4, 2).astype(np.float32))
    b = torch.from_numpy(rs.randn(4, 2).astype(np.float32))
    a_values = a.clone()
    x = torch.ones(3, 4)
    before = get_registry().counter(
        "compile_recaptures_total", labels=("fn",)).labels("borrow").value
    assert torch.equal(ej(a, x), x @ a_values)
    assert torch.equal(ej(a, x), x @ a_values) and ej.recaptures == 0
    assert torch.equal(ej(b, x), x @ b)
    assert torch.equal(a, a_values)
    assert ej.recaptures == 1 and ej.aot_signatures == 1
    assert len(graphs.graphs) == 1 and len(graphs.pools) == 2
    assert torch.equal(ej(b, x), x @ b) and ej.recaptures == 1
    assert get_registry().counter(
        "compile_recaptures_total",
        labels=("fn",)).labels("borrow").value == before + 1
    # a weight updated in place is read as it is now, with no capture
    b.mul_(2)
    assert torch.equal(ej(b, x), x @ b) and ej.recaptures == 1


def test_a_borrowed_tensor_the_caller_dropped_is_not_read(graphs):
    ej = engine_jit(lambda w, x: x * w, borrow_argnums=(0,),
                    key_hint="dropped")
    x = torch.ones(4)
    ej(torch.full((4,), 2.0), x)
    assert torch.equal(ej(torch.full((4,), 3.0), x), torch.full((4,), 3.0))
    assert ej.recaptures == 1


def test_a_position_is_not_both_donated_and_borrowed():
    with pytest.raises(ValueError, match="donated and borrowed"):
        engine_jit(lambda w: w, donate_argnums=(0,), borrow_argnums=(0,))


def _dense_model():
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(3, input_shape=(4,)))
    m.init(torch.Generator().manual_seed(0))
    m.compile(Adam(lr=1e-2), "mse")
    return m


def _values(tree):
    return [t.clone() for t in tree_leaves(tree)]


@pytest.mark.parametrize("call", ["predict", "evaluate"])
def test_new_model_variables_leave_the_old_ones_as_they_were(graphs, call):
    """Predict (or evaluate) with variables A, then with B: A keeps its
    values, and the answer is B's."""
    model = _dense_model()
    rs = np.random.RandomState(3)
    x = rs.randn(8, 4).astype(np.float32)
    y = rs.randn(8, 3).astype(np.float32)

    def run():
        return model.predict(x, batch_size=4) if call == "predict" else \
            model.evaluate(x, y, batch_size=4)["loss"]
    a = model.get_variables()
    a_values = _values(a)
    run()
    b = {"params": {k: {n: torch.from_numpy(
        rs.randn(*t.shape).astype(np.float32)) for n, t in layer.items()}
        for k, layer in a["params"].items()}, "state": a["state"]}
    model.set_variables(b)
    got = run()
    for t, v in zip(tree_leaves(a), a_values):
        assert torch.equal(t, v)
    tconfig.get_config().set("compile.aot", False)
    want = run()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_a_second_fit_leaves_the_first_fits_variables_as_they_were(graphs):
    """The variables a fit handed to the model (BatchNormalization state
    included) stay as they were through predict and another fit."""
    model = _bn_dropout_model()
    model.compile(Adam(lr=1e-2), "mse")
    rs = np.random.RandomState(4)
    x = rs.randn(32, 6).astype(np.float32)
    y = rs.randn(32, 1).astype(np.float32)
    model.fit(x, y, batch_size=8, nb_epoch=1)
    best = model.get_variables()
    best_values = _values(best)
    model.predict(x, batch_size=8)
    model.fit(x, y, batch_size=8, nb_epoch=1)
    model.predict(x, batch_size=8)
    for t, v in zip(tree_leaves(best), best_values):
        assert torch.equal(t, v)


def test_evaluate_keeps_one_runner_for_new_metric_objects(graphs):
    import gc

    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.pipeline.api.keras.metrics import (
        SparseCategoricalAccuracy)
    from analytics_zoo_torch.pipeline.estimator import Estimator
    model = _dense_model()
    rs = np.random.RandomState(5)
    data = FeatureSet.from_ndarrays(rs.randn(8, 4).astype(np.float32),
                                    rs.randint(0, 3, 8).astype(np.int32),
                                    shuffle=False)
    est = Estimator(model)
    first = est.evaluate(
        data, validation_method=[SparseCategoricalAccuracy()], batch_size=4)
    runner = weakref.ref(est._cached_eval_runner[1])
    for _ in range(3):
        assert est.evaluate(
            data, validation_method=[SparseCategoricalAccuracy()],
            batch_size=4) == first
    gc.collect()
    assert runner() is None
    metric = SparseCategoricalAccuracy()
    est.evaluate(data, validation_method=[metric], batch_size=4)
    kept = est._cached_eval_runner[1]
    est.evaluate(data, validation_method=[metric], batch_size=4)
    assert est._cached_eval_runner[1] is kept
