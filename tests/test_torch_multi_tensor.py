"""PyTorch port, the multi-tensor optimizer update on the CPU: the leaf
table that one launch a step takes (``ops/multi_tensor.py``, the format of
``csrc/multi_tensor.cuh``), a plain walk of that table chunk by chunk
against the per-leaf plain updates, and ``build_fused_update`` over a
NeuralCF-shaped tree against the JAX package's.

The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py holds them bit for bit against the plain
versions).  Against the JAX package, atol 1e-6: the only differences are
single-ulp ones in ``b ** count`` and the clip scale's division (XLA's and
PyTorch's float32), as in tests/test_torch_optim.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import fused as jfused
from analytics_zoo_tpu.parallel.trainer import ClipSpec as JClip
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.ops import fused as tfused
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.ops import multi_tensor as mt
from analytics_zoo_torch.parallel.trainer import ClipSpec as TClip
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt

ATOL = 1e-6
# the leaf sizes of the table tests: empty, the 2-element bias class, a
# ragged odd one, NeuralCF's largest leaf, BERT-base's embedding
TABLE_SIZES = (0, 1, 2, 3, 1001, 386_624, 23_440_896)
# NeuralCF's 12 leaves in the trainer's order, at a small width (users 30,
# items 20, embeddings 8, hidden 16/8/4, 2 classes)
NCF_SHAPES = ((31, 8), (21, 8), (31, 8), (21, 8), (16, 16), (16,), (16, 8),
              (8,), (8, 4), (4,), (12, 2), (2,))


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    yield
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _fake_addresses(sizes, nptr, offset):
    """Operand addresses of leaves laid out one after another, 256-byte
    aligned, each moved by ``offset`` bytes (4: a view one float in)."""
    out, base = [], 1 << 20
    for n in sizes:
        row = []
        for _ in range(nptr):
            row.append(base + offset)
            base += (4 * n + offset + 255) // 256 * 256 + 256
        out.append(row)
    return out


def _covered(tables, sizes):
    """{leaf: sorted (lo, hi)} over every chunk of every table."""
    ranges = {}
    for rows, idx in tables:
        for c in range(mt.table_chunks(rows)):
            row, lo, hi = mt.chunk_range(rows, c)
            assert 0 <= lo < hi <= sizes[idx[row]]
            ranges.setdefault(int(idx[row]), []).append((lo, hi))
    return {k: sorted(v) for k, v in ranges.items()}


@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset_by_one"])
@pytest.mark.parametrize("nptr", [4, 3], ids=["adam", "sgd"])
def test_leaf_table_covers_every_element_once(offset, nptr):
    addresses = _fake_addresses(TABLE_SIZES, nptr, offset)
    tables = mt.leaf_tables(addresses, TABLE_SIZES)
    assert len(tables) == 1
    rows, idx = tables[0]
    # the empty leaf has no row; every other leaf one, in order
    assert list(idx) == [i for i, n in enumerate(TABLE_SIZES) if n]
    assert rows.shape == (len(idx), nptr + 3) and rows.dtype == np.int64
    for row, i in zip(rows, idx):
        assert list(row[:nptr]) == addresses[i]
        assert row[nptr] == TABLE_SIZES[i]
        assert row[nptr + 2] == (offset == 0)
    assert mt.table_chunks(rows) == sum(-(-n // mt.CHUNK)
                                        for n in TABLE_SIZES)
    for i, spans in _covered(tables, TABLE_SIZES).items():
        # the chunks of a leaf tile [0, n): no gap, no overlap
        assert spans[0][0] == 0 and spans[-1][1] == TABLE_SIZES[i]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(hi - lo == mt.CHUNK for lo, hi in spans[:-1])


def test_leaf_table_aligned_flag_is_per_leaf():
    sizes = (8, 8, 8, 8)
    addresses = _fake_addresses(sizes, 3, 0)
    addresses[1][1] += 4          # leaf 1's gradient a float in
    addresses[2][2] += 8          # leaf 2's trace two floats in
    addresses[3][2] = 0           # leaf 3 without a trace: still aligned
    rows, _ = mt.leaf_tables(addresses, sizes)[0]
    assert list(rows[:, -1]) == [1, 0, 0, 1]


@pytest.mark.parametrize("budget", [1, 2, 5])
def test_small_budget_splits_the_table_with_nothing_lost_or_doubled(budget):
    addresses = _fake_addresses(TABLE_SIZES, 4, 0)
    tables = mt.leaf_tables(addresses, TABLE_SIZES, max_leaves=budget)
    nonempty = [i for i, n in enumerate(TABLE_SIZES) if n]
    assert len(tables) == -(-len(nonempty) // budget)
    assert [int(i) for _, idx in tables for i in idx] == nonempty
    for rows, _ in tables:
        assert 1 <= len(rows) <= budget and rows[0, -2] == 0
    whole = _covered(mt.leaf_tables(addresses, TABLE_SIZES), TABLE_SIZES)
    assert _covered(tables, TABLE_SIZES) == whole


def test_empty_leaf_set_is_one_empty_table():
    (rows, idx), = mt.leaf_tables(np.zeros((2, 4), np.int64), [0, 0])
    assert rows.shape == (0, 7) and len(idx) == 0
    assert mt.table_chunks(rows) == 0


def _leaves(sizes, offsets, seed):
    """float32 CPU leaves; a leaf with offset 1 is a view one float into a
    longer buffer (not 16-byte aligned)."""
    rs = np.random.RandomState(seed)
    out = []
    for n, off in zip(sizes, offsets):
        buf = torch.from_numpy(rs.randn(n + off).astype(np.float32))
        out.append(buf[off:])
    return out


WALK_SIZES = (1, 2, 3, 1001, 4096, 4097, 9000, 386)
WALK_OFFSETS = (0, 0, 1, 0, 1, 0, 0, 1)


def _walk(tables, columns, element_fn):
    """Apply ``element_fn`` to each chunk's slice of every operand, in the
    kernel's order of blocks."""
    for rows, idx in tables:
        for c in range(mt.table_chunks(rows)):
            row, lo, hi = mt.chunk_range(rows, c)
            leaf = int(idx[row])
            element_fn(*(None if col is None else col[leaf][lo:hi]
                         for col in columns))


@pytest.mark.parametrize("clip", [None, "scale", "const"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_chunk_walk_equals_per_leaf_plain_update(clip, weight_decay):
    ps, gs, ms = (_leaves(WALK_SIZES, WALK_OFFSETS, s) for s in range(3))
    vs = [v.abs() * 0.01 for v in _leaves(WALK_SIZES, WALK_OFFSETS, 3)]
    scal = tfused.step_scalars(0.5, -1e-3, 0.1, 1e-3)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              clip_const=(-0.5, 0.5) if clip == "const" else None,
              use_clip_scale=clip == "scale")
    walk = [[t.clone() for t in col] for col in (ps, gs, ms, vs)]
    tables = mt.leaf_tables(
        [[t.data_ptr() for t in leaf] for leaf in zip(*walk)],
        [t.numel() for t in ps], max_leaves=3)
    _walk(tables, walk, lambda p, g, m, v: tfused._adam_plain(
        p, g, m, v, scal, kw["b1"], kw["b2"], kw["eps"], weight_decay,
        kw["clip_const"], kw["use_clip_scale"]))
    for p, g, m, v, wp, wm, wv in zip(ps, gs, ms, vs, walk[0], walk[2],
                                      walk[3]):
        tfused.adam_leaf_update(p, g, m, v, scal, **kw)
        for a, b in ((p, wp), (m, wm), (v, wv)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("momentum,nesterov,weight_decay",
                         [(0.9, False, 0.0), (0.8, True, 1e-4),
                          (0.9, False, 1e-4), (0.0, False, 0.0)])
def test_sgd_chunk_walk_equals_per_leaf_plain_update(momentum, nesterov,
                                                     weight_decay):
    ps, gs, ts = (_leaves(WALK_SIZES, WALK_OFFSETS, s) for s in range(3))
    ts = ts if momentum else None
    scal = tfused.step_scalars(0.7, -0.05)
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
              clip_const=(-1.0, 1.0), use_clip_scale=True)
    walk = [None if col is None else [t.clone() for t in col]
            for col in (ps, gs, ts)]
    tables = mt.leaf_tables(
        [[p.data_ptr(), g.data_ptr(), t.data_ptr() if momentum else 0]
         for p, g, t in zip(walk[0], walk[1], walk[2] or walk[0])],
        [t.numel() for t in ps], max_leaves=3)
    _walk(tables, walk, lambda p, g, t: tfused._sgd_plain(
        p, g, t, scal, momentum, nesterov, weight_decay, kw["clip_const"],
        True))
    for i, (p, g) in enumerate(zip(ps, gs)):
        t = ts[i] if momentum else None
        tfused.sgd_leaf_update(p, g, t, scal, **kw)
        assert torch.equal(p, walk[0][i])
        if momentum:
            assert torch.equal(t, walk[2][i])


def test_leaf_set_fills_each_steps_gradients():
    ps = _leaves(WALK_SIZES, [0] * len(WALK_SIZES), 0)
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    cache = mt.TableCache(max_leaves=3)
    columns = [ps, None, ms, vs]
    leaf_set = cache.get(columns)
    assert cache.get(columns) is leaf_set            # kept while in place
    for offsets in ([0] * len(WALK_SIZES), WALK_OFFSETS):
        gs = _leaves(WALK_SIZES, offsets, 1)
        launches = leaf_set.fill(gs)
        assert len(launches) == 3
        for (rows, idx), (address, n) in zip(leaf_set.tables, launches):
            assert address == rows.ctypes.data and n == len(rows)
            for row, i in zip(rows, idx):
                assert row[mt.GRAD] == gs[i].data_ptr()
                assert row[-1] == (offsets[i] == 0)
    with pytest.raises(ValueError, match="gradient"):
        leaf_set.fill([g.double() for g in gs])
    with pytest.raises(ValueError, match="gradient"):
        leaf_set.fill(gs[:-1] + [torch.zeros(5)])
    # another leaf set (a moved moment) is a new table
    assert cache.get([ps, None, ms, [v.clone() for v in vs]]) is not leaf_set


def test_leaf_set_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        mt.LeafSet([[p], None, [torch.zeros(8, dtype=torch.float64)], [p]])
    with pytest.raises(ValueError, match="shape"):
        mt.LeafSet([[p], None, [torch.zeros(9)], [p]])
    with pytest.raises(ValueError, match="contiguous"):
        mt.LeafSet([[p], None, [torch.zeros(16)[::2]], [p]])


def test_adam_scalars_saturate_and_carry_a_nan_norm():
    top = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    count_inc, scal = tfused.adam_scalars(top, -1e-3, 0.9, 0.999,
                                          torch.tensor(float("nan")), 1.0)
    assert int(count_inc) == 2 ** 31 - 1
    assert torch.isnan(scal[0]) and float(scal[1]) == np.float32(-1e-3)
    _, scal = tfused.adam_scalars(torch.tensor(2, dtype=torch.int32), -1.0,
                                  0.9, 0.999, torch.tensor(0.25), 1.0)
    assert float(scal[0]) == 1.0
    assert abs(float(scal[2]) - (1 - 0.9 ** 3)) < 1e-6


def _both(name):
    """(JAX optimizer, port optimizer, JAX clip, port clip)."""
    cases = {
        "adam": (lambda m: m.Adam(lr=1e-3), None),
        "adam_const_clip": (lambda m: m.Adam(lr=1e-3),
                            ("const", -0.01, 0.01)),
        "adam_l2_clip": (lambda m: m.Adam(lr=1e-3), ("l2norm", 0.5)),
        "adam_schedule": (lambda m: m.Adam(lr=1e-3, decay=0.01), None),
        "sgd_momentum": (lambda m: m.SGD(0.1, momentum=0.9), None),
        "sgd_nesterov": (lambda m: m.SGD(0.05, momentum=0.8, nesterov=True),
                         ("l2norm", 1.0)),
        "sgd_weight_decay": (lambda m: m.SGD(0.05, momentum=0.9,
                                             weight_decay=1e-3), None),
        "sgd_none": (lambda m: m.SGD(0.1), ("const", -0.01, 0.01)),
    }
    make, clip = cases[name]
    return (make(jopt), make(topt), JClip(*clip) if clip else None,
            TClip(*clip) if clip else None)


def _state_leaves(state):
    """Port state leaves in jax's flattening order."""
    if isinstance(state, dict):
        return [l for k in sorted(state) for l in _state_leaves(state[k])]
    if isinstance(state, tuple):
        return [l for c in state for l in _state_leaves(c)]
    return [state]


@pytest.mark.parametrize("name", ["adam", "adam_const_clip", "adam_l2_clip",
                                  "adam_schedule", "sgd_momentum",
                                  "sgd_nesterov", "sgd_weight_decay",
                                  "sgd_none"])
def test_ncf_shaped_update_matches_reference_over_six_steps(name):
    joptim, toptim, jclip, tclip = _both(name)
    rs = np.random.RandomState(4)
    params = {f"l{i:02d}": rs.randn(*s).astype(np.float32) * 0.1
              for i, s in enumerate(NCF_SHAPES)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = joptim.tx.init(jp), toptim.init(tp)
    jstep = jfused.build_fused_update(joptim, jclip)
    tstep = tfused.build_fused_update(toptim, tclip)
    assert jstep is not None and tstep is not None
    for _ in range(6):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, js = jstep({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        with torch.no_grad():
            tp, ts = tstep({k: torch.from_numpy(v) for k, v in grads.items()},
                           ts, tp)
    for k in sorted(tp):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL, rtol=0)
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = _state_leaves(ts)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        if np.issubdtype(np.asarray(j).dtype, np.integer):
            assert t.dtype == torch.int32 and int(t) == int(j) == 6
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                       rtol=0)
    assert not any(kernels.launch_counts().values())
