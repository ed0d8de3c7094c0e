"""PyTorch port, ONNX import: every case of ``tests/test_onnx.py`` through
both packages' loaders on the same ``ModelProto`` bytes (the port takes
the reference's variables through ``load_jax_variables``; outputs within
1e-5), the wire codec's messages byte-identical in both packages, more
single ops against the reference (SAME pads, negative-step slices,
reflect/edge pads, the three resize methods, reductions, ...), an
unsupported op refused by both, and an imported conv net trained three
Adam steps in both (losses and params within 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.onnx import load as jload
from analytics_zoo_tpu.pipeline.api.onnx import onnx_pb as jpb
from analytics_zoo_tpu.utils import pbwire as jwire

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.topology import (tree_leaves,
                                                             tree_replace)
from analytics_zoo_torch.pipeline.api.onnx import load as tload
from analytics_zoo_torch.pipeline.api.onnx import onnx_pb as tpb
from analytics_zoo_torch.utils import pbwire as twire

FWD_TOL = 1e-5
STEP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    TLayer.reset_name_counters()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


# ------------------------------------------------------------- model bytes
def attr_i(pb, name, v):
    return pb.AttributeProto(name=name, i=int(v), type=pb.AttributeProto.INT)


def attr_f(pb, name, v):
    return pb.AttributeProto(name=name, f=float(v),
                             type=pb.AttributeProto.FLOAT)


def attr_ints(pb, name, vs):
    return pb.AttributeProto(name=name, ints=[int(v) for v in vs],
                             type=pb.AttributeProto.INTS)


def attr_floats(pb, name, vs):
    return pb.AttributeProto(name=name, floats=[float(v) for v in vs],
                             type=pb.AttributeProto.FLOATS)


def attr_s(pb, name, v):
    return pb.AttributeProto(name=name, s=v.encode(),
                             type=pb.AttributeProto.STRING)


def attr_t(pb, name, arr):
    return pb.AttributeProto(name=name, t=pb.ndarray_to_tensor(arr),
                             type=pb.AttributeProto.TENSOR)


ATTRS = {"i": attr_i, "f": attr_f, "ints": attr_ints, "floats": attr_floats,
         "s": attr_s, "t": attr_t}


def encode(pb, nodes, inputs, outputs, initializers=(), opset=11):
    """``nodes``: (op_type, inputs, outputs, [(kind, name, value)]) with
    the attributes built by ``ATTRS[kind]``; ``inputs``: (name, shape) or
    (name, shape, element type)."""
    g = pb.GraphProto(
        node=[pb.NodeProto(input=list(i), output=list(o), op_type=op,
                           attribute=[ATTRS[k](pb, n, v) for k, n, v in a])
              for op, i, o, a in nodes],
        name="g",
        initializer=[pb.ndarray_to_tensor(a, n) for n, a in initializers],
        input=[pb.make_value_info(*i) for i in inputs],
        output=[pb.make_value_info(n, s) for n, s in outputs])
    m = pb.ModelProto(ir_version=7, producer_name="zoo-tpu-test", graph=g,
                      opset_import=[pb.OperatorSetIdProto(domain="",
                                                          version=opset)])
    return m.encode()


def model_bytes(*args, **kwargs) -> bytes:
    """The model encoded by both packages' codecs: the bytes must agree."""
    data = encode(jpb, *args, **kwargs)
    assert encode(tpb, *args, **kwargs) == data
    return data


def both(data):
    """(JAX model, its numpy variables, port model with them loaded)."""
    jm = jload(data)
    jv = jax.tree_util.tree_map(np.asarray, jm.init())
    tm = tload(data)
    load_jax_variables(tm, jv)
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    return jm, jv, tm


def run_both(data, *xs, tol=FWD_TOL, training=False):
    jm, jv, tm = both(data)
    # device arrays, as the JAX engine hands them to the layers
    jxs = [jnp.asarray(x) for x in xs]
    jout, _ = jm.apply(jv["params"], jxs if len(jxs) > 1 else jxs[0],
                       state=jv["state"], training=training)
    tv = tm.get_variables()
    txs = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    tout, _ = tm.apply(tv["params"], txs if len(txs) > 1 else txs[0],
                       state=tv["state"], training=training)
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j = np.asarray(j)
        assert t.shape == j.shape and t.numpy().dtype == j.dtype, \
            (t.shape, j.shape, t.dtype, j.dtype)
        np.testing.assert_allclose(t.numpy(), j, rtol=tol, atol=tol)
    return touts[0].numpy() if len(touts) == 1 else [t.numpy()
                                                      for t in touts]


# ------------------------------------------------------------- wire codec
class TestWireCodec:
    def test_varint_bytes_agree(self):
        for v in [0, 1, 127, 128, 300, 2 ** 32, 2 ** 63 - 1, -1, -5]:
            buf = twire.write_varint(v)
            assert buf == jwire.write_varint(v)
            out, pos = twire.read_varint(buf, 0)
            assert pos == len(buf)
            assert out == (v if v >= 0 else v + 2 ** 64)

    def test_negative_int64(self):
        t = tpb.TensorProto(dims=[2], data_type=tpb.TensorProto.INT64,
                            int64_data=[-1, -5])
        assert t.encode() == jpb.TensorProto(
            dims=[2], data_type=jpb.TensorProto.INT64,
            int64_data=[-1, -5]).encode()
        back = tpb.TensorProto.decode(t.encode())
        assert list(back.int64_data) == [-1, -5]

    @pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64,
                                       np.int32, np.uint8, np.bool_,
                                       np.float64])
    def test_tensor_roundtrip(self, dtype):
        arr = (np.random.RandomState(0).randn(3, 4) * 10).astype(dtype)
        t = tpb.ndarray_to_tensor(arr, "w")
        assert t.encode() == jpb.ndarray_to_tensor(arr, "w").encode()
        back = tpb.tensor_to_ndarray(tpb.TensorProto.decode(t.encode()))
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == arr.dtype

    def test_tensor_payload_forms(self):
        """float_data, int64_data and fp16 bit patterns in int32_data
        decode as in the reference."""
        cases = [
            dict(dims=[3], data_type=1, float_data=[1.5, -2.0, 3.25]),
            dict(dims=[2], data_type=7, int64_data=[7, -9]),
            dict(dims=[2], data_type=10,
                 int32_data=[int(v) for v in np.asarray(
                     [1.5, -3.0], np.float16).view(np.uint16)]),
            dict(dims=[2], data_type=11, double_data=[0.1, 0.2]),
            dict(dims=[0], data_type=1),
        ]
        for kw in cases:
            data = jpb.TensorProto(**kw).encode()
            assert tpb.TensorProto(**kw).encode() == data
            got = tpb.tensor_to_ndarray(tpb.TensorProto.decode(data))
            want = jpb.tensor_to_ndarray(jpb.TensorProto.decode(data))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype

    def test_model_proto_roundtrip(self):
        data = model_bytes([("Relu", ["x"], ["y"], [])],
                           [("x", [0, 4])], [("y", [0, 4])])
        m = tpb.ModelProto.decode(data)
        assert m.graph.node[0].op_type == "Relu"
        assert m.opset_import[0].version == 11
        assert m.encode() == data
        assert m.graph.input[0].shape() == [None, 4]

    def test_attribute_values(self):
        node = tpb.NodeProto(op_type="X", attribute=[
            attr_i(tpb, "a", 3), attr_f(tpb, "b", 0.5),
            attr_ints(tpb, "c", [1, 2]), attr_s(tpb, "d", "same"),
            attr_floats(tpb, "e", [1.0, 2.0]),
            attr_t(tpb, "f", np.arange(3, dtype=np.float32))])
        back = tpb.NodeProto.decode(node.encode()).attrs()
        assert back["a"] == 3 and back["b"] == 0.5
        assert back["c"] == [1, 2] and back["d"] == "same"
        assert back["e"] == [1.0, 2.0]
        np.testing.assert_array_equal(back["f"], np.arange(3))


# ------------------------------------------------ the reference's op cases
class TestOps:
    def test_conv_bn_relu_pool_gemm(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 3, 16, 16).astype(np.float32)
        w = rng.randn(8, 3, 3, 3).astype(np.float32) * 0.1
        b = rng.randn(8).astype(np.float32)
        scale = rng.rand(8).astype(np.float32) + 0.5
        bias = rng.randn(8).astype(np.float32)
        mean = rng.randn(8).astype(np.float32)
        var = rng.rand(8).astype(np.float32) + 0.5
        fc_w = rng.randn(10, 8 * 8 * 8).astype(np.float32) * 0.1
        fc_b = rng.randn(10).astype(np.float32)
        nodes = [
            ("Conv", ["x", "w", "b"], ["c1"],
             [("ints", "kernel_shape", [3, 3]), ("ints", "pads", [1] * 4),
              ("ints", "strides", [1, 1])]),
            ("BatchNormalization", ["c1", "scale", "bias", "mean", "var"],
             ["bn"], [("f", "epsilon", 1e-5)]),
            ("Relu", ["bn"], ["r"], []),
            ("MaxPool", ["r"], ["p"], [("ints", "kernel_shape", [2, 2]),
                                       ("ints", "strides", [2, 2])]),
            ("Flatten", ["p"], ["f"], [("i", "axis", 1)]),
            ("Gemm", ["f", "fc_w", "fc_b"], ["y"], [("i", "transB", 1)]),
        ]
        data = model_bytes(nodes, [("x", [0, 3, 16, 16])], [("y", [0, 10])],
                           [("w", w), ("b", b), ("scale", scale),
                            ("bias", bias), ("mean", mean), ("var", var),
                            ("fc_w", fc_w), ("fc_b", fc_b)])
        got = run_both(data, x)
        tx = torch.from_numpy(x)
        t = torch.nn.functional.conv2d(tx, torch.from_numpy(w),
                                       torch.from_numpy(b), padding=1)
        t = torch.nn.functional.batch_norm(
            t, torch.from_numpy(mean), torch.from_numpy(var),
            torch.from_numpy(scale), torch.from_numpy(bias),
            training=False, eps=1e-5)
        t = torch.nn.functional.max_pool2d(torch.relu(t), 2).flatten(1)
        t = torch.nn.functional.linear(t, torch.from_numpy(fc_w),
                                       torch.from_numpy(fc_b))
        np.testing.assert_allclose(got, t.numpy(), rtol=1e-4, atol=1e-4)

    def test_conv_transpose(self):
        rng = np.random.RandomState(1)
        x = rng.randn(2, 4, 7, 7).astype(np.float32)
        w = rng.randn(4, 6, 3, 3).astype(np.float32) * 0.2
        data = model_bytes(
            [("ConvTranspose", ["x", "w"], ["y"],
              [("ints", "kernel_shape", [3, 3]), ("ints", "strides", [2, 2]),
               ("ints", "pads", [1, 1, 1, 1]),
               ("ints", "output_padding", [1, 1])])],
            [("x", [0, 4, 7, 7])], [("y", [0, 6, 14, 14])], [("w", w)])
        got = run_both(data, x)
        t = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=1,
            output_padding=1)
        np.testing.assert_allclose(got, t.numpy(), rtol=1e-4, atol=1e-4)

    def test_avgpool_pads_excluded(self):
        x = np.random.RandomState(2).randn(1, 2, 6, 6).astype(np.float32)
        data = model_bytes(
            [("AveragePool", ["x"], ["y"],
              [("ints", "kernel_shape", [3, 3]), ("ints", "strides", [2, 2]),
               ("ints", "pads", [1, 1, 1, 1])])],
            [("x", [0, 2, 6, 6])], [("y", [0, 2, 3, 3])])
        got = run_both(data, x)
        t = torch.nn.functional.avg_pool2d(torch.from_numpy(x), 3, stride=2,
                                           padding=1,
                                           count_include_pad=False)
        np.testing.assert_allclose(got, t.numpy(), rtol=1e-5, atol=1e-5)

    def test_elementwise_and_broadcast(self):
        rng = np.random.RandomState(3)
        x = rng.randn(4, 5).astype(np.float32)
        c = rng.randn(5).astype(np.float32)
        data = model_bytes(
            [("Add", ["x", "c"], ["a"], []), ("Sigmoid", ["a"], ["s"], []),
             ("Exp", ["s"], ["e"], []), ("Mul", ["e", "e"], ["m"], []),
             ("Sqrt", ["m"], ["y"], [])],
            [("x", [0, 5])], [("y", [0, 5])], [("c", c)])
        got = run_both(data, x)
        np.testing.assert_allclose(got, np.exp(1 / (1 + np.exp(-(x + c)))),
                                   rtol=1e-5, atol=1e-5)

    def test_softmax_pre13_flattens(self):
        x = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)
        data = model_bytes([("Softmax", ["x"], ["y"], [("i", "axis", 1)])],
                           [("x", [0, 3, 4])], [("y", [0, 3, 4])])
        got = run_both(data, x)
        flat = x.reshape(2, 12)
        e = np.exp(flat - flat.max(-1, keepdims=True))
        np.testing.assert_allclose(got, (e / e.sum(-1, keepdims=True))
                                   .reshape(2, 3, 4), rtol=1e-5, atol=1e-5)

    def test_shape_ops_chain(self):
        x = np.random.RandomState(5).randn(2, 3, 4).astype(np.float32)
        data = model_bytes(
            [("Transpose", ["x"], ["t"], [("ints", "perm", [0, 2, 1])]),
             ("Reshape", ["t", "shape"], ["rs"], []),
             ("Unsqueeze", ["rs"], ["u"], [("ints", "axes", [1])]),
             ("Squeeze", ["u"], ["y"], [("ints", "axes", [1])])],
            [("x", [0, 3, 4])], [("y", [0, 12])],
            [("shape", np.asarray([2, 12], dtype=np.int64))])
        got = run_both(data, x)
        np.testing.assert_allclose(got, x.transpose(0, 2, 1).reshape(2, 12))

    def test_concat_split_slice(self):
        x = np.random.RandomState(6).randn(2, 6).astype(np.float32)
        data = model_bytes(
            [("Split", ["x"], ["a", "b"], [("i", "axis", 1),
                                           ("ints", "split", [2, 4])]),
             ("Concat", ["b", "a"], ["c"], [("i", "axis", 1)]),
             ("Slice", ["c"], ["y"], [("ints", "starts", [1]),
                                      ("ints", "ends", [5]),
                                      ("ints", "axes", [1])])],
            [("x", [0, 6])], [("y", [0, 4])])
        got = run_both(data, x)
        np.testing.assert_allclose(
            got, np.concatenate([x[:, 2:], x[:, :2]], axis=1)[:, 1:5])

    def test_gather_embedding(self):
        table = np.random.RandomState(7).randn(10, 4).astype(np.float32)
        idx = np.asarray([[1, 3, 5]], dtype=np.int32)
        data = model_bytes(
            [("Gather", ["table", "idx"], ["y"], [("i", "axis", 0)])],
            [("idx", [0, 3], tpb.TensorProto.INT64)], [("y", [0, 3, 4])],
            [("table", table)])
        got = run_both(data, idx)
        np.testing.assert_allclose(got, table[idx[0]][None], rtol=1e-6)

    def test_reduce_and_global_pool(self):
        x = np.random.RandomState(8).randn(2, 3, 5, 5).astype(np.float32)
        data = model_bytes(
            [("GlobalAveragePool", ["x"], ["g"], []),
             ("ReduceSum", ["g"], ["y"], [("ints", "axes", [1]),
                                          ("i", "keepdims", 0)])],
            [("x", [0, 3, 5, 5])], [("y", [0, 1, 1])])
        got = run_both(data, x)
        np.testing.assert_allclose(got, x.mean(axis=(2, 3), keepdims=True)
                                   .sum(axis=1), rtol=1e-5, atol=1e-6)

    def test_lrn_matches_torch(self):
        x = np.random.RandomState(9).randn(2, 8, 4, 4).astype(np.float32)
        data = model_bytes(
            [("LRN", ["x"], ["y"], [("i", "size", 5), ("f", "alpha", 1e-4),
                                    ("f", "beta", 0.75),
                                    ("f", "bias", 1.0)])],
            [("x", [0, 8, 4, 4])], [("y", [0, 8, 4, 4])])
        got = run_both(data, x)
        t = torch.nn.functional.local_response_norm(
            torch.from_numpy(x), 5, alpha=1e-4, beta=0.75, k=1.0)
        np.testing.assert_allclose(got, t.numpy(), rtol=1e-4, atol=1e-5)

    def test_constant_folding(self):
        x = np.random.RandomState(10).randn(2, 3).astype(np.float32)
        cval = np.asarray([[1.0, 2.0, 3.0]], dtype=np.float32)
        data = model_bytes(
            [("Constant", [], ["c"], [("t", "value", cval)]),
             ("Add", ["c", "c"], ["c2"], []),
             ("Mul", ["x", "c2"], ["y"], [])],
            [("x", [0, 3])], [("y", [0, 3])])
        got = run_both(data, x)
        np.testing.assert_allclose(got, x * (2 * cval), rtol=1e-6)

    def test_resize_nearest(self):
        x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
        data = model_bytes(
            [("Upsample", ["x"], ["y"], [("s", "mode", "nearest"),
                                         ("floats", "scales",
                                          [1.0, 1.0, 2.0, 2.0])])],
            [("x", [0, 1, 4, 4])], [("y", [0, 1, 8, 8])])
        got = run_both(data, x)
        np.testing.assert_allclose(got, x.repeat(2, axis=2).repeat(2, axis=3))

    def test_imported_model_is_trainable(self):
        rng = np.random.RandomState(11)
        w = rng.randn(4, 3).astype(np.float32) * 0.3
        data = model_bytes([("Gemm", ["x", "w"], ["y"], [("i", "transB", 1)])],
                           [("x", [0, 3])], [("y", [0, 4])], [("w", w)])
        x = rng.randn(2, 3).astype(np.float32)
        jm, jv, tm = both(data)

        def jloss(params):
            out, _ = jm.apply(params, x, state={})
            return (out ** 2).sum()
        jgrads = jax.tree_util.tree_leaves(jax.grad(jloss)(jv["params"]))
        params = tm.get_variables()["params"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        out, _ = tm.apply(tree_replace(params, leaves), torch.from_numpy(x),
                          state={})
        grads = torch.autograd.grad((out ** 2).sum(), leaves)
        assert len(grads) == len(jgrads) == 1
        assert all(float(g.abs().sum()) > 0 for g in grads)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrads[0]),
                                   rtol=1e-5, atol=1e-5)

    def test_maxpool_ceil_mode(self):
        x = np.random.RandomState(12).randn(1, 2, 7, 7).astype(np.float32)
        data = model_bytes(
            [("MaxPool", ["x"], ["y"], [("ints", "kernel_shape", [3, 3]),
                                        ("ints", "strides", [2, 2]),
                                        ("i", "ceil_mode", 1)])],
            [("x", [0, 2, 7, 7])], [("y", [0, 2, 4, 4])])
        got = run_both(data, x)
        t = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, stride=2,
                                           ceil_mode=True)
        np.testing.assert_allclose(got, t.numpy(), rtol=1e-6)

    def test_constant_reshape_and_sum_fold(self):
        rng = np.random.RandomState(13)
        x = rng.randn(2, 6).astype(np.float32)
        w = rng.randn(3, 2).astype(np.float32)
        data = model_bytes(
            [("Reshape", ["w", "shape"], ["wr"], []),
             ("Sum", ["wr", "wr"], ["w2"], []),
             ("MatMul", ["x", "w2"], ["y"], [])],
            [("x", [0, 6])], [("y", [0, 1])],
            [("w", w), ("shape", np.asarray([6, 1], dtype=np.int64))])
        got = run_both(data, x)
        np.testing.assert_allclose(got, x @ (2 * w.reshape(6, 1)),
                                   rtol=1e-5, atol=1e-6)

    def test_unsupported_op_raises_in_both(self):
        data = model_bytes([("NoSuchOp", ["x"], ["y"], [])],
                           [("x", [0, 3])], [("y", [0, 3])])
        with pytest.raises(NotImplementedError, match="NoSuchOp") as jerr:
            jload(data)
        with pytest.raises(NotImplementedError, match="NoSuchOp") as terr:
            tload(data)
        assert str(terr.value) == str(jerr.value)


# ------------------------------------------------- more single-node cases
R = np.random.RandomState(21)
X4 = R.randn(2, 3, 7, 6).astype(np.float32)
X2 = R.randn(4, 6).astype(np.float32)
W4 = (R.randn(5, 3, 3, 2) * 0.2).astype(np.float32)

SINGLE = {
    "conv_same_upper": (("Conv", ["x", "w"], ["y"],
                         [("s", "auto_pad", "SAME_UPPER"),
                          ("ints", "strides", [2, 2])]),
                        X4, [("w", W4)]),
    "conv_same_lower_dilated": (("Conv", ["x", "w"], ["y"],
                                 [("s", "auto_pad", "SAME_LOWER"),
                                  ("ints", "dilations", [2, 1])]),
                                X4, [("w", W4)]),
    "conv_asymmetric_pads_grouped": (
        ("Conv", ["x", "w"], ["y"], [("ints", "pads", [0, 1, 2, 0]),
                                     ("i", "group", 3)]),
        X4, [("w", (R.randn(6, 1, 3, 3) * 0.2).astype(np.float32))]),
    "conv_transpose_asymmetric": (
        ("ConvTranspose", ["x", "w"], ["y"],
         [("ints", "strides", [2, 1]), ("ints", "pads", [1, 0, 0, 1])]),
        X4, [("w", (R.randn(3, 4, 3, 2) * 0.2).astype(np.float32))]),
    "maxpool_same_upper": (("MaxPool", ["x"], ["y"],
                            [("ints", "kernel_shape", [3, 2]),
                             ("ints", "strides", [2, 2]),
                             ("s", "auto_pad", "SAME_UPPER")]), X4, []),
    "avgpool_include_pad_ceil": (("AveragePool", ["x"], ["y"],
                                  [("ints", "kernel_shape", [3, 3]),
                                   ("ints", "strides", [2, 2]),
                                   ("ints", "pads", [1, 1, 1, 1]),
                                   ("i", "count_include_pad", 1),
                                   ("i", "ceil_mode", 1)]), X4, []),
    "avgpool_include_pad": (("AveragePool", ["x"], ["y"],
                             [("ints", "kernel_shape", [2, 2]),
                              ("ints", "pads", [1, 0, 1, 0]),
                              ("i", "count_include_pad", 1)]), X4, []),
    "global_max_pool": (("GlobalMaxPool", ["x"], ["y"], []), X4, []),
    "instance_norm": (("InstanceNormalization", ["x", "s", "b"], ["y"],
                       [("f", "epsilon", 1e-3)]), X4,
                      [("s", R.rand(3).astype(np.float32) + 0.5),
                       ("b", R.randn(3).astype(np.float32))]),
    "prelu": (("PRelu", ["x", "slope"], ["y"], []), X4,
              [("slope", R.rand(3).astype(np.float32))]),
    "leaky_relu": (("LeakyRelu", ["x"], ["y"], [("f", "alpha", 0.2)]),
                   X2, []),
    "elu": (("Elu", ["x"], ["y"], [("f", "alpha", 0.7)]), X2, []),
    "selu": (("Selu", ["x"], ["y"], []), X2, []),
    "clip": (("Clip", ["x"], ["y"], [("f", "min", -0.5),
                                     ("f", "max", 0.4)]), X2, []),
    "hard_sigmoid": (("HardSigmoid", ["x"], ["y"], []), X2, []),
    "softplus_softsign": (("Softplus", ["x"], ["y"], []), X2 * 30, []),
    "erf": (("Erf", ["x"], ["y"], []), X2, []),
    "sign_abs_floor": (("Floor", ["x"], ["y"], []), X2 * 3, []),
    "pow_const": (("Pow", ["x", "p"], ["y"], []), np.abs(X2) + 0.1,
                  [("p", np.asarray(1.7, np.float32))]),
    "div_broadcast": (("Div", ["c", "x"], ["y"], []), X2 + 3.0,
                      [("c", R.randn(1, 6).astype(np.float32))]),
    "min_max_mean": (("Mean", ["x", "c", "x"], ["y"], []), X2,
                     [("c", R.randn(6).astype(np.float32))]),
    "max": (("Max", ["x", "c"], ["y"], []), X2,
            [("c", R.randn(6).astype(np.float32))]),
    "log_softmax_opset13": (("LogSoftmax", ["x"], ["y"], []), X4, []),
    "softmax_axis_neg": (("Softmax", ["x"], ["y"], [("i", "axis", -2)]),
                         X4, []),
    "flatten_axis2": (("Flatten", ["x"], ["y"], [("i", "axis", 2)]),
                      X4, []),
    "transpose_default": (("Transpose", ["x"], ["y"], []), X4, []),
    "slice_negative_step": (("Slice", ["x", "st", "en", "ax", "sp"], ["y"],
                             []), X4,
                            [("st", np.asarray([-1, 5], np.int64)),
                             ("en", np.asarray([-8, 0], np.int64)),
                             ("ax", np.asarray([3, 2], np.int64)),
                             ("sp", np.asarray([-2, -1], np.int64))]),
    "split_equal": (("Split", ["x"], ["y", "z"], [("i", "axis", 1)]),
                    X2, []),
    "gather_graph_input": (("Gather", ["x", "i"], ["y"],
                            [("i", "axis", 1)]), X2,
                           [("i", np.asarray([[5, -1], [0, 2]], np.int64))]),
    "pad_reflect": (("Pad", ["x"], ["y"],
                     [("s", "mode", "reflect"),
                      ("ints", "pads", [0, 0, 2, 1, 0, 0, 1, 2])]), X4, []),
    "pad_edge": (("Pad", ["x"], ["y"],
                  [("s", "mode", "edge"),
                   ("ints", "pads", [0, 0, 1, 0, 0, 0, 0, 3])]), X4, []),
    "pad_constant": (("Pad", ["x"], ["y"],
                      [("ints", "pads", [0, 1, 1, 0, 1, 0, 0, 2]),
                       ("f", "value", 1.5)]), X4, []),
    "reduce_mean_all": (("ReduceMean", ["x"], ["y"], []), X4, []),
    "reduce_max": (("ReduceMax", ["x"], ["y"], [("ints", "axes", [1, -1]),
                                                ("i", "keepdims", 0)]),
                   X4, []),
    "reduce_min": (("ReduceMin", ["x"], ["y"], [("ints", "axes", [2])]),
                   X4, []),
    "reduce_prod": (("ReduceProd", ["x"], ["y"], [("ints", "axes", [1, 3])]),
                    X4 * 0.5 + 1.0, []),
    "argmax": (("ArgMax", ["x"], ["y"], [("i", "axis", 1)]), X2, []),
    "argmin": (("ArgMin", ["x"], ["y"], [("i", "axis", 0),
                                         ("i", "keepdims", 0)]), X2, []),
    "resize_linear": (("Resize", ["x", "roi", "sc"], ["y"],
                       [("s", "mode", "linear")]), X4,
                      [("roi", np.zeros(0, np.float32)),
                       ("sc", np.asarray([1, 1, 2.0, 1.5], np.float32))]),
    "resize_linear_down": (("Resize", ["x", "roi", "sc", "sz"], ["y"],
                            [("s", "mode", "linear")]), X4,
                           [("roi", np.zeros(0, np.float32)),
                            ("sc", np.zeros(0, np.float32)),
                            ("sz", np.asarray([2, 3, 3, 4], np.int64))]),
    "resize_cubic": (("Resize", ["x", "roi", "sc"], ["y"],
                      [("s", "mode", "cubic")]), X4,
                     [("roi", np.zeros(0, np.float32)),
                      ("sc", np.asarray([1, 1, 1.5, 2.0], np.float32))]),
    "resize_nearest_odd": (("Resize", ["x", "roi", "sc", "sz"], ["y"],
                            [("s", "mode", "nearest")]), X4,
                           [("roi", np.zeros(0, np.float32)),
                            ("sc", np.zeros(0, np.float32)),
                            ("sz", np.asarray([2, 3, 10, 4], np.int64))]),
    "expand": (("Expand", ["x", "s"], ["y"], []), X2[:, :1],
               [("s", np.asarray([1, 5], np.int64))]),
    "where": (("Where", ["c", "x", "z"], ["y"], []), X2,
              [("c", R.rand(1, 6) > 0.5), ("z", R.randn(6).astype(
                  np.float32))]),
    "cast_to_int": (("Cast", ["x"], ["y"], [("i", "to", 7)]), X2 * 4, []),
    "matmul_const_left": (("MatMul", ["w", "x"], ["y"], []),
                          X4[:, 0, :4, :],
                          [("w", R.randn(3, 4).astype(np.float32))]),
    "gemm_alpha_beta": (("Gemm", ["x", "b", "c"], ["y"],
                         [("f", "alpha", 0.5), ("f", "beta", 2.0)]), X2,
                        [("b", R.randn(6, 3).astype(np.float32)),
                         ("c", R.randn(3).astype(np.float32))]),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_op_matches_the_reference(case):
    node, x, inits = SINGLE[case]
    out_names = node[2]
    opset = 13 if case == "log_softmax_opset13" else 11
    shape = [0] + list(x.shape[1:])
    data = model_bytes([node], [("x", shape)],
                       [(n, [0]) for n in out_names], inits, opset=opset)
    run_both(data, x)


def test_dropout_is_identity_in_eval_and_drops_in_training():
    x = X2
    data = model_bytes([("Dropout", ["x"], ["y"], [("f", "ratio", 0.5)])],
                       [("x", [0, 6])], [("y", [0, 6])])
    run_both(data, x)
    tm = tload(data)
    tv = tm.init()
    out, _ = tm.apply(tv["params"], torch.from_numpy(x), state={},
                      training=True, rng=torch.Generator().manual_seed(0))
    kept = out.numpy() != 0
    assert 0 < kept.mean() < 1
    np.testing.assert_allclose(out.numpy()[kept], (x * 2)[kept], rtol=1e-6)


def test_int64_weights_are_stored_int32_as_the_reference():
    """A 64-bit initializer is a 32-bit param in both packages (JAX
    without x64)."""
    data = model_bytes(
        [("Add", ["x", "c"], ["y"], [])], [("x", [0, 3])], [("y", [0, 3])],
        [("c", np.asarray([1.0, 2.0, 3.0], np.float64))])
    jm, jv, tm = both(data)
    assert jv["params"]["add_y"]["c1"].dtype == np.float32
    assert tm.get_variables()["params"]["add_y"]["c1"].dtype == \
        torch.float32


def test_net_load_onnx_and_inference_model():
    """``Net.load_onnx`` on a file path, then ``InferenceModel.load_zoo``."""
    import tempfile

    from analytics_zoo_torch.pipeline.api.net import Net
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    rng = np.random.RandomState(14)
    w = (rng.randn(4, 3, 3, 3) * 0.2).astype(np.float32)
    data = model_bytes(
        [("Conv", ["x", "w"], ["c"], [("ints", "pads", [1, 1, 1, 1])]),
         ("Relu", ["c"], ["r"], []),
         ("GlobalAveragePool", ["r"], ["g"], []),
         ("Flatten", ["g"], ["y"], [])],
        [("x", [0, 3, 8, 8])], [("y", [0, 4])], [("w", w)])
    with tempfile.NamedTemporaryFile(suffix=".onnx") as f:
        f.write(data)
        f.flush()
        model = Net.load_onnx(f.name)
    x = rng.randn(5, 3, 8, 8).astype(np.float32)
    got = InferenceModel().load_zoo(model).predict(x, batch_size=2)
    want = run_both(data, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_imported_conv_net_trains_three_adam_steps_in_both():
    rng = np.random.RandomState(15)
    w = (rng.randn(4, 2, 3, 3) * 0.3).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    fc = (rng.randn(3, 4 * 3 * 3) * 0.2).astype(np.float32)
    data = model_bytes(
        [("Conv", ["x", "w", "b"], ["c"], [("ints", "strides", [2, 2]),
                                           ("ints", "pads", [1, 1, 1, 1])]),
         ("Relu", ["c"], ["r"], []),
         ("Flatten", ["r"], ["f"], []),
         ("Gemm", ["f", "fc"], ["y"], [("i", "transB", 1)])],
        [("x", [0, 2, 6, 6])], [("y", [0, 3])],
        [("w", w), ("b", b), ("fc", fc)])
    x = rng.randn(8, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.int32)
    jm, jv, tm = both(data)
    loss = "sparse_categorical_crossentropy_with_logits"
    jm.compile(jopt.Adam(lr=1e-2), loss)
    tm.compile(topt.Adam(lr=1e-2), loss)
    jh = jm.fit(x, y, batch_size=8, nb_epoch=3)
    th = tm.fit(x, y.astype(np.int64), batch_size=8, nb_epoch=3)
    jl = [h["loss"] for h in jh]
    tl = [h["loss"] for h in th]
    np.testing.assert_allclose(tl, jl, atol=STEP_ATOL, rtol=0)
    assert tl[-1] < tl[0]
    jp = jax.tree_util.tree_map(np.asarray, jm.get_variables()["params"])
    tp = tm.get_variables()["params"]
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_allclose(tp[layer][name].numpy(),
                                       jp[layer][name], atol=STEP_ATOL,
                                       rtol=0)
