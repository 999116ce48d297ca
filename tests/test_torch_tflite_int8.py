"""Port parity: the calibrated full-integer TFLite export
(``export_tflite(quantize="int8")``, utils/tflite_int8.py) against the JAX
package's converter mode.

The decoder of tests/test_torch_tflite.py (hidden 32, 1 layer, every
parameter perturbed) is exported at (1, 20, 10) with and without the
depthwise pre-net, on both sides, calibrated on the same numpy batches
(``synthetic_representative_batches``); a port-only case repeats the
artifact checks at configs/flagship.json, (1, 200, 100).

- (a) every int8 weight of a FULLY_CONNECTED, CONV_2D or DEPTHWISE_CONV_2D
  in JAX's artifact has its codes and per-channel scales in the port's,
  bit for bit (the converter's static pass rounds as its dynamic one);
- (b) the QUANTIZE of ``x_t`` has JAX's scale and zero point exactly;
- (c) the FULLY_CONNECTED outputs that hold their own calibrated range on
  both sides have JAX's scale within rtol 1e-4 and zero point within 1.
  Two kinds hold another range, by design, and are counted apart: JAX's
  converter widens an output whose one consumer is an ADD to the ADD's
  range too, and the port quantizes what feeds BATCH_MATMUL's right side
  with zero point 0 (TFLite's int8 kernel drops that side's offset);
- (d) a stock ``tf.lite.Interpreter`` runs the port's artifact, and its
  output is within one output quantum (mean) of a plain PyTorch
  simulation: the same program run node by node with quantize-dequantize
  at each tensor the artifact quantizes, at the artifact's own parameters,
  through the export's node map;
- (e) against the float artifact, mean |diff| <= 0.1 * mean |float|;
- (f) calibration that makes a multiplier unrepresentable raises naming
  the op, and writes nothing;
- (g) JAX's artifact aborts the interpreter at the first ADD of its GELU
  expansion whose requantization the port's check refuses (invoked in a
  forked child: the abort would take the test worker with it);
- the reader and writer take JAX's artifact back whole, and the CLI's
  ``--quantize int8`` writes ``export_tflite``'s bytes.

JAX's int8 artifact is never invoked in the test's own process.  TensorFlow is
needed to build JAX's artifacts and to run the interpreter.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu_torch import cli
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.utils import tflite_int8 as ti
from edge_diffusion_tts_tpu_torch.utils import tflite_surgery as ts
from edge_diffusion_tts_tpu_torch.utils.export import (
    export_tflite, synthetic_representative_batches,
)
from edge_diffusion_tts_tpu_torch.weights import save_checkpoint
from test_torch_tflite import ROOT, SHAPE, SMALL, FLAGSHIP_SHAPE, _inputs, _jax, _models, _run

tf = pytest.importorskip("tensorflow")

aten = torch.ops.aten
WEIGHTED = ("FULLY_CONNECTED", "CONV_2D", "DEPTHWISE_CONV_2D")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_int8(cfg, dec, shape):
    """The port's int8 model (as bytes), its node map and program."""
    batches = synthetic_representative_batches(cfg, *shape)
    model, node_map, program = ti.lower_decoder_int8(cfg, dec, *shape, batches)
    return ts.write_model(model), node_map, program


def _float_artifact(cfg, dec, path, shape):
    export_tflite(cfg, dec, str(path), *shape)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tflite_int8")
    out = {}
    for dw in (True, False):
        jcfg, jdec, params, cfg, pdec = _models(JCFG(**SMALL, use_depthwise=dw))
        blob, node_map, program = _port_int8(cfg, pdec, SHAPE)
        out[dw] = dict(cfg=cfg, pdec=pdec, port=blob, node_map=node_map, program=program,
                       float=_float_artifact(cfg, pdec, tmp / f"float_{dw}.tflite", SHAPE),
                       jax=_jax(jcfg, jdec, params, tmp / f"jax_{dw}.tflite", SHAPE, "int8"),
                       path=str(tmp / f"jax_{dw}.tflite"))
    return out


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        cfg = PCFG.from_json(f.read())
    cfg.dropout = 0.0
    torch.manual_seed(5)
    dec = PDecoder(cfg).eval()
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn_like(p))
    blob, node_map, program = _port_int8(cfg, dec, FLAGSHIP_SHAPE)
    tmp = tmp_path_factory.mktemp("tflite_int8_flagship")
    return dict(cfg=cfg, pdec=dec, port=blob, node_map=node_map, program=program,
                float=_float_artifact(cfg, dec, tmp / "float.tflite", FLAGSHIP_SHAPE))


def _case(request, name):
    if name == "flagship":
        return request.getfixturevalue("flagship"), FLAGSHIP_SHAPE
    return request.getfixturevalue("tiny")[name == "depthwise"], SHAPE


def _ops(blob):
    """(op name, op, tensors) of each operator of an artifact."""
    model = ts.read_model(blob)
    sg = model.subgraphs[0]
    return model, [(ts.OP_NAME.get(ts.opcode_of(model, op)), op) for op in sg.operators]


def _weighted(blob):
    """Each int8-weighted op: (name, weight codes, weight tensor, output
    tensor, output index)."""
    model, ops = _ops(blob)
    sg = model.subgraphs[0]
    out = []
    for name, op in ops:
        w = sg.tensors[op.inputs[1]] if name in WEIGHTED else None
        if w is not None and w.type == ts.INT8:
            out.append((name, ts.constant(model, w), w, sg.tensors[op.outputs[0]],
                        int(op.outputs[0])))
    return out


def _twin(row, port_rows):
    """The port's op whose weight has ``row``'s codes."""
    q = row[1]
    for other in port_rows:
        if other[1].shape == q.shape and np.array_equal(other[1], q):
            return other
    return None


# ---- (a), (b), (c): held against JAX's artifact ----------------------------------------


def _as_state_dict(name, q):
    """An artifact's weight codes in the layout of the decoder's weight,
    [out, in * K]."""
    if name == "CONV_2D":  # [out, K, 1, in] of a [out, in, K] filter
        return q[:, :, 0, :].transpose(0, 2, 1).reshape(q.shape[0], -1)
    if name == "DEPTHWISE_CONV_2D":  # [1, K, 1, C] of a [C, 1, K] filter
        return np.ascontiguousarray(q[0, :, 0, :].T)
    return q


@pytest.mark.parametrize("dw", [True, False], ids=["depthwise", "no_depthwise"])
def test_weight_codes_and_scales_equal_jax(tiny, dw):
    m = tiny[dw]
    sd = m["pdec"].state_dict()
    theirs, ours = _weighted(m["jax"]), _weighted(m["port"])
    layers = {f"{n}.weight" for n, mod in m["pdec"].named_modules()
              if isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d)) and n != "sem_proj"}
    assert {row[2].name for row in ours} == layers
    assert len(theirs) == len(ours)
    for row in theirs:
        twin = _twin(row, ours)
        assert twin is not None, f"no port weight with the codes of {row[2].name}"
        assert row[0] == twin[0]
        jq, pq = row[2].quantization, twin[2].quantization
        assert jq.scale.tobytes() == pq.scale.tobytes(), twin[2].name
        assert jq.quantized_dimension == pq.quantized_dimension
        assert np.all(pq.zero_point == 0)
        # The codes are symmetric_per_channel of the decoder's weight.
        w = sd[twin[2].name].numpy()
        q, scale = ts.symmetric_per_channel(w.reshape(w.shape[0], -1))
        assert np.array_equal(_as_state_dict(twin[0], twin[1]), q), twin[2].name
        assert scale.tobytes() == pq.scale.tobytes()


@pytest.mark.parametrize("dw", [True, False], ids=["depthwise", "no_depthwise"])
def test_x_t_quantization_equals_jax(tiny, dw):
    def x_t_params(blob):
        model, ops = _ops(blob)
        sg = model.subgraphs[0]
        (op,) = [op for name, op in ops if name == "QUANTIZE"
                 and sg.tensors[op.inputs[0]].name == "x_t"]
        q = sg.tensors[op.outputs[0]].quantization
        return q.scale.tobytes(), q.zero_point.tolist()

    assert x_t_params(tiny[dw]["port"]) == x_t_params(tiny[dw]["jax"])


def _feeding_one_add(blob):
    """Tensors whose one consumer is an ADD: JAX's converter widens such an
    output to hold the ADD's range too."""
    _, ops = _ops(blob)
    users = {}
    for name, op in ops:
        for i in op.inputs:
            users.setdefault(int(i), []).append(name)
    return {i for i, names in users.items() if names == ["ADD"]}


def _matmul_right_sides(blob):
    """The port's tensors that reach BATCH_MATMUL's right side through ops
    that share parameters."""
    model, ops = _ops(blob)
    sg = model.subgraphs[0]
    producer = {int(op.outputs[0]): (name, op) for name, op in ops}
    todo = [int(op.inputs[1]) for name, op in ops if name == "BATCH_MATMUL"]
    seen = set()
    while todo:
        i = todo.pop()
        seen.add(i)
        name, op = producer.get(i, (None, None))
        if name in ("RESHAPE", "TRANSPOSE", "SLICE"):
            todo.append(int(op.inputs[0]))
    return seen


@pytest.mark.parametrize("dw", [True, False], ids=["depthwise", "no_depthwise"])
def test_fully_connected_output_ranges_match_jax(tiny, dw):
    m = tiny[dw]
    jshared = _feeding_one_add(m["jax"])
    psym = _matmul_right_sides(m["port"])
    ours = _weighted(m["port"])
    matched, apart = [], []
    for row in _weighted(m["jax"]):
        twin = _twin(row, ours)
        if row[0] != "FULLY_CONNECTED":
            continue
        jo, po = row[3], twin[3]
        if row[4] in jshared or twin[4] in psym:
            apart.append(twin[2].name)
            continue
        js, ps = float(jo.quantization.scale[0]), float(po.quantization.scale[0])
        assert abs(ps - js) <= 1e-4 * js, (twin[2].name, js, ps)
        assert abs(int(po.quantization.zero_point[0]) - int(jo.quantization.zero_point[0])) <= 1
        matched.append(twin[2].name)
    n_fc = sum(1 for r in _weighted(m["jax"]) if r[0] == "FULLY_CONNECTED")
    print(f"{len(matched)} of {n_fc} FULLY_CONNECTED outputs matched JAX's; held apart: {apart}")
    # Every Linear is matched or held apart for one of the two reasons: the
    # outputs feeding one ADD (the time MLP's second Linear, the residual
    # projections, in_proj without the pre-net) and the right sides (qkv,
    # kv_up).
    assert len(matched) + len(apart) == n_fc == 14
    assert len(matched) >= 7


# ---- (d), (e): the artifact runs, and computes what its parameters say ----------------


def _qdq(x, scale, zero_point):
    q = torch.clamp(torch.round(x.double() / float(scale)) + zero_point, -128, 127)
    return (q - zero_point) * float(scale)


def _qdq_own(x):
    return _qdq(x, *ti.asymmetric(float(x.min()), float(x.max())))


def _per_channel_scale(w, dims):
    """``symmetric_per_channel``'s float32 scales of ``w``, kept broadcastable."""
    s = w.float().abs().amax(dims, keepdim=True) / 127
    return torch.where(s > 0, s, torch.ones_like(s)).double()


class _Simulation(torch.fx.Interpreter):
    """The program in float64 with quantize-dequantize wherever the artifact
    holds int8: at each node whose tensor is int8 (the artifact's
    parameters), on the weights (symmetric per output channel), the biases
    (int32 at s_in * s_w) and the other constants of those nodes (per
    tensor, from their own range).  Float64 sums of dequantized codes are
    the integer kernels' int32 sums, exactly."""

    def __init__(self, program, blob, node_map, float_outputs=()):
        from torch.export.graph_signature import InputKind

        super().__init__(program.graph_module)
        self.float_outputs = set(float_outputs)  # nodes whose outputs stay float
        sg = ts.read_model(blob).subgraphs[0]
        self.q = {n: (t.quantization.scale[0], int(t.quantization.zero_point[0]))
                  for n, i in node_map.items() for t in [sg.tensors[i]] if t.type == ts.INT8}
        kinds = {s.arg.name: s.kind for s in program.graph_signature.input_specs}
        self.const = set()
        for n in program.graph.nodes:
            if (n.op == "placeholder" and kinds[n.name] != InputKind.USER_INPUT
                    or n.op == "call_function"
                    and all(a.name in self.const for a in n.all_input_nodes)):
                self.const.add(n.name)

    def call_function(self, target, args, kwargs):
        args = torch.fx.node.map_aggregate(args, ti.as_float64)
        kwargs = {k: ti.as_float64(v) for k, v in kwargs.items()}
        return super().call_function(target, args, kwargs)

    def _weighted(self, n, args):
        """A Linear's or convolution's args with its weight and bias quantized."""
        args = list(args)
        if n.target is aten.convolution.default:
            x, w, b = 0, 1, 2
            s_w = _per_channel_scale(args[w], (1, 2))  # [out, in / groups, K]
        else:
            x, w, b = (0, 1, None) if n.target is aten.mm.default else (1, 2, 0)
            s_w = _per_channel_scale(args[w], (0,))  # [in, out]
        args[w] = torch.clamp(torch.round(args[w].double() / s_w), -127, 127) * s_w
        if b is not None and args[b] is not None:
            s_b = (float(self.q[n.args[x].name][0]) * s_w.ravel()).float().double()
            args[b] = torch.round(args[b].double() / s_b) * s_b
        return args

    def _constant(self, a, arg):
        if isinstance(a, float) and not isinstance(arg, torch.fx.Node):
            return float(_qdq_own(torch.tensor(a)))
        if not (isinstance(arg, torch.fx.Node) and arg.name in self.const
                and isinstance(a, torch.Tensor) and a.is_floating_point()):
            return a
        if bool((a <= ti.MASK_FILL).all()):
            return a  # a mask's fill: the output's lowest code
        return _qdq_own(a)

    def run_node(self, n):
        if n.name not in self.q:
            return super().run_node(n)
        if n.op == "placeholder":
            return _qdq(super().run_node(n), *self.q[n.name])
        args, kwargs = self.fetch_args_kwargs_from_env(n)
        if n.target in (aten.mm.default, aten.addmm.default, aten.convolution.default):
            args = self._weighted(n, args)
        else:
            args = tuple(self._constant(a, arg) for a, arg in zip(args, n.args))
        out = self.call_function(n.target, args, kwargs)
        return out if n.name in self.float_outputs else _qdq(out, *self.q[n.name])


def _simulate(m, inputs):
    with torch.no_grad():
        sim = _Simulation(m["program"], m["port"], m["node_map"])
        return sim.run(*ti.program_args(m["program"], inputs))[0].numpy()


CASES = ["depthwise", "no_depthwise", "flagship"]


@pytest.mark.parametrize("case", CASES)
def test_artifact_runs_and_equals_the_simulation(request, case):
    m, shape = _case(request, case)
    inputs = _inputs(m["cfg"], shape, seed=1)
    got = _run(m["port"], inputs)
    sim = _simulate(m, inputs)
    sg = ts.read_model(m["port"]).subgraphs[0]
    (prediction,) = [t for t in sg.tensors if t.name == "prediction_int8"]
    quantum = float(prediction.quantization.scale[0])
    diff = np.abs(got - sim)
    print(f"{case}: artifact vs simulation mean {diff.mean():.3g}, max {diff.max():.3g}, "
          f"output quantum {quantum:.3g}")
    assert got.shape == (shape[0], shape[1], m["cfg"].n_mels) and np.all(np.isfinite(got))
    assert diff.mean() <= quantum


@pytest.mark.parametrize("case", CASES)
def test_artifact_within_a_gross_bar_of_the_float_artifact(request, case):
    m, shape = _case(request, case)
    inputs = _inputs(m["cfg"], shape, seed=2)
    got, ref = _run(m["port"], inputs), _run(m["float"], inputs)
    err = np.abs(got - ref).mean() / np.abs(ref).mean()
    print(f"{case}: mean |int8 - float| / mean |float| = {err:.4g}")
    assert err <= 0.1


def test_graph_is_full_integer_behind_float_seams(tiny):
    model, ops = _ops(tiny[True]["port"])
    sg = model.subgraphs[0]
    names = [name for name, _ in ops]
    floats = {name for name, op in ops if sg.tensors[op.outputs[0]].type == ts.FLOAT32}
    assert floats == {"CAST", "RESHAPE", "MUL", "SIN", "COS", "CONCATENATION", "DEQUANTIZE"}
    assert names[-1] == "DEQUANTIZE" and names.count("DEQUANTIZE") == 1
    assert sg.tensors[sg.outputs[0]].name == "prediction"
    assert [sg.tensors[i].type for i in sg.inputs] == [ts.FLOAT32, ts.INT32, ts.INT32,
                                                       ts.INT32]
    x_t = int(sg.inputs[0])
    consumers = [name for name, op in ops if x_t in op.inputs]
    assert consumers == ["QUANTIZE"]
    assert {"FULLY_CONNECTED", "BATCH_MATMUL", "GELU", "SOFTMAX", "RSQRT", "MEAN"} <= {
        name for name, op in ops if sg.tensors[op.outputs[0]].type == ts.INT8}
    for name, op in ops:
        if name in ("SOFTMAX", "LOGISTIC"):
            q = sg.tensors[op.outputs[0]].quantization
            assert (float(q.scale[0]), int(q.zero_point[0])) == (1 / 256, -128)


# ---- (f), (g): no silent abort ---------------------------------------------------------


def test_unrepresentable_multiplier_raises_naming_the_op(tiny, tmp_path):
    m = tiny[True]
    batches = [(x * np.float32(1e30), t, s, st)
               for x, t, s, st in synthetic_representative_batches(m["cfg"], *SHAPE)]
    path = tmp_path / "never.tflite"
    with pytest.raises(ValueError, match=r"int8 export: [A-Z_]+ '\w+' \(inputs '\w+'.*"
                                         r"unrepresentable; nothing was written"):
        export_tflite(m["cfg"], m["pdec"], str(path), *SHAPE, quantize="int8",
                      representative_batches=batches)
    assert not path.exists()


@pytest.mark.parametrize("name,s_in,s_out,fault", [
    ("ADD", (6.68e28, 0.001335), 2.0e34, "aborts"),
    ("ADD", (1.0, 1.0), 1e-6, "aborts"),
    ("MUL", (1.0, 1e-12), 1.0, "flushes"),
    ("FULLY_CONNECTED", (1.0, 2.0 ** 31), 1.0, "past the kernel's shifts"),
    ("ADD", (0.04, 0.001), 0.05, None),
], ids=["jax_erfc_add", "add_output_multiplier", "flushed", "past_shifts", "fine"])
def test_requantization_fault(name, s_in, s_out, fault):
    got = ti.requantization_fault(name, [np.asarray([s]) for s in s_in], s_out)
    assert (got is None) if fault is None else (fault in got), got


def _invoke_cut(blob, last):
    """Invoke ``blob`` cut after operator ``last``, on seeded inputs."""
    model = ts.read_model(blob)
    sg = model.subgraphs[0]
    sg.operators = sg.operators[:last + 1]
    sg.outputs = np.asarray([sg.operators[-1].outputs[0]], np.int32)
    model.signature_defs = None
    interp = tf.lite.Interpreter(model_content=ts.write_model(model))
    interp.allocate_tensors()
    rs = np.random.RandomState(0)
    for d in interp.get_input_details():
        value = rs.randn(*d["shape"]) if d["dtype"] == np.float32 else rs.randint(0, 10, d["shape"])
        interp.set_tensor(d["index"], value.astype(d["dtype"]))
    interp.invoke()


def _cuts_in_a_child(blob, lasts, timeout=120.0):
    """Invoke each cut of ``blob`` in turn in a forked child, which an abort
    ends and not this process; returns (the cuts invoked, how the child
    ended: its exit code, or minus its signal)."""
    import time

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # the child: no return from here
        import resource

        os.close(r)
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))  # an abort leaves no core file
        code = 1
        try:
            for last in lasts:
                _invoke_cut(blob, last)
                os.write(w, f"{last}\n".encode())
            code = 0
        finally:
            os._exit(code)
    os.close(w)
    end = time.monotonic() + timeout
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.monotonic() > end:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            raise TimeoutError("the child invoking the cut artifact hung")
        time.sleep(0.05)
    with os.fdopen(r) as f:
        invoked = [int(x) for x in f.read().split()]
    return invoked, (os.WEXITSTATUS(status) if os.WIFEXITED(status)
                     else -os.WTERMSIG(status))


def test_jax_int8_artifact_aborts_at_its_gelu_expansion_add(tiny):
    """Queue C: JAX's artifact keeps the erfc expansion of the time MLP's
    exact GELU in int8; its calibrated scales grow past float32 there, and
    the first ADD whose output multiplier TFLite's kernel cannot form aborts
    the interpreter.  The graph cut just before that ADD runs; cut at it,
    it aborts."""
    m = tiny[True]
    model, ops = _ops(m["jax"])
    sg = model.subgraphs[0]
    fcs = [k for k, (name, _) in enumerate(ops) if name == "FULLY_CONNECTED"]
    at = None
    for k, (name, op) in enumerate(ops):
        if sg.tensors[op.outputs[0]].type != ts.INT8 or name == "QUANTIZE":
            continue
        _, s_in, s_out = ti.op_scales(sg.tensors, op.inputs, op.outputs[0])
        fault = ti.requantization_fault(name, s_in, s_out)
        if fault is not None and "aborts" in fault:
            at = k
            break
    assert at is not None and ops[at][0] == "ADD"
    assert fcs[0] < at < fcs[1]  # between the time MLP's two Linears: its GELU
    const = [sg.tensors[i] for i in ops[at][1].inputs
             if ts.constant(model, sg.tensors[i]) is not None]
    assert len(const) == 1 and const[0].shape.size == 0  # a scalar: an erfc coefficient
    print(f"JAX's int8 artifact: operator {at} (ADD) aborts; scales "
          f"{[float(sg.tensors[i].quantization.scale[0]) for i in ops[at][1].inputs]} -> "
          f"{float(sg.tensors[ops[at][1].outputs[0]].quantization.scale[0])}")
    invoked, ended = _cuts_in_a_child(m["jax"], [at - 1, at])
    assert invoked == [at - 1] and ended == -signal.SIGABRT, (invoked, ended)


def _one_op(name, in_scales, out_scale, zero_points=(0, 0, 0), shapes=((4, 8), (4, 8))):
    """A model of QUANTIZEs of two float inputs and one int8 ``name`` on
    them at the given parameters (and a DEQUANTIZE for BATCH_MATMUL)."""
    from edge_diffusion_tts_tpu_torch.utils.tflite_lower import Lowering

    low = Lowering()
    T = low.tensors
    floats = [low.tensor(shape, torch.float32, f"in{k}") for k, shape in enumerate(shapes)]
    out_shape = ((shapes[0][0], shapes[1][1]) if name == "BATCH_MATMUL" else shapes[0])

    def int8(shape, scale, zp, tag):
        i = low.tensor(shape, torch.float32, tag)
        T[i].type, T[i].quantization = ts.INT8, ti._per_tensor(scale, zp)
        return i

    q = [int8(shape, s, z, f"q{k}") for k, (shape, s, z) in
         enumerate(zip(shapes, in_scales, zero_points))]
    out = int8(out_shape, out_scale, zero_points[2], "out")
    result = low.tensor(out_shape, torch.float32, "result")
    low.ops = [(ts.BUILTIN["QUANTIZE"], [f], qi, None, 1) for f, qi in zip(floats, q)]
    low.ops += [(ts.BUILTIN[name], q, out, ts.options(
        "BatchMatMulOptions" if name == "BATCH_MATMUL" else name.title() + "Options"), 2),
        (ts.BUILTIN["DEQUANTIZE"], [out], result, None, 2)]
    model = low.model(floats + floats, result, "one op")
    model.signature_defs = None
    model.subgraphs[0].inputs = np.asarray(floats, np.int32)
    return ts.write_model(model)


@pytest.mark.parametrize("s_in,s_out", [
    ((1.0, 1.0), 1e-6), ((1.0, 1.0), 9.5e-7), ((1.0, 1.0), 1e33),
    ((6.68e28, 0.001335), 2.0e34), ((1.0, 1.0), 2e-6), ((1.0, 1.0), 1e30),
    ((1.0, 1e-32), 2.0),
], ids=["multiplier_1.9", "multiplier_2.0", "overflow", "jax_operator_38", "multiplier_0.95",
        "tiny_multiplier", "input_flushed"])
def test_add_aborts_exactly_where_the_check_says(s_in, s_out):
    """TFLite's int8 ADD aborts the interpreter where ``requantization_fault``
    says it does, and runs where it does not say so (a flushed input
    multiplier runs, and the check refuses it as flushed)."""
    fault = ti.requantization_fault("ADD", [np.asarray([s]) for s in s_in], s_out)
    invoked, ended = _cuts_in_a_child(_one_op("ADD", s_in, s_out), [3])
    aborts = fault is not None and "aborts" in fault
    assert (ended == -signal.SIGABRT and invoked == []) if aborts else (
        ended == 0 and invoked == [3]), (fault, invoked, ended)


def test_batch_matmul_drops_its_right_sides_zero_point():
    """TFLite's int8 BATCH_MATMUL computes as if its right side's zero point
    were 0: hence the port quantizes that side with zero point 0."""
    rs = np.random.RandomState(0)
    a = rs.randn(20, 16).astype(np.float32)
    b = rs.randn(16, 20).astype(np.float32)
    for zb, drops in ((0, False), (-5, True)):
        blob = _one_op("BATCH_MATMUL", (0.03, 0.03), 0.1, (3, zb, 3), ((20, 16), (16, 20)))
        interp = tf.lite.Interpreter(model_content=blob)
        interp.allocate_tensors()
        details = interp.get_input_details()
        interp.set_tensor(details[0]["index"], a)
        interp.set_tensor(details[1]["index"], b)
        interp.invoke()
        got = interp.get_tensor(interp.get_output_details()[0]["index"])
        qa = np.clip(np.round(a / 0.03) + 3, -128, 127)
        qb = np.clip(np.round(b / 0.03) + zb, -128, 127)
        offset = ((qa - 3) * 0.03) @ ((qb - zb) * 0.03)
        dropped = ((qa - 3) * 0.03) @ (qb * 0.03)
        want = dropped if drops else offset
        assert np.abs(got - want).mean() <= 0.05, zb  # half an output quantum
        if drops:
            assert np.abs(got - offset).mean() > 0.3


# ---- the reader and writer, and the CLI --------------------------------------------------


def test_round_trip_of_jax_int8_artifact(tiny):
    """The reader takes all of JAX's int8 artifact (QUANTIZE included) and
    the writer writes it back whole: the TF schema parser reads the same
    model from both, and a second round trip is byte-equal to the first.
    (TF's FlatBuffers code lays a buffer out back to front, the writer
    front to back, so the first pass cannot give TF's own bytes.)"""
    from tensorflow.lite.python import schema_py_generated as schema

    blob = tiny[True]["jax"]
    again = ts.write_model(ts.read_model(blob))
    assert ts.write_model(ts.read_model(again)) == again
    a, b = (schema.ModelT.InitFromPackedBuf(bytearray(x), 0) for x in (blob, again))
    assert [(c.builtinCode, c.deprecatedBuiltinCode, c.version) for c in a.operatorCodes] == [
        (c.builtinCode, c.deprecatedBuiltinCode, c.version) for c in b.operatorCodes]
    assert ts.BUILTIN["QUANTIZE"] in {c.builtinCode for c in a.operatorCodes}
    sa, sb = a.subgraphs[0], b.subgraphs[0]
    for x, y in zip(sa.operators, sb.operators):
        assert (x.opcodeIndex, list(x.inputs), list(x.outputs), x.builtinOptionsType) == (
            y.opcodeIndex, list(y.inputs), list(y.outputs), y.builtinOptionsType)
    assert len(sa.tensors) == len(sb.tensors)
    for x, y in zip(sa.tensors, sb.tensors):
        assert (x.name, list(x.shape), x.type, x.buffer) == (y.name, list(y.shape), y.type,
                                                             y.buffer)
        qx, qy = x.quantization, y.quantization
        if qx is not None and qx.scale is not None:
            assert np.array_equal(qx.scale, qy.scale)
            assert np.array_equal(qx.zeroPoint, qy.zeroPoint)
            assert qx.quantizedDimension == qy.quantizedDimension
    for x, y in zip(a.buffers, b.buffers):
        assert (x.data is None and y.data is None) or np.array_equal(x.data, y.data)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.manual_seed(3)
    cfg = PCFG(**SMALL, use_depthwise=True)
    dec = PDecoder(cfg).eval()
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.02 * torch.randn_like(p))
    path = str(tmp_path_factory.mktemp("tflite_int8_cli") / "ckpt")
    save_checkpoint(path, cfg, dec)
    return dict(path=path, cfg=cfg, dec=dec)


@pytest.mark.parametrize("flags,shape", [
    (["--t-frames", "24", "--s-tokens", "12"], (1, 24, 12)),
    ([], (1, 200, 100)),
], ids=["edge_tts_torch_export", "cli_main_default_shape"])
def test_cli_export_int8_writes_export_tflites_bytes(ckpt, tmp_path, flags, shape):
    """``export --format tflite --quantize int8`` (as test_torch_tflite_cli
    and test_torch_demo_cli drive the command line) writes the bytes
    ``export_tflite(quantize="int8")`` writes, calibrated on the synthetic
    batches; the artifact runs."""
    out = str(tmp_path / "cli.tflite")
    cli.main(["export", ckpt["path"], "--format", "tflite", "--quantize", "int8", "--out", out,
              "--device", "cpu"] + flags)
    want = str(tmp_path / "api.tflite")
    export_tflite(ckpt["cfg"], ckpt["dec"], want, *shape, quantize="int8")
    with open(out, "rb") as a, open(want, "rb") as b:
        got = a.read()
        assert got == b.read()
    sg = ts.read_model(got).subgraphs[0]
    assert [tuple(sg.tensors[i].shape) for i in sg.inputs] == [
        (1, shape[1], 80), (1,), (1, shape[2]), (1,)]
    assert sum(t.type == ts.INT8 for t in sg.tensors) > 50
    out_value = _run(got, _inputs(ckpt["cfg"], shape, seed=3))
    assert out_value.shape == (1, shape[1], 80) and np.all(np.isfinite(out_value))


# ---- the report ---------------------------------------------------------------------


def report(out_dir: str) -> None:
    """Print the int8 artifact's numbers at configs/flagship.json, (1, 200,
    100), beside the float and weight_int8 ones, under QUANT_r05.json's
    protocol and field names (tools/quant_report.py): the JAX package's
    initial weights with the zero-initialized tensors filled with 0.02 * N(0,
    1), carried across with the weight bridge; ``fwd_l1``: mean |artifact -
    the port's eager decoder| of one forward at t = 500, step 0;
    ``e2e_4step_mel_l1``: the same of the 4-step DDIM mel, against the
    1e-2 budget.  Interpreter numbers are this machine's CPU.  Run from the
    repo root: ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    tests/test_torch_tflite_int8.py``."""
    import json
    import time

    import jax.numpy as jnp

    from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
    from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
    from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule, ddim_sample
    from edge_diffusion_tts_tpu_torch.utils.export import load_tflite
    from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        jcfg = JCFG.from_json(f.read())
    jcfg.dropout = 0.0
    params = init_decoder_params(JDecoder(jcfg), jax.random.PRNGKey(0), jcfg)["params"]
    leaves, treedef = jax.tree.flatten(params)
    filled, key = [], jax.random.PRNGKey(1)
    for p in leaves:
        if float(jnp.abs(p).max()) == 0.0:
            key, sub = jax.random.split(key)
            p = 0.02 * jax.random.normal(sub, p.shape, p.dtype)
        filled.append(p)
    params = jax.tree.unflatten(treedef, filled)
    cfg = PCFG.from_json(jcfg.to_json())
    dec = PDecoder(cfg)
    dec.load_state_dict(state_dict_from_jax(params, cfg))
    dec.eval()
    B, T, S = FLAGSHIP_SHAPE
    rs = np.random.RandomState(0)
    x = rs.randn(B, T, cfg.n_mels).astype(np.float32)
    t = np.full((B,), 500, np.int32)
    sem = rs.randint(0, cfg.effective_codebook_size(), (B, S)).astype(np.int32)
    step = np.zeros((B,), np.int32)
    x_T = torch.from_numpy(rs.randn(B, T, cfg.n_mels).astype(np.float32))
    schedule = DiffusionSchedule.create(cfg.diff_steps)

    def eager(xx, tt, ii):
        with torch.no_grad():
            return dec(xx, tt.int(), sem_idx=torch.from_numpy(sem), step_idx=ii.int())

    with torch.no_grad():
        ref = eager(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(step)).numpy()
        mel_ref = ddim_sample(schedule, eager, x_T, 4).numpy()
    out = {}
    for mode in ("", "weight_int8", "int8"):
        path = os.path.join(out_dir, f"flagship_{mode or 'float'}.tflite")
        t0 = time.perf_counter()
        export_tflite(cfg, dec, path, B, T, S, quantize=mode)
        secs = time.perf_counter() - t0
        run = load_tflite(path)

        def artifact(xx, tt, ii, run=run):
            return torch.from_numpy(run(xx.numpy(), tt.numpy(), sem, ii.numpy()))

        t0 = time.perf_counter()
        fwd = run(x, t, sem, step)
        invoke_ms = 1e3 * (time.perf_counter() - t0)
        mel = ddim_sample(schedule, artifact, x_T, 4).numpy()
        with open(path, "rb") as f:
            sg = ts.read_model(f.read()).subgraphs[0]
        out[mode or "float"] = dict(
            artifact_bytes=os.path.getsize(path), operators=len(sg.operators),
            int8_tensors=sum(t.type == ts.INT8 for t in sg.tensors), export_s=secs,
            first_invoke_ms=invoke_ms, fwd_l1=float(np.abs(fwd - ref).mean()),
            e2e_4step_mel_l1=float(np.abs(mel - mel_ref).mean()),
            within_1e2_budget=bool(np.abs(mel - mel_ref).mean() <= 1e-2))
    out["fwd_ref_mean_abs"] = float(np.abs(ref).mean())
    out["e2e_mel_mean_abs"] = float(np.abs(mel_ref).mean())
    # Where the int8 forward's error comes from: the simulation (the
    # artifact's own parameters) with one kind of node's outputs quantized
    # and every other output left float (weights and constants always int8).
    blob, node_map, program = _port_int8(cfg, dec, FLAGSHIP_SHAPE)
    sim = _Simulation(program, blob, node_map)
    kinds = {}
    for n in program.graph.nodes:
        if n.name in sim.q:
            kind = "input" if n.op == "placeholder" else n.target.__name__.split(".")[0]
            kinds.setdefault(kind, []).append(n.name)
    args = ti.program_args(program, (x, t, sem, step))

    def sim_l1(float_outputs):
        with torch.no_grad():
            got = _Simulation(program, blob, node_map, float_outputs).run(*args)[0].numpy()
        return float(np.abs(got - ref).mean())

    every = set(sim.q)
    out["fwd_l1_by_quantized_outputs"] = dict(
        all=sim_l1(()), none=sim_l1(every),
        **{k: sim_l1(every - set(v)) for k, v in sorted(kinds.items())})
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        report(d)
