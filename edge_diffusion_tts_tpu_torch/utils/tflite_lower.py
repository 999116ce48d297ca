"""The decoder's static ``torch.export`` program lowered to TFLite builtins.

This stands where the JAX package uses jax2tf and TensorFlow's converter.
``lower_decoder`` traces ``_DenoiseForward`` over a plain CPU copy of the
decoder (``utils/export.py``) at one static shape with int32 ``t``,
``sem_idx`` and ``step_idx``, runs ``run_decompositions()`` (core ATen, an
op set that holds across torch releases) and walks the graph once:

- a node that depends on no input is computed with torch and becomes a
  constant: the positional tables sliced to T and S, the band mask, the
  time-embedding frequencies, every transpose or reshape of a weight.  So a
  weight lands in the flatbuffer once, in the layout its op reads, named
  by its state-dict name;
- every other node goes through ``LOWER``, a table from ATen op to the
  builtins that compute it, written for the ops the decoder's graph holds
  in every shipped config.  An op without an entry, or a form of one the
  entry does not cover, raises NotImplementedError naming it.

Transposes are carried lazily: a value is a TFLite tensor and a permutation
of its axes, and a ``permute`` only changes the permutation.  Unary ops,
pads, slices and reductions work on the stored layout, and the pre-net's
convolutions and GroupNorm take their [B, C, T] operand stored as
[B, T, C], as it lies.  A TRANSPOSE is emitted only where a reshape, a
matmul or a binary op needs the logical layout.

Each operator's version is the one TensorFlow's converter gives the same op
on the same types (read from the JAX package's artifacts: FULLY_CONNECTED 5
with ``keep_num_dims``, TRANSPOSE 4 and SLICE 5 on rank-5 operands; 1
otherwise); codes of 127 and above carry ``deprecated_builtin_code`` 127.
Identical constants are stored once.  The model has one subgraph, inputs
``x_t`` [B, T, n_mels] float32, ``t`` [B], ``sem_idx`` [B, S] and
``step_idx`` [B] int32, output ``prediction`` [B, T, n_mels] float32, and a
``serving_default`` signature over them.
"""

from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tflite_surgery import BOOL, BUILTIN, FLOAT32, INT32, SCHEMA_VERSION, Table, options

_TFL_TYPE = {torch.float32: FLOAT32, torch.int32: INT32, torch.bool: BOOL}
INPUT_NAMES = ("x_t", "t", "sem_idx", "step_idx")
OUTPUT_NAME = "prediction"


class Value:
    """A TFLite tensor seen through a permutation: the logical tensor is
    ``stored.permute(perm)``."""

    __slots__ = ("index", "shape", "dtype", "perm")

    def __init__(self, index: int, shape: Sequence[int], dtype, perm=None):
        self.index, self.shape, self.dtype = index, tuple(int(d) for d in shape), dtype
        self.perm = tuple(range(len(self.shape))) if perm is None else tuple(perm)

    @property
    def logical(self) -> Tuple[int, ...]:
        return tuple(self.shape[p] for p in self.perm)

    @property
    def plain(self) -> bool:
        return self.perm == tuple(range(len(self.perm)))


class Const:
    """A value known at export time, with the weight or table it came from."""

    __slots__ = ("value", "name")

    def __init__(self, value: torch.Tensor, name: Optional[str] = None):
        self.value, self.name = value, name


def _version(code: int, rank: int, opts: Optional[Table]) -> int:
    if code == BUILTIN["FULLY_CONNECTED"]:
        return 5 if opts.keep_num_dims else 1
    if code == BUILTIN["TRANSPOSE"]:
        return 6 if rank > 5 else 4 if rank > 4 else 1
    if code == BUILTIN["SLICE"]:
        return 5 if rank > 4 else 1
    return 1


class Lowering:
    """One model under construction: tensors, buffers, operators."""

    def __init__(self):
        self.tensors: List[Table] = []
        self.buffers: List[Table] = [Table("Buffer")]  # buffer 0: no data
        self.ops: List[tuple] = []  # (code, inputs, output, options, version)
        self._consts: Dict[tuple, int] = {}
        self.weights: Dict[str, int] = {}  # weight or table name -> tensor index

    def tensor(self, shape, dtype, name: str) -> int:
        self.tensors.append(Table("Tensor", shape=np.asarray(shape, np.int32),
                                  type=_TFL_TYPE[dtype], name=name, has_rank=True))
        return len(self.tensors) - 1

    def const(self, value: torch.Tensor, name: Optional[str] = None) -> int:
        """The tensor of a constant (one per distinct dtype, shape and bytes)."""
        t = value.detach().contiguous()
        data = t.numpy().tobytes()
        key = (t.dtype, tuple(t.shape), data)
        if key not in self._consts:
            self.buffers.append(Table("Buffer", data=data))
            idx = self.tensor(t.shape, t.dtype, name or f"const_{len(self._consts)}")
            self.tensors[idx].buffer = len(self.buffers) - 1
            self._consts[key] = idx
        if name is not None:
            self.weights.setdefault(name, self._consts[key])
        return self._consts[key]

    def ints(self, values) -> int:
        return self.const(torch.tensor(list(values), dtype=torch.int32))

    def op(self, name: str, inputs: Sequence[int], shape, dtype, out_name: str,
           opts: Optional[Tuple[int, Table]] = None, perm=None) -> Value:
        code = BUILTIN[name]
        out = self.tensor(shape, dtype, out_name)
        rank = max(len(self.tensors[i].shape) for i in inputs if i >= 0)
        self.ops.append((code, list(inputs), out, opts,
                         _version(code, rank, None if opts is None else opts[1])))
        return Value(out, shape, dtype, perm)

    def plain(self, v: Value, name: str) -> Value:
        """``v`` stored in its logical layout (a TRANSPOSE if it is not)."""
        if v.plain:
            return v
        return self.op("TRANSPOSE", [v.index, self.ints(v.perm)], v.logical, v.dtype,
                       f"{name}_transpose")

    def reshape(self, v: Value, shape, name: str, perm=None) -> Value:
        return self.op("RESHAPE", [v.index, self.ints(shape)], shape, v.dtype, name, perm=perm)

    def model(self, inputs: List[int], output: int, description: str) -> Table:
        versions: Dict[int, int] = {}
        for code, _, _, _, version in self.ops:  # first use orders the codes
            versions[code] = max(versions.get(code, 0), version)
        index = {c: i for i, c in enumerate(versions)}
        operators = []
        for code, ins, out, opts, _ in self.ops:
            op = Table("Operator", opcode_index=index[code], inputs=np.asarray(ins, np.int32),
                       outputs=np.asarray([out], np.int32))
            if opts is not None:
                op.builtin_options_type, op.builtin_options = opts
            operators.append(op)
        signature = Table(
            "SignatureDef", signature_key="serving_default", subgraph_index=0,
            inputs=[Table("TensorMap", name=n, tensor_index=i) for n, i in zip(INPUT_NAMES, inputs)],
            outputs=[Table("TensorMap", name=OUTPUT_NAME, tensor_index=output)])
        return Table(
            "Model", version=SCHEMA_VERSION, description=description, buffers=self.buffers,
            operator_codes=[Table("OperatorCode", builtin_code=c, version=v,
                                  deprecated_builtin_code=min(c, 127))
                            for c, v in versions.items()],
            subgraphs=[Table("SubGraph", tensors=self.tensors, operators=operators, name="main",
                             inputs=np.asarray(inputs, np.int32),
                             outputs=np.asarray([output], np.int32))],
            signature_defs=[signature])


def _meta(node) -> Tuple[Tuple[int, ...], torch.dtype]:
    val = node.meta["val"]
    return tuple(int(d) for d in val.shape), val.dtype


def _axis(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


# Layout-only ops: a constant they produce keeps its source's name.
_KEEPS_NAME = {torch.ops.aten.permute.default, torch.ops.aten.view.default,
               torch.ops.aten.unsqueeze.default, torch.ops.aten.clone.default,
               torch.ops.aten.expand.default}
_SKIP = {torch.ops.aten._assert_tensor_metadata.default}


class _Graph:
    """Walks one exported program into a ``Lowering``."""

    def __init__(self, low: Lowering):
        self.low = low

    def operand(self, x, dtype, name: str) -> int:
        """A tensor index for ``x``: a Value (in its logical layout), a Const
        or a Python number (cast to ``dtype``)."""
        if isinstance(x, Value):
            return self.low.plain(x, name).index
        if isinstance(x, Const):
            return self.low.const(x.value.to(dtype), x.name)
        return self.low.const(torch.tensor(x, dtype=dtype))

    def run(self, program) -> Tuple[List[int], int]:
        consts = {**program.state_dict, **program.constants}
        specs = {s.arg.name: s for s in program.graph_signature.input_specs}
        env: Dict[object, object] = {}
        inputs: List[int] = []
        for node in program.graph.nodes:
            if node.op == "placeholder":
                target = specs[node.name].target
                if target in consts:  # a weight or a table
                    env[node] = Const(consts[target].detach(), target.removeprefix("decoder."))
                else:
                    shape, dtype = _meta(node)
                    index = self.low.tensor(shape, dtype, INPUT_NAMES[len(inputs)])
                    inputs.append(index)
                    env[node] = Value(index, shape, dtype)
            elif node.op == "call_function":
                env[node] = self.call(node, env)
            elif node.op == "output":
                (result,) = node.args[0]
                out = self.low.plain(env[result], OUTPUT_NAME)
                self.low.tensors[out.index].name = OUTPUT_NAME
                return inputs, out.index
        raise ValueError("the program has no output node")

    def call(self, node, env):
        if node.target in _SKIP:
            return None

        def look(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (list, tuple)):
                return type(a)(look(x) for x in a)
            return a

        args = [look(a) for a in node.args]
        kwargs = {k: look(v) for k, v in node.kwargs.items()}
        if node.target is operator.getitem:
            return args[0][args[1]]
        flat = [a for a in args + list(kwargs.values())
                for a in (a if isinstance(a, (list, tuple)) else [a])]
        if not any(isinstance(a, Value) for a in flat):
            return self.fold(node, args, kwargs)
        rule = LOWER.get(node.target)
        if rule is None:
            raise NotImplementedError(f"no TFLite lowering for {node.target} (node {node.name})")
        return rule(self, node, *args, **kwargs)

    def fold(self, node, args, kwargs):
        def raw(a):
            if isinstance(a, Const):
                return a.value
            if isinstance(a, (list, tuple)):
                return type(a)(raw(x) for x in a)
            return a

        with torch.no_grad():
            out = node.target(*raw(args), **{k: raw(v) for k, v in kwargs.items()})
        src = [a for a in args if isinstance(a, Const)]
        name = None
        if len(src) == 1 and src[0].name is not None:
            keep = node.target in _KEEPS_NAME
            name = src[0].name if keep else f"{src[0].name}:{node.name}"
        if isinstance(out, (list, tuple)):
            return [Const(o, name) for o in out]
        return Const(out, name)


def _unsupported(node, what: str):
    return NotImplementedError(f"{node.target} (node {node.name}): {what} does not lower")


# ---- the rules: (graph, node, *the node's args) -> Value -------------------------------


def _binary(name):
    def rule(g, node, a, b, alpha=1):
        if alpha != 1:
            raise _unsupported(node, f"alpha={alpha}")
        shape, dtype = _meta(node)
        idx = [g.operand(x, dtype, node.name) for x in (a, b)]
        return g.low.op(name, idx, shape, dtype, node.name, options(name.title() + "Options"))
    return rule


def _unary(name, opts=None):
    def rule(g, node, x, **kwargs):
        return g.low.op(name, [x.index], x.shape, x.dtype, node.name, opts and opts(**kwargs),
                        perm=x.perm)
    return rule


def _gelu_options(approximate="none"):
    return options("GeluOptions", approximate=approximate == "tanh")


def _identity(g, node, x, **kwargs):
    return x


def _reshape(g, node, x, *args):
    shape, _ = _meta(node)
    return g.low.reshape(g.low.plain(x, node.name), shape, node.name)


def _to_copy(g, node, x, dtype=None, **kwargs):
    if dtype is None or dtype == x.dtype:
        return x
    return g.low.op("CAST", [x.index], x.shape, dtype, node.name, perm=x.perm)


def _permute(g, node, x, dims):
    return Value(x.index, x.shape, x.dtype, [x.perm[_axis(d, len(x.perm))] for d in dims])


def _expand(g, node, x, size, **kwargs):
    if _meta(node)[0] != x.logical:
        raise _unsupported(node, "a broadcasting expand")
    return x


def _slice_stored(g, x: Value, axis: int, start: int, size: int, name: str) -> Value:
    begin, sizes = [0] * len(x.shape), list(x.shape)
    begin[axis], sizes[axis] = start, size
    return g.low.op("SLICE", [x.index, g.low.ints(begin), g.low.ints(sizes)], sizes, x.dtype,
                    name, perm=x.perm)


def _select(g, node, x, dim, index):
    dim = _axis(dim, len(x.perm))
    axis = x.perm[dim]
    piece = _slice_stored(g, x, axis, index % x.logical[dim], 1, f"{node.name}_slice")
    stored = tuple(d for i, d in enumerate(x.shape) if i != axis)
    perm = [p - (p > axis) for i, p in enumerate(x.perm) if i != dim]
    return g.low.reshape(piece, stored, node.name, perm=perm)


def _split(g, node, x, sizes, dim=0):
    axis = x.perm[_axis(dim, len(x.perm))]
    starts = np.cumsum([0] + list(sizes))
    return [_slice_stored(g, x, axis, int(s), n, f"{node.name}_{i}")
            for i, (s, n) in enumerate(zip(starts, sizes))]


def _cat(g, node, tensors, dim=0):
    shape, dtype = _meta(node)
    return g.low.op("CONCATENATION", [g.operand(t, dtype, node.name) for t in tensors], shape,
                    dtype, node.name, options("ConcatenationOptions", axis=_axis(dim, len(shape))))


def _fully_connected(g, node, x, w, bias=None) -> Value:
    """x [..., in] @ w [in, out] (+ bias) with w a constant: FULLY_CONNECTED,
    whose weight is stored [out, in]."""
    if not (isinstance(x, Value) and isinstance(w, Const) and w.value.dim() == 2
            and (bias is None or isinstance(bias, Const) and bias.value.dim() == 1)):
        raise _unsupported(node, "a product whose right side is not a constant matrix")
    shape, dtype = _meta(node)
    b = -1 if bias is None else g.low.const(bias.value, bias.name)
    return g.low.op("FULLY_CONNECTED",
                    [g.low.plain(x, node.name).index, g.low.const(w.value.t(), w.name), b],
                    shape, dtype, node.name, options("FullyConnectedOptions", keep_num_dims=True))


def _addmm(g, node, bias, a, b, beta=1, alpha=1):
    if beta != 1 or alpha != 1:
        raise _unsupported(node, f"beta={beta}, alpha={alpha}")
    return _fully_connected(g, node, a, b, bias)


def _bmm(g, node, a, b):
    shape, dtype = _meta(node)
    return g.low.op("BATCH_MATMUL", [g.operand(x, dtype, node.name) for x in (a, b)], shape,
                    dtype, node.name, options("BatchMatMulOptions"))


def _softmax(g, node, x, dim, half_to_float=False):
    if _axis(dim, len(x.perm)) != len(x.perm) - 1:
        raise _unsupported(node, "a softmax over another axis than the last")
    x = g.low.plain(x, node.name)
    return g.low.op("SOFTMAX", [x.index], x.shape, x.dtype, node.name,
                    options("SoftmaxOptions", beta=1.0))


def _mean(g, node, x, dims, keepdim=False, dtype=None):
    if not keepdim:
        raise _unsupported(node, "a mean without keepdim")
    return _reduce_mean(g, x, sorted(x.perm[_axis(d, len(x.perm))] for d in dims), node.name)


def _reduce_mean(g, x: Value, axes, name: str) -> Value:
    shape = tuple(1 if i in axes else d for i, d in enumerate(x.shape))
    return g.low.op("MEAN", [x.index, g.low.ints(axes)], shape, x.dtype, name,
                    options("ReducerOptions", keep_dims=True), perm=x.perm)


def _pow(g, node, x, exponent):
    if exponent != 2:
        raise _unsupported(node, f"exponent {exponent}")
    x = g.low.plain(x, node.name)
    return g.low.op("MUL", [x.index, x.index], x.shape, x.dtype, node.name,
                    options("MulOptions"))


def _clamp(g, node, x, min=None, max=None):
    x = g.low.plain(x, node.name)
    for bound, name in ((min, "MAXIMUM"), (max, "MINIMUM")):
        if bound is not None:
            x = g.low.op(name, [x.index, g.operand(bound, x.dtype, node.name)], x.shape,
                         x.dtype, f"{node.name}_{name.lower()}")
    return x


def _where(g, node, cond, a, b):
    shape, dtype = _meta(node)
    idx = [g.operand(cond, torch.bool, node.name), g.operand(a, dtype, node.name),
           g.operand(b, dtype, node.name)]
    return g.low.op("SELECT_V2", idx, shape, dtype, node.name, options("SelectV2Options"))


def _embedding(g, node, weight, indices, *args):
    if not isinstance(weight, Const) or indices.dtype != torch.int32:
        raise _unsupported(node, "a lookup in a table that is not a constant, or by "
                                 "indices that are not int32")
    shape, dtype = _meta(node)
    return g.low.op("GATHER", [g.low.const(weight.value, weight.name),
                               g.low.plain(indices, node.name).index],
                    shape, dtype, node.name, options("GatherOptions", axis=0))


def _constant_pad(g, node, x, pad, value=0.0):
    if value != 0 or any(p < 0 for p in pad):
        raise _unsupported(node, "a pad by a value other than 0, or a crop")
    rank = len(x.perm)
    stored = [[0, 0] for _ in range(rank)]
    for i in range(len(pad) // 2):  # pad's pairs run from the last logical axis back
        stored[x.perm[rank - 1 - i]] = [pad[2 * i], pad[2 * i + 1]]
    shape = [n + a + b for n, (a, b) in zip(x.shape, stored)]
    return g.low.op("PAD", [x.index, g.low.const(torch.tensor(stored, dtype=torch.int32))],
                    shape, x.dtype, node.name, perm=x.perm)


def _channels_last(x: Value) -> bool:
    """A [B, C, T] value stored [B, T, C]."""
    return x.perm == (0, 2, 1)


def _convolution(g, node, x, weight, bias, stride, padding, dilation, transposed,
                 output_padding, groups):
    """A 1-D convolution of [B, C, T] stored [B, T, C], as a 2-D one on
    [B, T, 1, C]: DEPTHWISE_CONV_2D (groups = channels) or CONV_2D."""
    if (transposed or not isinstance(weight, Const) or weight.value.dim() != 3
            or any(padding) or not _channels_last(x)):
        raise _unsupported(node, "a convolution other than the pre-net's (1-D, unpadded, by "
                                 "a constant filter, on channels-last input)")
    low = g.low
    (B, c_out, t_out), dtype = _meta(node)
    _, t_in, c_in = x.shape
    w = weight.value  # [c_out, c_in / groups, K]
    h = low.reshape(x, (B, t_in, 1, c_in), f"{node.name}_nhwc")
    b = (low.const(bias.value, bias.name) if bias is not None
         else low.const(torch.zeros(c_out)))
    geometry = dict(padding=1, stride_h=stride[0], stride_w=1, dilation_h_factor=dilation[0])
    if groups == c_in == c_out and w.shape[1] == 1:
        filt = low.const(w[:, 0, :].t().reshape(1, -1, 1, c_out), weight.name)
        y = low.op("DEPTHWISE_CONV_2D", [h.index, filt, b], (B, t_out, 1, c_out), dtype,
                   node.name, options("DepthwiseConv2DOptions", depth_multiplier=1, **geometry))
    elif groups == 1:
        filt = low.const(w.permute(0, 2, 1).unsqueeze(2), weight.name)
        y = low.op("CONV_2D", [h.index, filt, b], (B, t_out, 1, c_out), dtype, node.name,
                   options("Conv2DOptions", **geometry))
    else:
        raise _unsupported(node, f"groups={groups}")
    return low.reshape(y, (B, t_out, c_out), f"{node.name}_nwc", perm=(0, 2, 1))


def _normalize(g, x: Value, axes, eps: float, name: str) -> Value:
    """(x - mean) * rsqrt(var + eps) over ``axes`` of x's stored layout."""
    low = g.low
    mean = _reduce_mean(g, x, axes, f"{name}_mean")
    d = low.op("SUB", [x.index, mean.index], x.shape, x.dtype, f"{name}_centered",
               options("SubOptions"))
    sq = low.op("MUL", [d.index, d.index], x.shape, x.dtype, f"{name}_square",
                options("MulOptions"))
    var = _reduce_mean(g, sq, axes, f"{name}_var")
    var = low.op("ADD", [var.index, low.const(torch.tensor(eps, dtype=torch.float32))],
                 var.shape, x.dtype, f"{name}_var_eps", options("AddOptions"))
    rstd = low.op("RSQRT", [var.index], var.shape, x.dtype, f"{name}_rstd")
    return low.op("MUL", [d.index, rstd.index], x.shape, x.dtype, f"{name}_normed",
                  options("MulOptions"))


def _affine(g, y: Value, weight, bias, name: str) -> Value:
    """y * weight + bias, the constants along y's stored last axis."""
    for const, op, tag in ((weight, "MUL", "scaled"), (bias, "ADD", "shifted")):
        if const is not None:
            y = g.low.op(op, [y.index, g.low.const(const.value, const.name)], y.shape, y.dtype,
                         f"{name}_{tag}", options(op.title() + "Options"), perm=y.perm)
    return y


def _layer_norm(g, node, x, normalized_shape, weight, bias, eps):
    if len(normalized_shape) != 1:
        raise _unsupported(node, "a norm over more than the last axis")
    x = g.low.plain(x, node.name)
    y = _normalize(g, x, [len(x.shape) - 1], eps, node.name)
    return (_affine(g, y, weight, bias, node.name), None, None)


def _group_norm(g, node, x, weight, bias, N, C, HxW, group, eps):
    """GroupNorm of [N, C, T] stored [N, T, C] (the convolution's output)."""
    if not _channels_last(x):
        raise _unsupported(node, "a group norm of other than a channels-last [N, C, T]")
    n, t, c = x.shape
    grouped = g.low.reshape(x, (n, t, group, c // group), f"{node.name}_groups")
    y = _normalize(g, grouped, [1, 3], eps, node.name)
    y = g.low.reshape(y, (n, t, c), f"{node.name}_ungroup", perm=(0, 2, 1))
    return (_affine(g, y, weight, bias, node.name), None, None)


aten = torch.ops.aten
LOWER = {
    aten.add.Tensor: _binary("ADD"),
    aten.mul.Tensor: _binary("MUL"),
    aten.sin.default: _unary("SIN"),
    aten.cos.default: _unary("COS"),
    aten.rsqrt.default: _unary("RSQRT"),
    aten.sigmoid.default: _unary("LOGISTIC"),
    aten.gelu.default: _unary("GELU", _gelu_options),
    aten.clone.default: _identity,
    aten.view.default: _reshape,
    aten.unsqueeze.default: _reshape,
    aten._to_copy.default: _to_copy,
    aten.permute.default: _permute,
    aten.expand.default: _expand,
    aten.select.int: _select,
    aten.split_with_sizes.default: _split,
    aten.cat.default: _cat,
    aten.mm.default: _fully_connected,
    aten.addmm.default: _addmm,
    aten.bmm.default: _bmm,
    aten._softmax.default: _softmax,
    aten.mean.dim: _mean,
    aten.pow.Tensor_Scalar: _pow,
    aten.clamp.default: _clamp,
    aten.where.self: _where,
    aten.embedding.default: _embedding,
    aten.constant_pad_nd.default: _constant_pad,
    aten.convolution.default: _convolution,
    aten.native_layer_norm.default: _layer_norm,
    aten.native_group_norm.default: _group_norm,
}


def trace_decoder(cfg, decoder, batch: int, t_frames: int, s_tokens: int):
    """The decoder's denoise forward exported at one static shape, int32
    indices, decomposed to core ATen."""
    from .export import _DenoiseForward, _plain_cpu_copy

    module = _DenoiseForward(_plain_cpu_copy(cfg, decoder))
    args = (torch.zeros(batch, t_frames, cfg.n_mels),
            torch.zeros(batch, dtype=torch.int32),
            torch.zeros(batch, s_tokens, dtype=torch.int32),
            torch.zeros(batch, dtype=torch.int32))
    with torch.no_grad():
        return torch.export.export(module, args).run_decompositions()


def lower_decoder(cfg, decoder, batch: int = 1, t_frames: int = 200,
                  s_tokens: int = 100) -> Tuple[Table, Dict[str, int]]:
    """The decoder's forward at (batch, t_frames, s_tokens) as a TFLite
    ``Model`` table, and the tensor index of each weight or table it holds,
    by name (a weight's is its state-dict name)."""
    low = Lowering()
    inputs, output = _Graph(low).run(trace_decoder(cfg, decoder, batch, t_frames, s_tokens))
    model = low.model(inputs, output, "edge-diffusion-tts decoder (PyTorch port)")
    return model, dict(low.weights)
