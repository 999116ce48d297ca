"""The calibrated full-integer TFLite decoder: ``export_tflite(quantize="int8")``
(counterpart of the JAX package's converter mode, ``utils/export.py``).

Full integer where calibrated, float elsewhere, with the float32 inputs and
output of every mode.  The port builds the integer graph itself from the
float lowering (``utils/tflite_lower.py``); there is no converter:

- calibration: ``trace_decoder(..., split_norms=True)`` runs on each
  representative batch under a node-level interpreter (``calibrate``), in
  float64, which keeps every float node's running min and max; rounded to
  float32 they are the same on any machine, and so are the artifact's
  bytes.  The node map of ``lower_program`` carries a node's range to the
  TFLite tensor holding its value; the tests' simulation reads the
  artifact through the same map;
- activations: TFLite's rule for an asymmetric int8 tensor (``asymmetric``):
  the range widened to hold 0, scale (max - min) / 255, zero point
  round(-128 - min / scale) clamped to [-128, 127].  Ops that only move
  bytes (RESHAPE, TRANSPOSE, SLICE, PAD, GATHER's table, SELECT_V2's
  branches) share one set of parameters with their input; SOFTMAX and
  LOGISTIC output at 1/256 and -128, as their kernels fix;
- constants: the weights of FULLY_CONNECTED, CONV_2D and DEPTHWISE_CONV_2D
  symmetric int8, one scale per output channel (``symmetric_per_channel``),
  their biases int32 at s_in * s_w; every other float constant (tables,
  norm weights, scalars) int8 per tensor by the rule above;
- float: the timestep's sinusoid (its CAST, MUL, SIN and COS and the
  CONCATENATION of the two) and the int32 index arithmetic.  A QUANTIZE
  follows each float input and the sinusoid, a DEQUANTIZE makes
  ``prediction``;
- masked attention: entries at or below ``MASK_FILL`` (the logits a mask
  fills, -inf in effect) are left out of a tensor's range, and the range
  reaches low enough that a row's masked keys, each at the lowest code,
  weigh less than half an output quantum (1/512) of the row's largest key
  together;
- no silent abort: before anything is written, every requantizing op's
  effective multiplier is checked against what TFLite's integer kernels
  represent (``check_multipliers``); an unrepresentable one raises
  ValueError naming the op and its tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tflite_surgery import (
    FLOAT32, INT8, INT32, OP_NAME, BUILTIN, Table, constant, symmetric_per_channel,
)

MASK_FILL = -1e30  # a value at or below this is a masked logit
# A multiplier m is represented as q * 2**shift, q a 31-bit fraction in
# [0.5, 1): the kernels take shifts in [-31, 30] and flush anything smaller
# to 0.
MULTIPLIER_RANGE = (2.0 ** -32, 2.0 ** 30)
ADD_LEFT_SHIFT = 20  # int8 ADD/SUB scale their inputs up by 2**20 first

_FLOAT_OPS = {"SIN", "COS", "CAST"}
_SHARES = {"RESHAPE": (0,), "TRANSPOSE": (0,), "SLICE": (0,), "PAD": (0,), "GATHER": (0,),
           "SELECT_V2": (1, 2)}
_FIXED = {"SOFTMAX": (1.0 / 256.0, -128), "LOGISTIC": (1.0 / 256.0, -128)}
# Inputs whose zero point the int8 kernel takes as 0: BATCH_MATMUL's right
# side (its offset is dropped), so that side is quantized symmetric.
_SYMMETRIC = {"BATCH_MATMUL": (1,)}
_WEIGHT_AXIS = {"FULLY_CONNECTED": 0, "CONV_2D": 0, "DEPTHWISE_CONV_2D": 3}
# The version of each op's int8 kernel (a rank-dependent float version may
# be higher and then stands).
INT8_VERSION = dict(
    FULLY_CONNECTED=4, CONV_2D=3, DEPTHWISE_CONV_2D=3, BATCH_MATMUL=2, ADD=2, SUB=2, MUL=2,
    MEAN=2, RSQRT=2, GELU=2, SOFTMAX=2, LOGISTIC=2, GATHER=2, SELECT_V2=1, RESHAPE=1,
    TRANSPOSE=2, SLICE=2, PAD=2,
)


def asymmetric(lo: float, hi: float) -> Tuple[np.float32, int]:
    """(scale, zero point) of an int8 tensor over [lo, hi]: TFLite's rule,
    in float32 as the converter computes it."""
    lo, hi = np.float32(min(lo, 0.0)), np.float32(max(hi, 0.0))
    if float(hi) - float(lo) < np.finfo(np.float64).eps:  # all zeros: any scale holds them
        return np.float32(1.0), -128
    scale = np.float32(hi - lo) / np.float32(255.0)
    zero_point = np.float32(-128.0) - lo / scale
    return scale, int(np.clip(np.round(zero_point), -128, 127))


def symmetric(lo: float, hi: float) -> Tuple[np.float32, int]:
    """(scale, 0) of an int8 tensor over [lo, hi] with zero point 0."""
    amax = np.float32(max(abs(lo), abs(hi)))
    return (amax / np.float32(127.0), 0) if amax > 0 else (np.float32(1.0), 0)


def quantize_values(x, scale, zero_point: int) -> np.ndarray:
    """int8 codes of ``x`` at one (scale, zero point)."""
    q = np.round(np.asarray(x, np.float64) / np.float64(scale)) + zero_point
    return np.clip(q, -128, 127).astype(np.int8)


# ---- calibration ------------------------------------------------------------------


def _tensor_range(x: torch.Tensor) -> Optional[Tuple[float, float]]:
    """min and max of ``x`` without its masked entries; the min reaches down
    so that each row's masked keys weigh under 1/512 of its largest."""
    x = x.detach()
    lo, hi = (float(v) for v in torch.aminmax(x))
    if lo > MASK_FILL:
        return lo, hi
    kept = x > MASK_FILL
    if not bool(kept.any()):
        return None
    lo = float(x[kept].min())
    row_max = x.amax(-1)
    live = row_max > MASK_FILL
    margin = math.log(512.0 * float((~kept).sum(-1).max()))
    return min(lo, float(row_max[live].min()) - margin), hi


def as_float64(a):
    """A float32 tensor, or the dtype float32, as float64; else ``a``."""
    if a is torch.float32:
        return torch.float64
    return a.double() if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a


class _Calibrator(torch.fx.Interpreter):
    """Runs the program in float64, keeping each named node's range: the
    ranges rounded to float32 are the same on any machine."""

    def __init__(self, module, names):
        super().__init__(module)
        self.names = set(names)
        self.ranges: Dict[str, Tuple[float, float]] = {}

    def call_function(self, target, args, kwargs):
        args = torch.fx.node.map_aggregate(args, as_float64)
        kwargs = {k: as_float64(v) for k, v in kwargs.items()}
        return super().call_function(target, args, kwargs)

    def run_node(self, n):
        out = super().run_node(n)
        if (n.name in self.names and isinstance(out, torch.Tensor)
                and out.is_floating_point()):
            r = _tensor_range(out)
            if r is not None:
                lo, hi = self.ranges.get(n.name, r)
                self.ranges[n.name] = (min(lo, r[0]), max(hi, r[1]))
        return out


def program_args(program, batch) -> List[torch.Tensor]:
    """The flat arguments of ``program.graph_module`` for one
    ``(x_t, t, sem_idx, step_idx)`` batch: its weights and tables, then the
    batch as float32 and int32 tensors."""
    from torch.export.graph_signature import InputKind

    consts = {**program.state_dict, **program.constants}
    user = iter(torch.from_numpy(np.ascontiguousarray(a, dt))
                for a, dt in zip(batch, (np.float32, np.int32, np.int32, np.int32)))
    return [next(user) if s.kind == InputKind.USER_INPUT else consts[s.target]
            for s in program.graph_signature.input_specs]


def calibrate(program, batches, names) -> Dict[str, Tuple[float, float]]:
    """Each named node's float range over ``batches`` of (x_t, t, sem_idx,
    step_idx), the program run node by node."""
    interp = _Calibrator(program.graph_module, names)
    with torch.no_grad():
        for batch in batches:
            interp.run(*program_args(program, batch))
    return interp.ranges


# ---- the integer graph ---------------------------------------------------------------


def _per_tensor(scale, zero_point: int) -> Table:
    return Table("QuantizationParameters", scale=np.asarray([scale], np.float32),
                 zero_point=np.asarray([zero_point], np.int64))


def _per_channel(scale, axis: int) -> Table:
    scale = np.asarray(scale, np.float32).ravel()
    return Table("QuantizationParameters", scale=scale,
                 zero_point=np.zeros(scale.size, np.int64), quantized_dimension=axis)


class _Int8:
    """One rewrite of a float ``Lowering`` into the integer graph."""

    def __init__(self, low, ranges: Dict[int, Tuple[float, float]]):
        self.low, self.T, self.ranges = low, low.tensors, ranges
        self.parent: Dict[int, int] = {}
        self.merged: Dict[int, Tuple[float, float]] = {}
        self.fixed: Dict[int, Tuple[float, int]] = {}
        self.symmetric: set = set()
        self.twins: Dict[tuple, int] = {}
        self.new_ops: List[tuple] = []

    # -- tensors
    def is_const(self, i: int) -> bool:
        return self.T[i].buffer != 0

    def is_float(self, i: int) -> bool:
        return i >= 0 and self.T[i].type == FLOAT32

    def add(self, shape, ttype, name: str, quant: Table, data: Optional[bytes] = None) -> int:
        t = Table("Tensor", shape=np.asarray(shape, np.int32), type=ttype, name=name,
                  quantization=quant, has_rank=True)
        if data is not None:
            self.low.buffers.append(Table("Buffer", data=data))
            t.buffer = len(self.low.buffers) - 1
        self.T.append(t)
        return len(self.T) - 1

    # -- parameter classes
    def find(self, i: int) -> int:
        while self.parent.get(i, i) != i:
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        a, b = self.find(a), self.find(b)
        if a != b:
            self.parent[a] = b

    def own_range(self, i: int) -> Optional[Tuple[float, float]]:
        if not self.is_const(i):
            return self.ranges.get(i)
        v = constant(self.low, self.T[i])  # a Lowering has a model's ``buffers``
        v = v[v > MASK_FILL]
        return (float(v.min()), float(v.max())) if v.size else None

    def widen(self, i: int) -> None:
        r = self.own_range(i)
        if r is not None:
            root = self.find(i)
            lo, hi = self.merged.get(root, r)
            self.merged[root] = (min(lo, r[0]), max(hi, r[1]))

    def params(self, i: int) -> Tuple[np.float32, int]:
        root = self.find(i)
        if root in self.fixed:
            scale, zp = self.fixed[root]
            return np.float32(scale), zp
        if root not in self.merged:
            raise ValueError(f"int8 export: no calibrated range for tensor '{self.T[i].name}'")
        if root in self.symmetric:
            return symmetric(*self.merged[root])
        return asymmetric(*self.merged[root])

    # -- constants and seams
    def const_per_tensor(self, i: int) -> int:
        scale, zp = self.params(i)
        key = ("tensor", i, float(scale), zp)
        if key not in self.twins:
            value = constant(self.low, self.T[i])
            self.twins[key] = self.add(value.shape, INT8, self.T[i].name, _per_tensor(scale, zp),
                                       quantize_values(value, scale, zp).tobytes())
        return self.twins[key]

    def weight(self, i: int, axis: int) -> int:
        key = ("weight", i, axis)
        if key not in self.twins:
            w = constant(self.low, self.T[i])
            q, scale = symmetric_per_channel(np.moveaxis(w, axis, 0))
            q = np.ascontiguousarray(np.moveaxis(q, 0, axis))
            self.twins[key] = self.add(w.shape, INT8, self.T[i].name, _per_channel(scale, axis),
                                       q.tobytes())
        return self.twins[key]

    def bias(self, i: int, s_in, s_w: np.ndarray) -> int:
        scale = (np.float64(s_in) * s_w.astype(np.float64)).astype(np.float32)
        key = ("bias", i, scale.tobytes())
        if key not in self.twins:
            b = constant(self.low, self.T[i]).astype(np.float64)
            q = np.clip(np.round(b / scale.astype(np.float64)), -2 ** 31, 2 ** 31 - 1)
            self.twins[key] = self.add(b.shape, INT32, self.T[i].name, _per_channel(scale, 0),
                                       q.astype(np.int32).tobytes())
        return self.twins[key]

    def quantized(self, i: int) -> int:
        """The float activation ``i`` behind a QUANTIZE, made once."""
        key = ("quantize", i)
        if key not in self.twins:
            t, (scale, zp) = self.T[i], self.params(i)
            self.twins[key] = self.add(t.shape, INT8, f"{t.name}_int8", _per_tensor(scale, zp))
            self.new_ops.append((BUILTIN["QUANTIZE"], [i], self.twins[key], None, 1))
        return self.twins[key]


def _float_region(x: _Int8, ops) -> set:
    """The ops that stay float: the float ops, what feeds them, and a
    CONCATENATION of their outputs.  No int8 tensor feeds one of them."""
    producer = {op[2]: k for k, op in enumerate(ops)}

    def acts(k):
        return [i for i in ops[k][1] if x.is_float(i) and not x.is_const(i)]

    keep = {k for k, op in enumerate(ops) if OP_NAME[op[0]] in _FLOAT_OPS}
    grew = True
    while grew:
        grew = False
        for k, op in enumerate(ops):
            if k in keep:
                new = {producer[i] for i in acts(k) if i in producer} - keep
            elif (OP_NAME[op[0]] == "CONCATENATION" and acts(k)
                  and all(producer.get(i) in keep for i in acts(k))):
                new = {k}
            else:
                continue
            if new:
                keep |= new
                grew = True
    return keep


def quantize_lowering(low, inputs: Sequence[int], output: int, node_map: Dict[str, int],
                      node_ranges: Dict[str, Tuple[float, float]]
                      ) -> Tuple[List[int], int, Dict[str, int]]:
    """Rewrite the float ``low`` in place into the integer graph; returns its
    inputs, output and node map, remapped."""
    ranges: Dict[int, Tuple[float, float]] = {}
    for name, r in node_ranges.items():
        i = node_map[name]
        lo, hi = ranges.get(i, r)
        ranges[i] = (min(lo, r[0]), max(hi, r[1]))
    x = _Int8(low, ranges)
    ops = list(low.ops)
    keep = _float_region(x, ops)
    int8 = [k for k, op in enumerate(ops) if k not in keep and x.is_float(op[2])]
    for k in int8:
        name = OP_NAME[ops[k][0]]
        if name not in INT8_VERSION:
            raise NotImplementedError(f"int8 export: {name} ('{x.T[ops[k][2]].name}') has no "
                                      "integer lowering here")
    # Parameter classes, their ranges and fixed parameters.
    for k in int8:
        code, ins, out, _, _ = ops[k]
        for pos in _SHARES.get(OP_NAME[code], ()):
            if x.is_float(ins[pos]):
                x.union(ins[pos], out)
    for k in int8:
        code, ins, out, _, _ = ops[k]
        name = OP_NAME[code]
        for pos, i in enumerate(ins):
            if x.is_float(i) and not (name in _WEIGHT_AXIS and pos > 0):
                x.widen(i)
        x.widen(out)
        if name in _FIXED:
            x.fixed[x.find(out)] = _FIXED[name]
        x.symmetric |= {x.find(ins[pos]) for pos in _SYMMETRIC.get(name, ())}
    if x.symmetric & set(x.fixed):  # SOFTMAX's or LOGISTIC's output as a right side
        raise NotImplementedError("int8 export: a tensor whose kernel fixes its parameters "
                                  "feeds BATCH_MATMUL's right side")
    # The rewrite, in the float graph's order.
    int8 = set(int8)
    done = set()  # int8 op outputs
    for k, (code, ins, out, opts, version) in enumerate(ops):
        name = OP_NAME[code]
        if k not in int8:
            x.new_ops.append((code, ins, out, opts, version))
            continue
        new_ins = []
        for pos, i in enumerate(ins):
            if not x.is_float(i) or i in done:
                new_ins.append(i)
            elif not x.is_const(i):
                new_ins.append(x.quantized(i))
            elif name in _WEIGHT_AXIS and pos == 1:
                new_ins.append(x.weight(i, _WEIGHT_AXIS[name]))
            elif name in _WEIGHT_AXIS and pos == 2:
                s_w = x.T[new_ins[1]].quantization.scale
                new_ins.append(x.bias(i, x.T[new_ins[0]].quantization.scale[0], s_w))
            elif name == "BATCH_MATMUL":
                raise NotImplementedError(f"int8 export: BATCH_MATMUL ('{x.T[out].name}') by a "
                                          "constant has no integer lowering here")
            else:
                new_ins.append(x.const_per_tensor(i))
        scale, zp = x.params(out)
        x.T[out].type, x.T[out].quantization = INT8, _per_tensor(scale, zp)
        done.add(out)
        x.new_ops.append((code, new_ins, out, opts, max(version, INT8_VERSION[name])))
    # Float32 in, float32 out.
    node_map = {n: x.twins.get(("quantize", i), i) for n, i in node_map.items()}
    if output in done:
        t = x.T[output]
        result = x.add(t.shape, FLOAT32, t.name, None)
        t.name = f"{t.name}_int8"
        x.new_ops.append((BUILTIN["DEQUANTIZE"], [output], result, None, 2))
        output = result
    low.ops = x.new_ops
    check_multipliers(low)
    return _compact(low, list(inputs), output, node_map)


def _compact(low, inputs: List[int], output: int, node_map: Dict[str, int]):
    """Drop the tensors and buffers no op uses any more."""
    used = sorted({i for _, ins, out, _, _ in low.ops for i in list(ins) + [out] if i >= 0}
                  | set(inputs) | {output})
    remap = {old: new for new, old in enumerate(used)}
    buffers = [0] + sorted({low.tensors[i].buffer for i in used} - {0})
    bremap = {old: new for new, old in enumerate(buffers)}
    tensors = [low.tensors[i] for i in used]
    for t in tensors:
        t.buffer = bremap[t.buffer]
    low.tensors, low.buffers = tensors, [low.buffers[b] for b in buffers]
    low.ops = [(code, [remap[i] if i >= 0 else -1 for i in ins], remap[out], opts, version)
               for code, ins, out, opts, version in low.ops]
    return ([remap[i] for i in inputs], remap[output],
            {n: remap[i] for n, i in node_map.items() if i in remap})


# ---- the check against the integer kernels ------------------------------------------


def _multipliers(name: str, s_in: List[np.ndarray], s_out: float) -> List[Tuple[str, np.ndarray]]:
    """The effective multipliers of one int8 op: (what, values)."""
    if name in _WEIGHT_AXIS:
        return [("s_in*s_w/s_out", s_in[0][0] * s_in[1] / s_out)]
    if name in ("MUL", "BATCH_MATMUL"):
        return [("s_a*s_b/s_out", s_in[0] * s_in[1] / s_out)]
    if name in ("ADD", "SUB"):
        twice = 2.0 * max(float(s_in[0][0]), float(s_in[1][0]))
        return [("s_a/(2*max(s_a,s_b))", s_in[0] / twice),
                ("s_b/(2*max(s_a,s_b))", s_in[1] / twice),
                ("2*max(s_a,s_b)/(2**20*s_out)",
                 np.asarray([twice / (2.0 ** ADD_LEFT_SHIFT * s_out)]))]
    if name == "MEAN":
        return [("s_in/s_out", s_in[0] / s_out)]
    if name == "RSQRT":
        return [("1/(sqrt(s_in)*s_out)", 1.0 / (np.sqrt(s_in[0]) * s_out))]
    return []


def requantization_fault(name: str, s_in: List[np.ndarray], s_out: float) -> Optional[str]:
    """Why TFLite's integer ``name`` cannot take input scales ``s_in`` to
    output scale ``s_out``, or None.  ADD and SUB abort the interpreter
    when their output multiplier 2*max(s_a, s_b) / (2**20 * s_out), which
    they compute in float32, is not below 1 or is not finite; elsewhere a
    multiplier below 2**-32 is flushed to 0 and one of 2**30 or more is out
    of the shift's range."""
    for s in s_in + [np.asarray([s_out])]:
        if not np.all(np.isfinite(s) & (s >= np.finfo(np.float32).tiny)):
            return "a scale that is not a finite, normal float32"
    if name in ("ADD", "SUB"):
        shifted = np.float32(s_out) * np.float32(2.0 ** ADD_LEFT_SHIFT)
        twice = 2.0 * max(float(s_in[0][0]), float(s_in[1][0]))
        if not np.isfinite(shifted) or twice / float(shifted) >= 1.0:
            return ("an output multiplier 2*max(s_a,s_b)/(2**20*s_out) that is not a finite "
                    "float32 below 1: the kernel aborts the interpreter")
    lo, hi = MULTIPLIER_RANGE
    for what, m in _multipliers(name, s_in, s_out):
        m = np.asarray(m, np.float64)
        if np.any(m < lo) or not np.all(np.isfinite(m)):
            return f"{what} = {float(np.min(m)):.4g}, below 2**-32: the kernel flushes it to 0"
        if np.any(m >= hi):
            return f"{what} = {float(np.max(m)):.4g}, 2**30 or more: past the kernel's shifts"
    return None


def op_scales(tensors, ins: Sequence[int], out: int):
    """(quantized inputs, their scales, the output scale) of one op."""
    quantized = [i for i in ins if i >= 0 and tensors[i].quantization is not None
                 and tensors[i].quantization.scale is not None]
    return (quantized, [tensors[i].quantization.scale.astype(np.float64) for i in quantized],
            float(tensors[out].quantization.scale[0]))


def check_multipliers(low) -> None:
    """Raise ValueError naming the first int8 op of ``low`` whose scales
    TFLite's integer kernels cannot requantize between."""
    T = low.tensors
    for code, ins, out, _, _ in low.ops:
        name = OP_NAME[code]
        if T[out].type != INT8 or name == "QUANTIZE":
            continue
        quantized, s_in, s_out = op_scales(T, ins, out)
        fault = requantization_fault(name, s_in, s_out)
        if fault is not None:
            inputs = ", ".join(f"'{T[i].name}' scale {T[i].quantization.scale[0]:.4g}"
                               for i in quantized)
            raise ValueError(
                f"int8 export: {name} '{T[out].name}' (inputs {inputs}; output scale "
                f"{s_out:.4g}) cannot be requantized by TFLite's integer kernel: {fault}.  "
                "The calibrated ranges make this op unrepresentable; nothing was written")


# ---- the export -----------------------------------------------------------------------


def lower_decoder_int8(cfg, decoder, batch: int, t_frames: int, s_tokens: int, batches):
    """The decoder's forward as a calibrated full-integer TFLite ``Model``
    table; returns ``(model, node_map, program)``: the node map takes each
    node of ``program`` (``trace_decoder(..., split_norms=True)``) to the
    model's tensor holding its value."""
    from .tflite_lower import DESCRIPTION, lower_program, trace_decoder

    program = trace_decoder(cfg, decoder, batch, t_frames, s_tokens, split_norms=True)
    low, inputs, output, node_map = lower_program(program)
    node_ranges = calibrate(program, batches, node_map)
    inputs, output, node_map = quantize_lowering(low, inputs, output, node_map, node_ranges)
    return low.model(inputs, output, DESCRIPTION + ", full integer"), node_map, program
