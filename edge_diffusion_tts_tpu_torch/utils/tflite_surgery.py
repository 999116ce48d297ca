"""The TFLite flatbuffer in pure Python, and the surgery done on it
(counterpart of ``edge_diffusion_tts_tpu/utils/tflite_surgery.py``).

A TFLite model is a FlatBuffers buffer of the TFLite schema, version 3,
file identifier ``TFL3``.  This module holds its own description of the
tables the port reads and writes (``SCHEMA``: each field's name, slot, type
and default, taken from the schema) and a reader (``read_model``) and writer
(``write_model``) for them; it needs neither TensorFlow nor the
``flatbuffers`` package.  A table is a ``Table`` whose attributes are its
fields; vectors of scalars are numpy arrays, ``Buffer.data`` is ``bytes``.
The reader raises on a field or a union member the description lacks, so a
model it reads is a model it writes back whole.

The surgery:

- ``rewrite_weights_int8(tflite_bytes, qflat)``: the selective weight-only
  int8 of ``utils/quantize.py`` restored after a float export.  Each float32
  constant whose shape and bytes equal a dequantized ``q * scale`` (in either
  orientation) becomes an int8 tensor with per-channel quantization
  parameters feeding a ``DEQUANTIZE`` op, whose output is the original
  tensor, so the consumers are unchanged.  DEQUANTIZE computes ``q * scale``
  in float32, the same product the constant held: the outputs are the float
  artifact's bit for bit.  A buffer that several tensors share is never
  rewritten.  ``qflat`` may be the port's (``[out, in]`` codes, scales
  ``[out, 1]`` or ``[1, features]``) or the JAX package's (``[in, out]``
  codes, scales ``[out]``).
- ``quantize_dynamic_range(model)``: the TFLite converter's dynamic-range
  pass as it shows in the JAX package's ``dynamic`` artifact: the weights of
  FULLY_CONNECTED and CONV_2D with at least 1024 elements become symmetric
  int8, one scale per output channel, and those ops run their hybrid kernels
  (FULLY_CONNECTED version 12 with ``asymmetric_quantize_inputs``, CONV_2D
  version 5).  Depthwise filters, gather tables and the other constants
  stay float32, as they do there.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

FILE_IDENTIFIER = b"TFL3"
SCHEMA_VERSION = 3

# TensorType.
FLOAT32, FLOAT16, INT32, UINT8, INT64, STRING, BOOL, INT16, COMPLEX64, INT8 = range(10)
NUMPY_TYPE = {FLOAT32: np.float32, FLOAT16: np.float16, INT32: np.int32, UINT8: np.uint8,
              INT64: np.int64, BOOL: np.bool_, INT16: np.int16, INT8: np.int8}

# BuiltinOperator codes the port emits or finds in the JAX package's artifacts.
BUILTIN = dict(
    ADD=0, CONCATENATION=2, CONV_2D=3, DEPTHWISE_CONV_2D=4, DEQUANTIZE=6, FULLY_CONNECTED=9,
    LOGISTIC=14, MUL=18, RESHAPE=22, SOFTMAX=25, PAD=34, GATHER=36, TRANSPOSE=39, MEAN=40,
    SUB=41, DIV=42, EXP=47, CAST=53, MAXIMUM=55, MINIMUM=57, LESS=58, NEG=59,
    GREATER_EQUAL=62, LESS_EQUAL=63, SELECT=64, SLICE=65, SIN=66, SUM=74, RSQRT=76,
    LOGICAL_AND=86, ABS=101, GATHER_ND=107, COS=108, SELECT_V2=123, BATCH_MATMUL=126,
    PLACEHOLDER_FOR_GREATER_OP_CODES=127, BROADCAST_TO=130, REDUCE_ALL=140, GELU=150,
)
OP_NAME = {v: k for k, v in BUILTIN.items()}

# The BuiltinOptions union members of those operators: type id -> table.
BUILTIN_OPTIONS = {
    1: "Conv2DOptions", 2: "DepthwiseConv2DOptions", 8: "FullyConnectedOptions",
    9: "SoftmaxOptions", 10: "ConcatenationOptions", 11: "AddOptions", 17: "ReshapeOptions",
    21: "MulOptions", 22: "PadOptions", 23: "GatherOptions", 26: "TransposeOptions",
    27: "ReducerOptions", 28: "SubOptions", 29: "DivOptions", 33: "ExpOptions",
    37: "CastOptions", 38: "DequantizeOptions", 39: "MaximumMinimumOptions",
    41: "LessOptions", 42: "NegOptions", 45: "GreaterEqualOptions", 46: "LessEqualOptions",
    47: "SelectOptions", 48: "SliceOptions", 62: "LogicalAndOptions", 78: "AbsOptions",
    83: "GatherNdOptions", 84: "CosOptions", 98: "SelectV2Options", 101: "BatchMatMulOptions",
    104: "BroadcastToOptions", 116: "GeluOptions",
}
OPTIONS_TYPE = {v: k for k, v in BUILTIN_OPTIONS.items()}

# Scalar field types: struct format and size.
_SCALAR = {"b": 1, "B": 1, "?": 1, "h": 2, "H": 2, "i": 4, "I": 4, "q": 8, "Q": 8, "f": 4}
_NP = {"b": np.int8, "B": np.uint8, "?": np.bool_, "i": np.int32, "I": np.uint32,
       "q": np.int64, "Q": np.uint64, "f": np.float32}

# table -> fields (name, slot, type, default[, alignment of a vector's data]).
# Types: a scalar format of _SCALAR; "str"; "[x]" a vector of scalars x;
# "[Table]" a vector of tables; "Table"; "union:<type field>" a BuiltinOptions.
_EMPTY = ()
SCHEMA: Dict[str, tuple] = {
    "Model": (("version", 0, "I", 0), ("operator_codes", 1, "[OperatorCode]", None),
              ("subgraphs", 2, "[SubGraph]", None), ("description", 3, "str", None),
              ("buffers", 4, "[Buffer]", None), ("metadata_buffer", 5, "[i]", None),
              ("metadata", 6, "[Metadata]", None), ("signature_defs", 7, "[SignatureDef]", None)),
    "OperatorCode": (("deprecated_builtin_code", 0, "b", 0), ("custom_code", 1, "str", None),
                     ("version", 2, "i", 1), ("builtin_code", 3, "i", 0)),
    "SubGraph": (("tensors", 0, "[Tensor]", None), ("inputs", 1, "[i]", None),
                 ("outputs", 2, "[i]", None), ("operators", 3, "[Operator]", None),
                 ("name", 4, "str", None), ("debug_metadata_index", 5, "i", -1)),
    "Tensor": (("shape", 0, "[i]", None), ("type", 1, "b", 0), ("buffer", 2, "I", 0),
               ("name", 3, "str", None), ("quantization", 4, "QuantizationParameters", None),
               ("is_variable", 5, "?", False), ("shape_signature", 7, "[i]", None),
               ("has_rank", 8, "?", False)),
    "Buffer": (("data", 0, "[B]", None, 16), ("offset", 1, "Q", 0), ("size", 2, "Q", 0)),
    "Operator": (("opcode_index", 0, "I", 0), ("inputs", 1, "[i]", None),
                 ("outputs", 2, "[i]", None), ("builtin_options_type", 3, "B", 0),
                 ("builtin_options", 4, "union:builtin_options_type", None),
                 ("custom_options", 5, "[B]", None), ("custom_options_format", 6, "b", 0),
                 ("mutating_variable_inputs", 7, "[?]", None),
                 ("intermediates", 8, "[i]", None), ("debug_metadata_index", 13, "i", -1)),
    "QuantizationParameters": (("min", 0, "[f]", None), ("max", 1, "[f]", None),
                               ("scale", 2, "[f]", None), ("zero_point", 3, "[q]", None),
                               ("quantized_dimension", 6, "i", 0)),
    "Metadata": (("name", 0, "str", None), ("buffer", 1, "I", 0)),
    "SignatureDef": (("inputs", 0, "[TensorMap]", None), ("outputs", 1, "[TensorMap]", None),
                     ("signature_key", 2, "str", None), ("subgraph_index", 4, "I", 0)),
    "TensorMap": (("name", 0, "str", None), ("tensor_index", 1, "I", 0)),
    # BuiltinOptions members.
    "Conv2DOptions": (("padding", 0, "b", 0), ("stride_w", 1, "i", 0), ("stride_h", 2, "i", 0),
                      ("fused_activation_function", 3, "b", 0),
                      ("dilation_w_factor", 4, "i", 1), ("dilation_h_factor", 5, "i", 1),
                      ("quantized_bias_type", 6, "b", 0)),
    "DepthwiseConv2DOptions": (("padding", 0, "b", 0), ("stride_w", 1, "i", 0),
                               ("stride_h", 2, "i", 0), ("depth_multiplier", 3, "i", 0),
                               ("fused_activation_function", 4, "b", 0),
                               ("dilation_w_factor", 5, "i", 1),
                               ("dilation_h_factor", 6, "i", 1)),
    "FullyConnectedOptions": (("fused_activation_function", 0, "b", 0),
                              ("weights_format", 1, "b", 0), ("keep_num_dims", 2, "?", False),
                              ("asymmetric_quantize_inputs", 3, "?", False),
                              ("quantized_bias_type", 4, "b", 0)),
    "SoftmaxOptions": (("beta", 0, "f", 0.0),),
    "ConcatenationOptions": (("axis", 0, "i", 0), ("fused_activation_function", 1, "b", 0)),
    "AddOptions": (("fused_activation_function", 0, "b", 0), ("pot_scale_int16", 1, "?", True)),
    "ReshapeOptions": (("new_shape", 0, "[i]", None),),
    "MulOptions": (("fused_activation_function", 0, "b", 0),),
    "GatherOptions": (("axis", 0, "i", 0), ("batch_dims", 1, "i", 0)),
    "ReducerOptions": (("keep_dims", 0, "?", False),),
    "SubOptions": (("fused_activation_function", 0, "b", 0), ("pot_scale_int16", 1, "?", True)),
    "DivOptions": (("fused_activation_function", 0, "b", 0),),
    "CastOptions": (("in_data_type", 0, "b", 0), ("out_data_type", 1, "b", 0)),
    "BatchMatMulOptions": (("adj_x", 0, "?", False), ("adj_y", 1, "?", False),
                           ("asymmetric_quantize_inputs", 2, "?", False)),
    "GeluOptions": (("approximate", 0, "?", False),),
    **{name: _EMPTY for name in (
        "PadOptions", "TransposeOptions", "ExpOptions", "DequantizeOptions",
        "MaximumMinimumOptions", "LessOptions", "NegOptions", "GreaterEqualOptions",
        "LessEqualOptions", "SelectOptions", "SliceOptions", "LogicalAndOptions",
        "AbsOptions", "GatherNdOptions", "CosOptions", "SelectV2Options",
        "BroadcastToOptions")},
}


class Table:
    """One table of ``SCHEMA``: its fields are attributes, scalars at their
    defaults and the rest None until set."""

    def __init__(self, kind: str, **values):
        if kind not in SCHEMA:
            raise KeyError(f"table {kind!r} is not in the TFLite schema description")
        object.__setattr__(self, "kind", kind)
        for field in SCHEMA[kind]:
            object.__setattr__(self, field[0], field[3])
        for name, value in values.items():
            setattr(self, name, value)

    def __setattr__(self, name, value):
        if not any(f[0] == name for f in SCHEMA[self.kind]):
            raise AttributeError(f"{self.kind} has no field {name!r}")
        object.__setattr__(self, name, value)


def options(kind: str, **values) -> Tuple[int, Table]:
    """``(builtin_options_type, table)`` of a BuiltinOptions member."""
    return OPTIONS_TYPE[kind], Table(kind, **values)


# ---- reading ----------------------------------------------------------------------


def _u32(buf, pos):
    return struct.unpack_from("<I", buf, pos)[0]


def _read_table(buf, pos: int, kind: str) -> Table:
    obj = Table(kind)
    vt = pos - struct.unpack_from("<i", buf, pos)[0]
    vt_size = struct.unpack_from("<H", buf, vt)[0]
    by_slot = {f[1]: f for f in SCHEMA[kind]}
    present = {}
    for slot in range((vt_size - 4) // 2):
        off = struct.unpack_from("<H", buf, vt + 4 + 2 * slot)[0]
        if off == 0:
            continue
        if slot not in by_slot:
            raise ValueError(f"{kind}: field slot {slot} is set but not described here")
        present[slot] = pos + off
    unions = []
    for slot, p in present.items():
        name, _, ftype = by_slot[slot][:3]
        if ftype in _SCALAR:
            value = struct.unpack_from("<" + ftype, buf, p)[0]
        elif ftype.startswith("union:"):
            unions.append((name, ftype[6:], p + _u32(buf, p)))
            continue
        else:
            value = _read_value(buf, p + _u32(buf, p), ftype)
        object.__setattr__(obj, name, value)
    for name, type_field, target in unions:
        member = BUILTIN_OPTIONS.get(getattr(obj, type_field))
        if member is None:
            raise ValueError(f"{kind}.{name}: union member {getattr(obj, type_field)} is not "
                             "described here")
        object.__setattr__(obj, name, _read_table(buf, target, member))
    return obj


def _read_value(buf, pos: int, ftype: str):
    if ftype == "str":
        n = _u32(buf, pos)
        return bytes(buf[pos + 4:pos + 4 + n]).decode("utf-8")
    if ftype.startswith("["):
        inner, n = ftype[1:-1], _u32(buf, pos)
        if inner == "B":
            return bytes(buf[pos + 4:pos + 4 + n])
        if inner in _SCALAR:
            return np.frombuffer(buf, _NP[inner], n, pos + 4).copy()
        return [_read_table(buf, pos + 4 + 4 * i + _u32(buf, pos + 4 + 4 * i), inner)
                for i in range(n)]
    return _read_table(buf, pos, ftype)


def read_model(tflite_bytes: bytes) -> Table:
    """A ``.tflite`` buffer -> its ``Model`` table."""
    buf = bytes(tflite_bytes)
    if buf[4:8] != FILE_IDENTIFIER:
        raise ValueError(f"not a TFLite flatbuffer (identifier {buf[4:8]!r})")
    return _read_table(buf, _u32(buf, 0), "Model")


# ---- writing ----------------------------------------------------------------------


class _Writer:
    """Lays a table tree out front to back: a table, its vtable just before
    it, then its children, each reached by a forward offset."""

    def __init__(self):
        self.buf = bytearray(8)

    def _pad(self, align: int, extra: int = 0) -> None:
        self.buf += bytes(-(len(self.buf) + extra) % align)

    def table(self, obj: Table) -> int:
        scalars, refs = [], []
        for field in SCHEMA[obj.kind]:
            name, slot, ftype, default = field[:4]
            value = getattr(obj, name)
            if ftype in _SCALAR:
                if value is not None and value != default:
                    scalars.append((slot, ftype, value))
            elif value is not None:
                refs.append((slot, ftype, value, field[4] if len(field) > 4 else 4))
        layout, pos = {}, 4
        items = sorted(scalars, key=lambda s: -_SCALAR[s[1]]) + [(r[0], "I", None) for r in refs]
        for slot, fmt, _ in items:
            pos += -pos % _SCALAR[fmt]
            layout[slot] = pos
            pos += _SCALAR[fmt]
        n_slots = max(layout, default=-1) + 1
        self._pad(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, pos,
                                *(layout.get(s, 0) for s in range(n_slots)))
        self._pad(8 if any(_SCALAR[s[1]] == 8 for s in scalars) else 4)
        start = len(self.buf)
        self.buf += bytes(pos)
        struct.pack_into("<i", self.buf, start, start - vt)
        for slot, fmt, value in scalars:
            struct.pack_into("<" + fmt, self.buf, start + layout[slot], value)
        for slot, ftype, value, align in refs:
            if ftype.startswith("union:"):
                ftype = value.kind
            at = start + layout[slot]
            struct.pack_into("<I", self.buf, at, self.value(ftype, value, align) - at)
        return start

    def value(self, ftype: str, value, align: int = 4) -> int:
        if ftype == "str":
            data = value.encode("utf-8")
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return at
        if not ftype.startswith("["):
            return self.table(value)
        inner = ftype[1:-1]
        if inner in _SCALAR:
            data = (bytes(value) if inner == "B" and isinstance(value, (bytes, bytearray))
                    else np.ascontiguousarray(value, _NP[inner]).tobytes())
            self._pad(max(align, _SCALAR[inner], 4), extra=4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(data) // _SCALAR[inner]) + data
            return at
        self._pad(4)
        at = len(self.buf)
        self.buf += struct.pack("<I", len(value)) + bytes(4 * len(value))
        for i, item in enumerate(value):
            slot = at + 4 + 4 * i
            struct.pack_into("<I", self.buf, slot, self.table(item) - slot)
        return at


def write_model(model: Table) -> bytes:
    """A ``Model`` table -> ``.tflite`` bytes (constant data 16-byte aligned)."""
    w = _Writer()
    root = w.table(model)
    struct.pack_into("<I", w.buf, 0, root)
    w.buf[4:8] = FILE_IDENTIFIER
    return bytes(w.buf)


# ---- helpers over a model ---------------------------------------------------------


def opcode_of(model: Table, op: Table) -> int:
    oc = model.operator_codes[op.opcode_index]
    return max(oc.builtin_code, oc.deprecated_builtin_code)


def opcode_index(model: Table, code: int, version: int) -> int:
    """The index of ``code``'s OperatorCode, appended if missing; its version
    rises to ``version``."""
    for i, oc in enumerate(model.operator_codes):
        if max(oc.builtin_code, oc.deprecated_builtin_code) == code:
            oc.version = max(oc.version, version)
            return i
    model.operator_codes.append(Table(
        "OperatorCode", builtin_code=code, version=version,
        deprecated_builtin_code=min(code, BUILTIN["PLACEHOLDER_FOR_GREATER_OP_CODES"])))
    return len(model.operator_codes) - 1


def constant(model: Table, tensor: Table) -> Optional[np.ndarray]:
    """A tensor's constant value, or None for an activation."""
    data = model.buffers[tensor.buffer].data if tensor.buffer else None
    if data is None or tensor.type not in NUMPY_TYPE:
        return None
    shape = [] if tensor.shape is None else [int(d) for d in tensor.shape]
    return np.frombuffer(data, NUMPY_TYPE[tensor.type]).reshape(shape)


def _buffer_users(model: Table) -> Dict[int, int]:
    users: Dict[int, int] = {}
    for sg in model.subgraphs:
        for t in sg.tensors:
            users[t.buffer] = users.get(t.buffer, 0) + 1
    return users


def _per_channel(scale: np.ndarray, axis: int) -> Table:
    scale = np.asarray(scale, np.float32).ravel()
    return Table("QuantizationParameters", scale=scale, zero_point=np.zeros(scale.size, np.int64),
                 quantized_dimension=axis)


# ---- weight-only int8 --------------------------------------------------------------


def _orientations(q: np.ndarray, scale: np.ndarray):
    """The dequantized weight of one ``q8:`` entry in both orientations:
    ``[(w, q, per-channel scales, channel axis), (transposes)]``."""
    q = np.asarray(q, np.int8)
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 1:  # the JAX package's: [in, out] codes, one scale per column
        axis, w = 1, q.astype(np.float32) * scale[None, :]
    else:  # the port's: [out, 1] scales (a Linear) or [1, features] (an Embedding)
        axis = 0 if scale.shape[1] == 1 else 1
        w = q.astype(np.float32) * scale
    flat = scale.ravel()
    return [(w, q, flat, axis),
            (np.ascontiguousarray(w.T), np.ascontiguousarray(q.T), flat, 1 - axis)]


def rewrite_weights_int8(tflite_bytes: bytes, qflat: Dict[str, np.ndarray]
                         ) -> Tuple[bytes, dict]:
    """Rewrite the float32 constants that hold a dequantized weight as int8 +
    DEQUANTIZE.  Returns ``(bytes, report)``; the report lists the
    ``matched`` and ``unmatched`` weights and the bytes saved."""
    model = read_model(tflite_bytes)
    users = _buffer_users(model)
    want: Dict[tuple, list] = {}
    names = []
    for key, q in qflat.items():
        if not key.startswith("q8:"):
            continue
        name = key[3:]
        names.append(name)
        for w, qo, scale, axis in _orientations(q, qflat["sc:" + name]):
            want.setdefault((w.shape, w.tobytes()), []).append((name, qo, scale, axis))

    deq = None
    matched, saved = set(), 0
    for sg in model.subgraphs:
        new_ops = []
        for ti, t in enumerate(list(sg.tensors)):
            if t.type != FLOAT32 or users.get(t.buffer, 0) != 1:
                continue
            value = constant(model, t)
            if value is None or value.ndim != 2:
                continue
            hits = want.get((value.shape, value.tobytes()))
            if not hits:
                continue
            name, q, scale, axis = hits[0]
            matched.update(h[0] for h in hits)
            model.buffers.append(Table("Buffer", data=q.tobytes()))
            sg.tensors.append(Table(
                "Tensor", shape=np.asarray(q.shape, np.int32), type=INT8,
                buffer=len(model.buffers) - 1, name=f"{t.name or name}_int8",
                quantization=_per_channel(scale, axis), has_rank=True))
            saved += value.nbytes - q.nbytes - scale.nbytes
            # The float tensor becomes DEQUANTIZE's output; its bytes go.
            model.buffers[t.buffer].data = None
            t.buffer = 0
            if deq is None:
                deq = opcode_index(model, BUILTIN["DEQUANTIZE"], 2)
            new_ops.append(Table("Operator", opcode_index=deq,
                                 inputs=np.asarray([len(sg.tensors) - 1], np.int32),
                                 outputs=np.asarray([ti], np.int32)))
        # TFLite runs operators in order: the dequantizes go first.
        sg.operators = new_ops + list(sg.operators or [])
    out = write_model(model)
    return out, {
        "matched": sorted(matched),
        "unmatched": sorted(set(names) - matched),
        "bytes_saved": int(saved),
        "in_bytes": len(tflite_bytes),
        "out_bytes": len(out),
    }


# ---- the converter's dynamic-range pass ---------------------------------------------

# op -> the version of its hybrid kernel (float input, int8 weight input 1)
_HYBRID = {BUILTIN["FULLY_CONNECTED"]: 12, BUILTIN["CONV_2D"]: 5}
DYNAMIC_MIN_ELEMENTS = 1024  # the converter leaves smaller weights float32


def symmetric_per_channel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 codes in [-127, 127] and one float32 scale per output
    channel ``w[i]`` (max |w[i]| / 127; 1 for an all-zero channel)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)), keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.ravel()


def quantize_dynamic_range(model: Table) -> List[str]:
    """Make the FULLY_CONNECTED and CONV_2D weights of at least
    ``DYNAMIC_MIN_ELEMENTS`` elements int8 in place; returns their names."""
    users = _buffer_users(model)
    done = []
    for sg in model.subgraphs:
        quantized = set()
        for op in sg.operators:
            code = opcode_of(model, op)
            if code not in _HYBRID or len(op.inputs) < 2 or op.inputs[1] < 0:
                continue
            t = sg.tensors[op.inputs[1]]
            if int(op.inputs[1]) not in quantized:
                w = constant(model, t)
                if (t.type != FLOAT32 or w is None or w.size < DYNAMIC_MIN_ELEMENTS
                        or users.get(t.buffer, 0) != 1):
                    continue
                q, scale = symmetric_per_channel(w)
                model.buffers[t.buffer].data = q.tobytes()
                t.type = INT8
                t.quantization = _per_channel(scale, 0)
                quantized.add(int(op.inputs[1]))
                done.append(t.name)
            if code == BUILTIN["FULLY_CONNECTED"]:
                op.builtin_options.asymmetric_quantize_inputs = True
            oc = model.operator_codes[op.opcode_index]
            oc.version = max(oc.version, _HYBRID[code])
    return done
