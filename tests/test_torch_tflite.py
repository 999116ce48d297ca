"""Port parity: the TFLite edge export (utils/export.py ``export_tflite``,
utils/tflite_lower.py, utils/tflite_surgery.py) against the JAX package's.

The JAX decoder (hidden 32, 1 layer, every parameter perturbed) is carried
across with the weight bridge; both sides export at (1, 20, 10), and a stock
``tf.lite.Interpreter`` runs every artifact on the same inputs.  The bar,
as in tests/test_inference.py: mean |diff| <= 1e-5 * max(max|ref|, 1) and
max |diff| <= 1e-4 * max(max|ref|, 1).  The flagship test repeats the float
check at configs/flagship.json, (1, 200, 100), and holds the artifacts'
bytes to JAX's: float <= 1.05x, weight_int8 no larger, dynamic within 5%.
TensorFlow is needed here only to run the artifacts and to build JAX's.
"""

import ast
import os
import sys

import jax
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.utils import export as jexport
from edge_diffusion_tts_tpu.utils import quantize as jquantize
from edge_diffusion_tts_tpu.utils import tflite_surgery as jsurgery
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.utils import tflite_surgery as ts
from edge_diffusion_tts_tpu_torch.utils.export import (
    export_tflite, load_tflite, synthetic_representative_batches,
)
from edge_diffusion_tts_tpu_torch.utils.quantize import (
    dequantize_decoder_params, quantize_decoder_params,
)
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax
from test_torch_orbax_bridge import _jitter

tf = pytest.importorskip("tensorflow")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(hidden=32, layers=1, heads=2, dropout=0.0, attn_window_size=8)
SHAPE = (1, 20, 10)
FLAGSHIP_SHAPE = (1, 200, 100)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small calls here are launch-bound, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(jcfg):
    jdec = JDecoder(jcfg)
    params = _jitter(jax.jit(
        lambda: init_decoder_params(jdec, jax.random.PRNGKey(0), jcfg)["params"])(), 5)
    cfg = PCFG.from_json(jcfg.to_json())
    pdec = PDecoder(cfg)
    pdec.load_state_dict(state_dict_from_jax(params, cfg))
    return jcfg, jdec, params, cfg, pdec.eval()


def _inputs(cfg, shape, seed=0):
    B, T, S = shape
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, cfg.n_mels).astype(np.float32),
            rs.randint(0, cfg.diff_steps, B).astype(np.int32),
            rs.randint(0, cfg.effective_codebook_size(), (B, S)).astype(np.int32),
            rs.randint(0, 20, B).astype(np.int32))


def _eager(decoder, inputs):
    x, t, s, st = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        return decoder(x, t, sem_idx=s, step_idx=st).numpy()


def _within_bar(got, ref):
    scale = max(float(np.abs(ref).max()), 1.0)
    diff = np.abs(got - ref)
    assert got.shape == ref.shape
    assert diff.mean() <= 1e-5 * scale, (diff.mean(), scale)
    assert diff.max() <= 1e-4 * scale, (diff.max(), scale)


def _run(blob, inputs):
    """The interpreter's output for ``blob`` on inputs bound by name."""
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    index = {d["name"]: d["index"] for d in interp.get_input_details()}
    for name, value in zip(("x_t", "t", "sem_idx", "step_idx"), inputs):
        interp.set_tensor(index[name], value)
    interp.invoke()
    return interp.get_tensor(interp.get_output_details()[0]["index"])


def _port(cfg, dec, path, shape=SHAPE, quantize=""):
    export_tflite(cfg, dec, str(path), *shape, quantize=quantize)
    with open(path, "rb") as f:
        return f.read()


def _jax(jcfg, jdec, params, path, shape=SHAPE, quantize=""):
    jexport.export_tflite(jcfg, jdec, params, str(path), *shape, quantize=quantize)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tflite")
    out = {}
    for dw in (True, False):
        jcfg, jdec, params, cfg, pdec = _models(JCFG(**SMALL, use_depthwise=dw))
        out[dw] = dict(jcfg=jcfg, jdec=jdec, params=params, cfg=cfg, pdec=pdec,
                       port=_port(cfg, pdec, tmp / f"port_{dw}.tflite"),
                       jax=_jax(jcfg, jdec, params, tmp / f"jax_{dw}.tflite"))
    m = out[True]
    m["tmp"] = tmp
    for mode in ("weight_int8", "dynamic"):
        m[f"port_{mode}"] = _port(m["cfg"], m["pdec"], tmp / f"port_{mode}.tflite",
                                  quantize=mode)
        m[f"jax_{mode}"] = _jax(m["jcfg"], m["jdec"], m["params"], tmp / f"jax_{mode}.tflite",
                                quantize=mode)
    m["port_int8"] = _port(m["cfg"], m["pdec"], tmp / "port_int8.tflite", quantize="int8")
    # JAX's float artifact of the dequantized weights, and JAX's qflat.
    m["jqflat"] = jquantize.quantize_decoder_params(m["params"])
    m["jax_deq"] = _jax(m["jcfg"], m["jdec"],
                        jax.tree.map(np.asarray,
                                     jquantize.dequantize_decoder_params(m["jqflat"])),
                        tmp / "jax_deq.tflite")
    m["inputs"] = _inputs(m["cfg"], SHAPE)
    return out


# ---- (a), (b), (k): the float artifact ----------------------------------------------


@pytest.mark.parametrize("dw", [True, False], ids=["depthwise", "no_depthwise"])
def test_float_artifact_equals_eager_and_jax(tiny, dw):
    m = tiny[dw]
    inputs = _inputs(m["cfg"], SHAPE, seed=1)
    got = _run(m["port"], inputs)
    _within_bar(got, _eager(m["pdec"], inputs))
    _within_bar(got, _run(m["jax"], inputs))
    ops = {ts.OP_NAME[ts.opcode_of(mdl, op)] for mdl in [ts.read_model(m["port"])]
           for op in mdl.subgraphs[0].operators}
    # The pre-net is a depthwise conv and a pointwise one, as in JAX's artifact.
    assert ({"DEPTHWISE_CONV_2D", "CONV_2D"} <= ops) == dw
    assert "GELU" in ops and "FULLY_CONNECTED" in ops


def test_float_artifact_at_batch_two_equals_eager(tiny, tmp_path):
    m = tiny[True]
    blob = _port(m["cfg"], m["pdec"], tmp_path / "b2.tflite", shape=(2, 24, 12))
    inputs = _inputs(m["cfg"], (2, 24, 12), seed=2)
    _within_bar(_run(blob, inputs), _eager(m["pdec"], inputs))


def test_signature_and_metadata(tiny):
    model = ts.read_model(tiny[True]["port"])
    sg = model.subgraphs[0]
    assert model.version == 3 and len(model.subgraphs) == 1
    names = [sg.tensors[i].name for i in sg.inputs]
    assert names == ["x_t", "t", "sem_idx", "step_idx"]
    assert [sg.tensors[i].type for i in sg.inputs] == [ts.FLOAT32, ts.INT32, ts.INT32, ts.INT32]
    assert sg.tensors[sg.outputs[0]].name == "prediction"
    (sig,) = model.signature_defs
    assert sig.signature_key == "serving_default"
    assert [t.name for t in sig.inputs] == names
    for oc in model.operator_codes:  # codes >= 127 carry the placeholder
        assert oc.deprecated_builtin_code == min(oc.builtin_code, 127)
    # The positional tables went in sliced to T and S.
    shapes = {t.name: tuple(t.shape) for t in sg.tensors}
    assert shapes["pos_emb.table:slice_2"] == (1, 20, 32)


def test_constant_data_is_16_byte_aligned(tiny):
    blob = tiny[True]["port"]
    model = ts.read_model(blob)
    # Locate each buffer's vector through the reader's own offsets.
    import struct

    root = struct.unpack_from("<I", blob, 0)[0]
    vt = root - struct.unpack_from("<i", blob, root)[0]
    off = struct.unpack_from("<H", blob, vt + 4 + 2 * 4)[0]  # Model.buffers, slot 4
    vec = root + off + struct.unpack_from("<I", blob, root + off)[0]
    n = struct.unpack_from("<I", blob, vec)[0]
    assert n == len(model.buffers)
    seen = 0
    for i in range(n):
        at = vec + 4 + 4 * i
        table = at + struct.unpack_from("<I", blob, at)[0]
        tvt = table - struct.unpack_from("<i", blob, table)[0]
        if struct.unpack_from("<H", blob, tvt)[0] <= 4:
            continue
        doff = struct.unpack_from("<H", blob, tvt + 4)[0]
        if doff:
            data = table + doff + struct.unpack_from("<I", blob, table + doff)[0]
            assert (data + 4) % 16 == 0
            seen += 1
    assert seen > 10


# ---- (c), (d): weight_int8 ------------------------------------------------------------


def test_weight_int8_equals_dequantized_eager_and_jax(tiny):
    m = tiny[True]
    deq = PDecoder(m["cfg"])
    deq.load_state_dict(dequantize_decoder_params(quantize_decoder_params(m["pdec"])))
    got = _run(m["port_weight_int8"], m["inputs"])
    _within_bar(got, _eager(deq.eval(), m["inputs"]))
    _within_bar(got, _run(m["jax_weight_int8"], m["inputs"]))
    # Every q8 weight the graph uses is stored int8 (sem_proj is not in it).
    qflat = quantize_decoder_params(m["pdec"])
    model = ts.read_model(m["port_weight_int8"])
    int8 = {t.name for t in model.subgraphs[0].tensors if t.type == ts.INT8}
    want = {k[3:] + "_int8" for k in qflat if k.startswith("q8:")} - {"sem_proj.weight_int8"}
    assert int8 == want
    assert len(m["port_weight_int8"]) < 0.6 * len(m["port"])


def test_rewrite_of_jax_float_artifact_matches_jax_rewrite(tiny):
    m = tiny[True]
    ours, report = ts.rewrite_weights_int8(m["jax_deq"], m["jqflat"])
    theirs, jreport = jsurgery.rewrite_weights_int8(m["jax_deq"], m["jqflat"])
    assert set(jreport["matched"]) <= set(report["matched"])
    assert set(report["matched"]) | set(report["unmatched"]) == {
        k[3:] for k in m["jqflat"] if k.startswith("q8:")}
    assert report["bytes_saved"] >= jreport["bytes_saved"] > 0
    got = _run(ours, m["inputs"])
    _within_bar(got, _run(m["jax_weight_int8"], m["inputs"]))
    np.testing.assert_array_equal(got, _run(m["jax_deq"], m["inputs"]))


def test_rewrite_never_touches_a_shared_buffer(tiny):
    m = tiny[True]
    model = ts.read_model(m["port"])
    sg = model.subgraphs[0]
    qkv = next(i for i, t in enumerate(sg.tensors) if t.name == "layers.0.attn.qkv.weight")
    sg.tensors.append(ts.Table("Tensor", shape=sg.tensors[qkv].shape, type=ts.FLOAT32,
                               buffer=sg.tensors[qkv].buffer, name="alias"))
    blob, report = ts.rewrite_weights_int8(ts.write_model(model),
                                           quantize_decoder_params(m["pdec"]))
    assert "layers.0.attn.qkv.weight" in report["unmatched"]
    np.testing.assert_array_equal(_run(blob, m["inputs"]), _run(m["port"], m["inputs"]))


# ---- (e), (f): the reader and writer --------------------------------------------------


@pytest.mark.parametrize("which", ["jax", "jax_weight_int8", "jax_dynamic"])
def test_round_trip_of_jax_artifacts_runs_bit_equal(tiny, which):
    blob = tiny[True][which]
    again = ts.write_model(ts.read_model(blob))
    np.testing.assert_array_equal(_run(again, tiny[True]["inputs"]),
                                  _run(blob, tiny[True]["inputs"]))


@pytest.mark.parametrize("which", ["port", "port_weight_int8", "port_dynamic"])
def test_tf_schema_parses_port_artifacts(tiny, which):
    from tensorflow.lite.python import schema_py_generated as schema

    blob = tiny[True][which]
    assert ts.write_model(ts.read_model(blob)) == blob  # the writer is the reader's inverse
    theirs = schema.ModelT.InitFromPackedBuf(bytearray(blob), 0)
    ours = ts.read_model(blob)
    assert theirs.version == 3
    assert len(theirs.subgraphs[0].operators) == len(ours.subgraphs[0].operators)
    assert [t.name.decode() for t in theirs.subgraphs[0].tensors] == [
        t.name for t in ours.subgraphs[0].tensors]
    for a, b in zip(theirs.operatorCodes, ours.operator_codes):
        assert (a.builtinCode, a.deprecatedBuiltinCode, a.version) == (
            b.builtin_code, b.deprecated_builtin_code, b.version)


def test_reader_refuses_an_undescribed_union_member(tiny):
    model = ts.read_model(tiny[True]["port"])
    op = model.subgraphs[0].operators[0]
    op.builtin_options = ts.Table("AddOptions")
    op.builtin_options_type = 4  # LSHProjectionOptions: not described here
    with pytest.raises(ValueError, match="union member 4 is not described"):
        ts.read_model(ts.write_model(model))


def test_an_op_without_a_lowering_raises_naming_it():
    from edge_diffusion_tts_tpu_torch.utils import tflite_lower

    class Tanh(torch.nn.Module):
        def forward(self, x):
            return torch.tanh(x)

    program = torch.export.export(Tanh(), (torch.zeros(2, 3),)).run_decompositions()
    with pytest.raises(NotImplementedError, match="no TFLite lowering for aten.tanh"):
        tflite_lower._Graph(tflite_lower.Lowering()).run(program)


# ---- (g): dynamic ---------------------------------------------------------------------


def test_dynamic_equals_the_converters_pass(tiny):
    m = tiny[True]

    # The same weights int8, with the converter's codes and scales bit for bit.
    def int8(blob):
        model = ts.read_model(blob)
        return sorted((ts.constant(model, t).tobytes(), t.quantization.scale.tobytes(),
                       t.quantization.quantized_dimension)
                      for t in model.subgraphs[0].tensors if t.type == ts.INT8)

    assert int8(m["port_dynamic"]) == int8(m["jax_dynamic"])
    x = m["inputs"]
    ours = np.abs(_run(m["port_dynamic"], x) - _run(m["port"], x)).mean()
    theirs = np.abs(_run(m["jax_dynamic"], x) - _run(m["jax"], x)).mean()
    assert 0 < ours <= 1.5 * theirs, (ours, theirs)
    model = ts.read_model(m["port_dynamic"])
    versions = {ts.OP_NAME[oc.builtin_code]: oc.version for oc in model.operator_codes}
    assert versions["FULLY_CONNECTED"] == 12 and versions["CONV_2D"] == 5


# ---- (h), (i), (j); the int8 mode's own checks are in test_torch_tflite_int8.py ------


def test_representative_batches_equal_jax_and_int8_refused(tiny, tmp_path):
    """The synthetic batches are JAX's; "int8" refuses batches whose ranges
    TFLite's integer kernels cannot requantize (the mode itself is checked in
    test_torch_tflite_int8.py), and an unknown mode is refused."""
    m = tiny[True]
    ours = synthetic_representative_batches(m["cfg"], 2, 20, 10, n=5, seed=3)
    theirs = jexport.synthetic_representative_batches(m["jcfg"], 2, 20, 10, n=5, seed=3)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    huge = [(x * np.float32(1e30), t, s, st) for x, t, s, st in
            synthetic_representative_batches(m["cfg"], *SHAPE, n=2)]
    with pytest.raises(ValueError, match="unrepresentable"):
        export_tflite(m["cfg"], m["pdec"], str(tmp_path / "x.tflite"), *SHAPE, quantize="int8",
                      representative_batches=huge)
    with pytest.raises(ValueError, match="quantize"):
        export_tflite(m["cfg"], m["pdec"], str(tmp_path / "x.tflite"), quantize="fp16")
    assert not os.path.exists(tmp_path / "x.tflite")


@pytest.mark.parametrize("mode", ["", "weight_int8", "dynamic", "int8"])
def test_two_exports_are_byte_equal(tiny, tmp_path, mode):
    m = tiny[True]
    key = f"port_{mode}" if mode else "port"
    assert _port(m["cfg"], m["pdec"], tmp_path / "again.tflite", quantize=mode) == m[key]


def _renamed(blob, names, order=None):
    model = ts.read_model(blob)
    sg = model.subgraphs[0]
    for i, name in zip(sg.inputs, names):
        sg.tensors[i].name = name
    if order is not None:
        sg.inputs = sg.inputs[list(order)]
    model.signature_defs = None
    return ts.write_model(model)


def test_load_tflite_binds_by_name(tiny, tmp_path):
    m = tiny[True]
    want = _run(m["port"], m["inputs"])
    cases = {
        "plain": m["port"],
        "reordered": _renamed(m["port"], ["x_t", "t", "sem_idx", "step_idx"], (3, 1, 2, 0)),
        "prefixed": _renamed(m["port"], [f"serving_default_{n}:0" for n in
                                         ("x_t", "t", "sem_idx", "step_idx")], (1, 0, 3, 2)),
    }
    for name, blob in cases.items():
        path = tmp_path / f"{name}.tflite"
        path.write_bytes(blob)
        np.testing.assert_array_equal(load_tflite(str(path))(*m["inputs"]), want)
    ambiguous = tmp_path / "ambiguous.tflite"
    ambiguous.write_bytes(_renamed(m["port"], ["x_t", "t", "sem_idx", "a_t"]))
    with pytest.raises(ValueError, match="ambiguous"):
        load_tflite(str(ambiguous))(*m["inputs"])
    unknown = tmp_path / "unknown.tflite"
    unknown.write_bytes(_renamed(m["port"], ["a", "b", "c", "d"]))
    with pytest.raises(ValueError, match="cannot bind by name"):
        load_tflite(str(unknown))(*m["inputs"])


def test_load_tflite_without_tensorflow_raises(tiny, tmp_path, monkeypatch):
    path = tmp_path / "m.tflite"
    path.write_bytes(tiny[True]["port"])
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError):
        load_tflite(str(path))


def test_the_export_modules_import_neither_tensorflow_nor_flatbuffers():
    """TensorFlow is imported inside ``load_tflite`` only; ``flatbuffers``
    nowhere in the port."""
    pkg = os.path.join(ROOT, "edge_diffusion_tts_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not any(x.split(".")[0] == "flatbuffers" for x in mods), path
            for node in tree.body:  # module level
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not any(x.split(".")[0] == "tensorflow" for x in mods), path


# ---- (l): flagship width --------------------------------------------------------------


def test_flagship_artifacts(tmp_path):
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        jcfg = JCFG.from_json(f.read())
    jcfg.dropout = 0.0
    jcfg, jdec, params, cfg, pdec = _models(jcfg)
    assert cfg.use_depthwise
    sizes, blobs = {}, {}
    for mode in ("", "weight_int8", "dynamic"):
        blobs[mode] = _port(cfg, pdec, tmp_path / f"p{mode}.tflite", FLAGSHIP_SHAPE, mode)
        sizes[mode] = (len(blobs[mode]),
                       len(_jax(jcfg, jdec, params, tmp_path / f"j{mode}.tflite",
                                FLAGSHIP_SHAPE, mode)))
    inputs = _inputs(cfg, FLAGSHIP_SHAPE, seed=4)
    _within_bar(_run(blobs[""], inputs), _eager(pdec, inputs))
    assert sizes[""][0] <= 1.05 * sizes[""][1], sizes
    assert sizes["weight_int8"][0] <= sizes["weight_int8"][1], sizes
    assert abs(sizes["dynamic"][0] - sizes["dynamic"][1]) <= 0.05 * sizes["dynamic"][1], sizes
    # Every q8 weight of the graph is int8; only sem_proj (unused) is not in it.
    qflat = quantize_decoder_params(pdec)
    model = ts.read_model(blobs["weight_int8"])
    int8 = {t.name[:-5] for t in model.subgraphs[0].tensors if t.type == ts.INT8}
    assert {k[3:] for k in qflat if k.startswith("q8:")} - int8 <= {"sem_proj.weight"}


# ---- the report ---------------------------------------------------------------------


def report(out_dir: str) -> None:
    """Print, per weight set and mode at configs/flagship.json, (1, 200, 100),
    the port's and JAX's artifacts side by side: bytes, operators, int8
    tensors, and each interpreter output's error against the port's eager
    decoder (the dequantized one for weight_int8) and against JAX's
    artifact, as fractions of max(max|ref|, 1).  CPU numbers of this
    sandbox.  Run from the repo root:
    ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_tflite.py``."""
    import time

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "configs", "flagship.json")) as f:
        base = JCFG.from_json(f.read())
    base.dropout = 0.0
    for weights in ("fresh", "perturbed"):
        jcfg, jdec, params, cfg, pdec = _models(base)
        if weights == "fresh":  # the init as it is: zero heads and AdaLN projections
            params = jax.jit(lambda: init_decoder_params(
                jdec, jax.random.PRNGKey(0), jcfg)["params"])()
            pdec.load_state_dict(state_dict_from_jax(params, cfg))
        deq = PDecoder(cfg)
        deq.load_state_dict(dequantize_decoder_params(quantize_decoder_params(pdec)))
        inputs = _inputs(cfg, FLAGSHIP_SHAPE, seed=4)
        for mode in ("", "weight_int8", "dynamic"):
            t0 = time.perf_counter()
            ours = _port(cfg, pdec, os.path.join(out_dir, f"p_{weights}{mode}.tflite"),
                         FLAGSHIP_SHAPE, mode)
            secs = time.perf_counter() - t0
            theirs = _jax(jcfg, jdec, params, os.path.join(out_dir, f"j_{weights}{mode}.tflite"),
                          FLAGSHIP_SHAPE, mode)
            ref = _eager(deq.eval() if mode == "weight_int8" else pdec, inputs)
            got, jgot = _run(ours, inputs), _run(theirs, inputs)
            scale = max(float(np.abs(ref).max()), 1.0)
            row = []
            for name, blob in (("port", ours), ("jax", theirs)):
                sg = ts.read_model(blob).subgraphs[0]
                row.append(f"{name} {len(blob)} B, {len(sg.operators)} ops, "
                           f"{sum(t.type == ts.INT8 for t in sg.tensors)} int8")
            print(f"{weights} {mode or 'float'}: {'; '.join(row)}; port export {secs:.2f} s; "
                  f"port-eager max {np.abs(got - ref).max() / scale:.3g} mean "
                  f"{np.abs(got - ref).mean() / scale:.3g}; jax-eager mean "
                  f"{np.abs(jgot - ref).mean() / scale:.3g}; port-jax max "
                  f"{np.abs(got - jgot).max() / scale:.3g} mean "
                  f"{np.abs(got - jgot).mean() / scale:.3g}")


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        report(d)
