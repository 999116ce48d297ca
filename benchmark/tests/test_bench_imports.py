"""What the harness loads, and what it refuses to run without.

Top-level module names are compared whole (the part before the first dot):
the port's name begins with the JAX package's, so a prefix test would be
wrong both ways."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness.manifest import ROOT
from benchmark.run import FORBIDDEN, loaded_forbidden

ENV = dict(os.environ, PYTHONPATH=str(ROOT))


def _loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh process."""
    prog = textwrap.dedent(code) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
    """)
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_ports_entries_load_no_jax():
    names = _loaded_after("""
        import benchmark.run, benchmark.calibrate
        from benchmark.harness import compare, manifest, runner, trace, traffic, weights
        from benchmark.drivers import synth, train
        import benchmark.counts.calls
        m = manifest.Manifest()
        for x in m.data["per_layer"]:
            m.reader(x["name"])
        import edge_diffusion_tts_tpu_torch.inference, edge_diffusion_tts_tpu_torch.training
        import edge_diffusion_tts_tpu_torch.ops.fused_denoise
    """)
    assert "edge_diffusion_tts_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded_after("""
        from benchmark.reference import decoder, hubert, precision, schedule, train
    """)
    assert "torch" in names
    assert not names & {"edge_diffusion_tts_tpu_torch", *FORBIDDEN}


def test_the_reference_sources_import_only_torch_numpy_and_themselves():
    import ast

    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {"." if node.level else node.module.split(".")[0]}
            else:
                continue
            assert tops <= {"torch", "numpy", "math", "typing", "__future__", "."}, (path, tops)


def test_a_whole_cpu_run_loads_no_jax():
    names = _loaded_after("""
        from benchmark.harness.runner import run_cell
        tiny = {"hidden": 32, "layers": 1, "heads": 2, "attn_window_size": 8}
        r = run_cell("synth-tokens.flagship", 2**31 + 3, 0.3, True, "cpu",
                     overrides={"config": tiny, "traffic": {
                         "rows": 2, "bucket_s": [0.2, 0.4], "block": 4,
                         "durations": {"min_s": 0.1, "mean_s": 0.25, "max_s": 0.4}}})
        assert r["attempted"] > 0
    """)
    assert not names & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "edge_diffusion_tts_tpu_torch_fake", types.ModuleType("x"))
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "edge_diffusion_tts_tpu.models", types.ModuleType("x"))
    assert loaded_forbidden() == ["edge_diffusion_tts_tpu"]


def test_without_a_card_or_the_port_the_run_prints_no_result(tmp_path):
    args = ["-m", "benchmark.run", "--workload", "synth-tokens.flagship", "--seed", "5",
            "--seconds", "1", "--trace", "0"]
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "benchmark", bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    for cwd in (ROOT, bare):
        out = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert out.stdout.strip() == ""
