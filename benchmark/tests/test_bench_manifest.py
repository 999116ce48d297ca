"""BENCHMARK.json against the contract it is written to, and every name in it
found as a file, with a cell added in a copy found with no other edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest()


def test_top_level_keys_and_sizes(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(d["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
                                              for p in d["paths"])
    assert len(d["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                               for w in d["command"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_entries_have_just_their_keys(manifest):
    d = manifest.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in manifest.configs
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    names = [x["name"] for x in d["configs"] + d["workloads"] + d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    for x in d["configs"] + d["workloads"] + d["end_to_end"] + d["per_layer"]:
        assert NAME.match(x["name"]), x["name"]
        for k in ("why", "layer", "source"):
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] and "\t" not in x[k]
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in d["end_to_end"])


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    for name in manifest.cells:
        e2e = {m["name"] for m in manifest.end_to_end(name)}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        layers = manifest.per_layer(name)
        assert layers, name
        assert all(m["moves"] in e2e for m in layers), name


def test_every_name_finds_its_files(manifest):
    for name, w in manifest.cells.items():
        assert manifest.traffic(w["traffic"])["driver"]
        assert manifest.limits(name)
        manifest.driver(manifest.traffic(w["traffic"])["driver"])
    for m in manifest.data["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for c in manifest.data["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in manifest.data["paths"]))


def test_configuration_files_hold_the_shipped_configs(manifest):
    """Every key of the shipped file is in the benchmark's copy with its value
    (nothing reduced), beside the HuBERT-base widths."""
    for c in manifest.data["configs"]:
        mine = manifest.config(c["name"])
        with open(ROOT / mine["shipped_as"]) as f:
            shipped = json.load(f)
        changed = [k for k, v in shipped.items() if mine.get(k) != v]
        assert changed == c["reduced"] == [], (c["name"], changed)
        assert mine["hubert"]["hidden_size"] == 768 and mine["hubert"]["conv_dim"] == [512] * 7


def test_a_cell_added_as_files_is_found_with_no_other_edit(tmp_path, manifest):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "synth-tokens-b8.flagship", "config": "flagship",
                           "traffic": "synth-tokens-b8", "chips": 1, "why": "a later cell"})
    for m in d["end_to_end"] + d["per_layer"]:
        if "synth-tokens.flagship" in m.get("workloads", []):  # per-layer entries all list
            m["workloads"].append("synth-tokens-b8.flagship")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    tr = json.loads((ROOT / "benchmark/traffic/synth-tokens.json").read_text())
    (tmp_path / "benchmark/traffic/synth-tokens-b8.json").write_text(json.dumps(dict(tr, rows=8)))
    (tmp_path / "benchmark/limits/synth-tokens-b8.flagship.json").write_text(
        (ROOT / "benchmark/limits/synth-tokens.flagship.json").read_text())
    m = Manifest(tmp_path)
    cell = m.cell("synth-tokens-b8.flagship")
    assert m.traffic(cell["traffic"])["rows"] == 8
    assert m.limits("synth-tokens-b8.flagship") == manifest.limits("synth-tokens.flagship")
    assert {x["name"] for x in m.per_layer("synth-tokens-b8.flagship")} == \
        {x["name"] for x in manifest.per_layer("synth-tokens.flagship")}
    assert m.config(cell["config"]) == manifest.config("flagship")
