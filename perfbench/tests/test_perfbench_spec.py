"""The benchmark's files as data: ``BENCHMARK.json`` within its contract,
every cell's configuration, traffic mix, limits and metric readers found
by name, and no module of the benchmark importing JAX or the JAX package
(the reference not even the program). The checks of a cell's files read
them through the cell's model family, and run over the tests' tiny
decoder-only cell too (``tiny.py``), so a configuration of that family
joins with its files and entries alone."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness, traffic, weights
from perfbench.reference import synthetic
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
# the benchmark's entries and the tiny decoder-only cell's, with the
# directory that holds each cell's traffic and limits
CONFIGS = BENCH["configs"] + [tiny.DECODER_CONFIG]
WORKLOADS = BENCH["workloads"] + [tiny.DECODER_WORKLOAD]
FILES = {**{w["name"]: ROOT / "perfbench" for w in BENCH["workloads"]},
         tiny.DECODER: tiny.FILES}


def _cell(workload: str) -> harness.Cell:
    return (tiny.decoder_cell() if workload == tiny.DECODER
            else harness.load_cell(workload))


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", CONFIGS + WORKLOADS + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key]), key
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in WORKLOADS])
def test_cell_loads(workload):
    cell = _cell(workload)
    cfg = harness.family_module(cell.family).model_cfg(cell.config)
    assert cfg["vocab_size"] >= synthetic.tokenizer().vocab_size
    assert cell.limits["kind"] in ("greedy", "beam")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    w = {x["name"]: x for x in WORKLOADS}[workload]
    assert w["chips"] == 1
    assert set(w) == {"name", "config", "traffic", "chips", "why"}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    mod = harness.metric_module(metric["name"])
    assert callable(mod.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    for cell in metric.get("workloads", CELLS):
        e2e = {m["name"] for m in harness.load_cell(cell).end_to_end}
        assert metric["moves"] in e2e, (metric["name"], cell)


@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: c["name"])
def test_configuration_files(conf):
    """Each configuration builds the program's ``ModelConfig`` and its
    reference's view through its family: the seq2seq family's from the
    file's top level, with a cache key for its trained weights; the
    decoder-only family's from its ``model`` object, under a reference
    that covers it."""
    path = ROOT / conf["file"]
    assert path.is_relative_to(ROOT / "perfbench")
    config = json.loads(path.read_text())
    assert config["name"] == conf["name"]
    assert conf["reduced"] == []
    family = harness.family_of(config)
    fam = harness.family_module(family)
    cfg = fam.model_cfg(config)
    assert fam.port_config(config).vocab_size == cfg["vocab_size"]
    assert config["precision"] == "float32" and config["tf32"] is False
    assert config["task"] in ("forward", "retro")
    if family == "seq2seq":
        assert set(cfg) <= set(config)
        assert len(weights.cache_key(path)) == 16
    else:
        fam.reference(cfg).check(cfg)


def test_traffic_files():
    """Every mix, by the family of each cell that runs it (a mix that no
    cell runs, by the default family's keys)."""
    families: dict = {}
    for w, conf in ((w, {c["name"]: c for c in CONFIGS}[w["config"]])
                    for w in WORKLOADS):
        config = json.loads((ROOT / conf["file"]).read_text())
        families.setdefault((FILES[w["name"]], w["traffic"]), set()).add(
            harness.family_of(config))
    for base in sorted(set(FILES.values())):
        for path in sorted((base / "traffic").glob("*.json")):
            mix = json.loads(path.read_text())
            for family in sorted(families.get((base, path.stem),
                                              {"seq2seq"})):
                traffic.validate(mix, path.stem, family)


def _modules():
    return sorted(p for p in (ROOT / "perfbench").rglob("*.py")
                  if ".cache" not in p.parts)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_pure_reference(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.parts:
        assert "repro_torch" not in tops, tops
    assert "benchmarks" not in tops


def test_import_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType(
        "repro_torch_extra"))
    assert "repro_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()
