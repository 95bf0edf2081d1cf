"""The benchmark's files: every cell, configuration and metric is found by
its name, every name and unit keeps to the contract's characters, and no
module of the benchmark loads JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
#: the JAX package's benchmark script, which no module may read
OLD_BENCH = "bench" + ".py"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], e
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"])


def test_every_cell_reports_what_its_layers_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_find_their_files(cell):
    c = harness.load_cell(cell, BENCH)
    entry = next(e for e in BENCH["configs"] if e["name"] == c.entry["config"])
    assert entry["file"].startswith("portbench/configs/")
    assert c.config["name"] == entry["name"]
    assert c.config["reduced"] == entry["reduced"]
    assert "state_mpix" in c.spec["limits"]
    assert set(c.spec["limits"]) <= {"state_mpix", "truth_mpix"}
    assert c.spec["pool_stacks"] >= 1


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(name):
    assert callable(harness.reader(name))


@pytest.mark.parametrize("name", [m["name"] for m in METRICS
                                  if m["name"].endswith("_roofline")])
def test_roofline_readers_carry_their_pattern_and_work(name):
    import importlib.util

    from portbench.trace import kernel
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    re.compile(mod.PATTERN)
    assert callable(mod.work)
    trace = dict(ops={"void deposit_tiles<1>(float*)": [2e-3, 4]})
    hit = name.startswith("drizzle_deposit")
    assert (kernel(trace, mod.PATTERN) is not None) == hit


def _modules():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops)
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call):
            for a in ast.walk(node):
                assert not (isinstance(a, ast.Constant)
                            and isinstance(a.value, str)
                            and a.value.endswith(OLD_BENCH)), path


#: (role, module) of each scene and reference a configuration names
NAMED = sorted({(k, json.load(open(os.path.join(ROOT, c["file"]))).get(k, k))
                for c in BENCH["configs"] for k in ("scene", "reference")})
#: what each role's module defines
ROLE = {"scene": ("make_pool",),
        "reference": ("Tan", "output_grid", "DEFAULTS", "align")}
#: every traffic file's name
TRAFFIC = sorted(f[:-len(".json")] for f in os.listdir(
    os.path.join(ROOT, "portbench", "traffic")) if f.endswith(".json"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_resolve_to_their_scene_program_and_reference(cell):
    from portbench import reference, scene
    from portbench.programs import align_images
    c = harness.load_cell(cell, BENCH)
    assert c.scene() is scene
    assert c.program() is align_images
    assert c.reference() is reference


@pytest.mark.parametrize("role,name", NAMED)
def test_named_scenes_and_references_exist(role, name):
    mod = harness.lookup("portbench", name)
    for attr in ROLE[role]:
        assert hasattr(mod, attr), (name, attr)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_traffic_files_program_exists(traffic):
    t = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                    traffic + ".json")))
    mod = harness.lookup("portbench.programs",
                         t.get("program", "align_images"))
    assert callable(mod.call)


def test_a_name_that_is_no_module_is_refused():
    with pytest.raises(ValueError):
        harness.lookup("portbench", "../scene")


@pytest.mark.parametrize("name", sorted({"reference", "check", "scene",
                                         "roofline", "trace", "fitsfile"}
                                        | {n for _, n in NAMED}))
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(
        os.path.join(ROOT, "portbench", name + ".py"))}
    assert "subpixal_tpu_torch" not in tops


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "subpixal_tpu_torch.probe",
                        types.ModuleType("probe"))
    assert "subpixal_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "subpixal_tpu.probe",
                        types.ModuleType("probe"))
    assert "subpixal_tpu" in harness.forbidden_modules()
