"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, limit file and per-layer metric found by
name."""

import importlib.util
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
NUMBERS = {"predict": {"answer_gap", "matching_gap", "launch_gap"},
           "train": {"bootstrap_diff", "freq_l1", "oob_gap", "search_gap",
                     "launch_gap"}}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32
    assert all(one_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_bounds():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_configs_found_by_name():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = load(c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert one_line(c["source"]) and one_line(c["why"])
        assert "assumed" in cfg


def test_cells_found_by_name():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = load("portbench", "traffic", f"{w['traffic']}.json")
        assert mix["kind"] in NUMBERS
        limits = load("portbench", "limits", f"{w['name']}.json")
        assert set(limits) == NUMBERS[mix["kind"]]


def test_kinds_entries_and_launches_found_by_name():
    """Each mix's kind is a driver module of its own, its entry point an
    attribute of the program, its keyword arguments a dict, and each kernel
    whose launches it bounds a counter of the program."""
    import importlib

    import hibag_tpu_torch as ht

    from portbench import run

    for w in bench()["workloads"]:
        mix = load("portbench", "traffic", f"{w['traffic']}.json")
        mod = importlib.import_module(f"portbench.kinds.{mix['kind']}")
        assert mod.Driver.kind == mix["kind"]
        assert callable(getattr(ht, mix["entry"]))
        assert isinstance(mix.get("call", {}), dict)
        counts = run.launch_counts(mix.get("launches", {}))
        assert set(counts) == set(mix.get("launches", {}))
        for least, most in mix.get("launches", {}).values():
            assert least >= 0 and (most is None or most >= least)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_cell_reports_enough(kind):
    from portbench import run

    b = bench()
    for w in b["workloads"]:
        got = run.cell_metrics(b, w["name"], kind)
        if kind == "end_to_end":
            names = {m["name"] for m in got}
            assert "setup_s" in names and len(names) >= 2
        else:
            assert got
            e2e = {m["name"] for m in run.cell_metrics(b, w["name"],
                                                       "end_to_end")}
            assert all(m["moves"] in e2e for m in got)


def test_metric_readers_found_by_name():
    b = bench()
    layers = {}
    for m in b["per_layer"]:
        path = os.path.join(ROOT, "portbench", "metrics",
                            f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location("r", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read) and isinstance(mod.LAYERS, list)
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers
