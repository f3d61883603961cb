"""A run of the harness on the CPU at a tiny size: the last line's keys,
the exits without a card or without the program, and a card-only run of
every cell (marked gpu; it skips here)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import tiny

ROOT = run.ROOT


@pytest.mark.parametrize("cell,mix", [("hla_a-predict", tiny.PREDICT),
                                      ("hla_a-train", tiny.TRAIN)])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(cell, mix, trace):
    bench = run.load_json("BENCHMARK.json")
    r = run.run_cell(bench, cell, 2**31 + 12345, 0.3, trace, device="cpu",
                     cfg=tiny.CFG, mix=mix, log=lambda *a: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        # off the card no device metric is written
        assert not any(k.endswith(("roofline", "mfu", "idle"))
                       for k in r["metrics"])
    else:
        # off the card the metrics taken from the device's trace are left out
        names = {m["name"] for m in run.cell_metrics(bench, cell,
                                                     "end_to_end")
                 if m["source"] != "device_trace"}
        assert set(r["metrics"]) == names
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "hla_a-predict", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import run\n"
            "from portbench.tests import tiny\n"
            "import json\n"
            "b = run.load_json('BENCHMARK.json')\n"
            "print(json.dumps(run.run_cell(b, 'hla_a-predict', 1, 0.1, 0,"
            " device='cpu', cfg=tiny.CFG, mix=tiny.PREDICT)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in run.load_json(
    "BENCHMARK.json")["workloads"]])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
