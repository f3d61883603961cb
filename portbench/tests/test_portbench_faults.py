"""`correct` comes out false when the timed path is broken underneath (each
fault of portbench/faults.py the cell's kind can have), and for the
control (the reference in bfloat16 in the program's place), on the CPU at
a tiny size, held to the cells' own limits."""

import json

import pytest
import torch

from portbench import faults, run
from portbench.tests import tiny

CELLS = {"predict": ("hla_a-predict", tiny.PREDICT),
         "train": ("hla_a-train", tiny.TRAIN)}


def one(kind, seed, cfg=tiny.CFG, **kw):
    cell, mix = CELLS[kind]
    bench = run.load_json("BENCHMARK.json")
    return run.run_cell(bench, cell, seed, 0.0, 0, device="cpu", cfg=cfg,
                        mix=mix, log=lambda *a: None, **kw)


@pytest.mark.parametrize("kind,name", [(k, n) for k in ("predict", "train")
                                       for n in getattr(faults, k.upper())])
def test_fault_is_not_correct(kind, name):
    r = one(kind, 2**31 + 3, program=faults.KINDS[kind](name))
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 123456789])
def test_predict_control_is_not_correct(seed):
    r = one("predict", seed, control_dtype=torch.bfloat16)
    assert r["correct"] is False, r["checks"]


def test_train_control_is_not_correct():
    """One seed: a training cell's seed only orders its fixed batches."""
    cfg = json.loads(json.dumps(tiny.CFG))
    cfg["panel"].update(tiny.CONTROL_PANEL)
    r = one("train", 2**31 + 5, control_dtype=torch.bfloat16, cfg=cfg)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("kind", ["predict", "train"])
def test_program_is_correct(kind):
    assert one(kind, 2**31 + 3)["correct"] is True
