"""The readers of the program's own records (work/records.py, the metrics
train.em_ms, em_estep.roofline, eval_cand.roofline and predict.host_ms) on
synthetic records and a synthetic context, and the frozen bounds of
work/train_bounds.py against chip_smoke.py's."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import run
from portbench.work import peaks, records, train_bounds

POPC = 4.0e12
READERS = ("train.em_ms", "em_estep.roofline", "eval_cand.roofline",
           "predict.host_ms")


class Fake:
    """A stand-in for the program's trace module."""

    def __init__(self, spans=(), launches=(), counters=()):
        self.snap = {"spans": list(spans), "launches": list(launches),
                     "counters": list(counters)}

    def snapshot(self):
        return self.snap


def span(i, name, t0, t1, parent=None, root=None, device_ms=None):
    """A span from t0 to t1 seconds."""
    return {"name": name, "id": i, "parent": parent, "root": root or i,
            "thread": 1, "t0_ns": int(t0 * 1e9), "t1_ns": int(t1 * 1e9),
            "host_ms": (t1 - t0) * 1e3, "device_ms": device_ms}


def launch(name, t0, device_ms, dims, counts=None):
    return {"name": name, "dims": dims, "counts": counts,
            "t0_ns": int(t0 * 1e9), "t1_ns": int((t0 + 1e-4) * 1e9),
            "device_ms": device_ms}


def ctx(popc_rate=POPC):
    """A window of two calls, from 10 s to 12 s."""
    return SimpleNamespace(calls=[(10.0, 11.0, 0, None),
                                  (11.0, 12.0, 1, None)],
                           popc_rate=popc_rate)


@pytest.fixture(scope="module")
def readers():
    return {name: run.load_metric(name) for name in READERS}


def read(readers, name, fake, c=None):
    r = readers[name]
    saved, r.TRACE = r.TRACE, fake
    try:
        return r.read(c or ctx())
    finally:
        r.TRACE = saved


EM = {"K": 8, "S": 1024, "H": 256, "C": 17, "tier": "int8"}
EV = {"K": 8, "N": 1024, "H": 256, "C": 17, "A": 14, "plan": 1}
EV_COUNTS = [[200] * 8, [3000] * 8, [900] * 8]


def test_readers_ignore_records_outside_the_window(readers):
    spans = [
        span(1, "train.step", 10.1, 10.5), span(2, "train.step", 10.5, 11),
        span(3, "train.em", 10.2, 10.4, 1, 1, device_ms=10.0),
        span(4, "train.match", 10.2, 10.3, 3, 1, device_ms=4.0),
        # after the window: a profiled stretch
        span(5, "train.step", 12.1, 12.5),
        span(6, "train.em", 12.2, 12.4, 5, 5, device_ms=100.0),
        span(7, "predict.call", 10.0, 10.010),
        span(8, "predict.align", 10.0, 10.003, 7, 7),
        span(9, "predict.fetch", 10.008, 10.010, 7, 7),
        span(10, "predict.call", 9.0, 9.5)]
    launches = [launch("em_estep", 10.3, 0.3, EM),
                launch("em_estep", 12.3, 99.0, EM),
                launch("evaluate_candidates_kernel", 10.45, 2.7, EV,
                       EV_COUNTS),
                launch("evaluate_candidates_kernel", 9.5, 99.0, EV,
                       EV_COUNTS)]
    fake = Fake(spans, launches)
    assert read(readers, "train.em_ms", fake) == pytest.approx(3.0)
    assert read(readers, "predict.host_ms", fake) == pytest.approx(5.0)
    em_s = train_bounds.em_bytes(8, 1024, 256, 17, False) \
        / peaks.MEM_BYTES_PER_S
    assert read(readers, "em_estep.roofline", fake) == pytest.approx(
        100 * em_s / 0.3e-3)
    w = train_bounds.eval_work(8, 1024, 256, 17, *EV_COUNTS)
    ev_s = peaks.least_seconds(w["bytes"], w["popc"], w["flops"], POPC)
    assert read(readers, "eval_cand.roofline", fake) == pytest.approx(
        100 * ev_s / 2.7e-3)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_records(readers, name):
    assert read(readers, name, Fake()) is None
    assert read(readers, name, None) is None
    # records, but none inside the window
    late = Fake([span(1, "train.step", 20, 21)],
                [launch("em_estep", 20, 0.3, EM)])
    assert read(readers, name, late) is None


@pytest.mark.parametrize("name", ["em_estep.roofline", "eval_cand.roofline",
                                  "train.em_ms"])
def test_readers_off_the_card(readers, name):
    """Without device times (the CPU) no device metric is read."""
    fake = Fake([span(1, "train.step", 10.1, 10.5),
                 span(2, "train.em", 10.2, 10.4, 1, 1)],
                [launch("em_estep", 10.3, None, EM),
                 launch("evaluate_candidates_kernel", 10.3, None, EV,
                        EV_COUNTS)])
    assert read(readers, name, fake, ctx(popc_rate=None)) is None


def test_records_on_the_program():
    """The program's own module: on once a reader's helper loads it, its
    spans inside the window kept and those after it left out."""
    trace = records.program_trace()
    assert trace is not None and trace.enabled()
    try:
        import time
        with trace.span("inside"):
            pass
        t1 = time.perf_counter()
        with trace.span("after"):
            pass
        c = SimpleNamespace(calls=[(t1 - 5.0, t1, 0, None)])
        got = records.in_window(c, trace)
        assert [s["name"] for s in got["spans"]] == ["inside"]
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("name", ["em_estep", "em_estep_packed",
                                  "evaluate_candidates_kernel"])
def test_bounds_match_chip_smoke(monkeypatch, name):
    """The frozen formulas give chip_smoke.py::_train_bound's bytes (and,
    for the evaluation, popcounts and float operations) on a _train_case
    input, the evaluation's counts taken by the program's eval_counts."""
    import chip_smoke
    from hibag_tpu_torch.ops import train_step as ts

    monkeypatch.setattr(chip_smoke, "_bound",
                        lambda nbytes, popc=0.0, flops=0.0: (nbytes, popc,
                                                             flops))
    K, C, H, A, S = 2, 5, 64, 6, 24
    c = chip_smoke._train_case(np.random.default_rng(3), K, C, H, A, S,
                               torch.device("cpu"))
    nbytes, popc, flops = chip_smoke._train_bound(name, c)
    if name != "evaluate_candidates_kernel":
        assert train_bounds.em_bytes(K, S, H, C, name.endswith("packed")) \
            == nbytes
        return
    counts = ts.eval_counts(c["allele"], c["fAe"], c["fBe"], c["geno"],
                            A).tolist()
    w = train_bounds.eval_work(K, S, H, C, *counts)
    assert w["bytes"] == nbytes
    assert w["popc"] == pytest.approx(popc, rel=1e-12)
    assert w["flops"] == pytest.approx(flops, rel=1e-12)
    assert popc > 0 and flops > 0
