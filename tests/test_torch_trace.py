"""The port's tracing (hibag_tpu_torch/utils/trace.py): off by default and
silent when off; spans with their parent, root and self time; the spans of
a fused training, of a predict() call and of a mesh's shard threads; launch
records beside the launch counts. The card-only cases (marked gpu) check
the spans' CUDA events and their names in a torch.profiler trace, and that
tracing off makes no event, profiler range or reduction on the card."""

import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import hibag_tpu_torch as ht
from hibag_tpu_torch.models import train_fused
from hibag_tpu_torch.ops import ens_acc, post_scores
from hibag_tpu_torch.ops import train_step as ts
from hibag_tpu_torch.parallel import mesh as tmesh
from hibag_tpu_torch.utils import trace
from hibag_tpu_torch.utils.synthetic import synthetic_panel

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_KW = dict(n_classifiers=2, batch=2, mode="fused", hcap=32,
                on_overflow="freeze", verbose=False, with_matching=False)
PREDICT_SPANS = ("predict.align", "predict.prepare", "predict.block",
                 "predict.fetch", "predict.finalize")


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def panel():
    (table, geno), (_, held) = synthetic_panel(0, 120, 60, 6, 40)
    return table, geno, held


@pytest.fixture(scope="module")
def model(panel):
    table, geno, _ = panel
    return ht.train_parallel(table, geno, device="cpu", **TRAIN_KW)


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_after_import():
    """A fresh interpreter: tracing is off once the package is imported."""
    code = ("import hibag_tpu_torch; from hibag_tpu_torch.utils import trace;"
            " import sys; sys.exit(1 if trace.enabled() else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_off_records_nothing(panel, model, monkeypatch):
    """Off, span() and launch() give the one shared no-op and a training
    and a predict() make no span, counter, launch record, CUDA event or
    profiler range, even under a recording profiler."""
    assert trace.span("x") is trace.span("y") is trace._NULL
    assert trace.launch("k", {}) is trace._NULL
    assert trace.carry(len) is len

    def boom(*a, **k):
        raise AssertionError("tracing off made a record")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(ts, "eval_counts", boom)
    table, geno, held = panel
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ht.train_parallel(table, geno, device="cpu", **TRAIN_KW)
        ht.predict(model, held, device="cpu", block=16)
    trace.count("host_syncs")
    snap = trace.snapshot()
    assert snap == {"spans": [], "counters": [], "launches": []}


def test_nesting_parent_root_and_self_time():
    trace.enable()
    with trace.span("a"):
        time.sleep(0.01)
        with trace.span("b"):
            time.sleep(0.02)
            with trace.span("a"):          # already open: not recorded
                trace.count("n", 3)
        with trace.span("c"):
            time.sleep(0.005)
    with trace.span("d"):
        pass
    snap = trace.snapshot()
    s = {x["name"]: x for x in snap["spans"]}
    assert sorted(s) == ["a", "b", "c", "d"]
    assert s["a"]["parent"] is None and s["a"]["root"] == s["a"]["id"]
    assert s["b"]["parent"] == s["c"]["parent"] == s["a"]["id"]
    assert s["b"]["root"] == s["c"]["root"] == s["a"]["id"]
    assert s["d"]["root"] == s["d"]["id"] != s["a"]["id"]
    assert s["a"]["self_host_ms"] == pytest.approx(
        s["a"]["host_ms"] - s["b"]["host_ms"] - s["c"]["host_ms"])
    assert s["a"]["self_host_ms"] >= 10.0
    assert s["b"]["self_host_ms"] == s["b"]["host_ms"] >= 20.0
    assert all(x["device_ms"] is None for x in s.values())
    (c,) = snap["counters"]
    assert (c["name"], c["n"], c["span"], c["root"]) == (
        "n", 3, s["b"]["id"], s["a"]["id"])
    summ = trace.summary(snap)
    assert summ["spans"]["a"]["n"] == 1 and summ["counters"] == {"n": 3}


def test_threads_record_every_span():
    """Many threads switching often: every span and count is kept, each
    under its own thread's parent, and carry() gives a worker the caller's
    span as parent and root."""
    n_threads, n_spans = 24, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work():
            for _ in range(n_spans):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("c")
        with trace.span("caller"):
            threads = [threading.Thread(target=trace.carry(work))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = trace.snapshot()
    (caller,) = _by_name(snap, "caller")
    outer = {s["id"]: s for s in _by_name(snap, "outer")}
    inner = _by_name(snap, "inner")
    assert len(outer) == len(inner) == n_threads * n_spans
    assert all(s["parent"] == caller["id"] == s["root"]
               for s in outer.values())
    assert all(outer[s["parent"]]["thread"] == s["thread"] for s in inner)
    assert trace.summary(snap)["counters"] == {"c": n_threads * n_spans}


def test_fused_training_spans(panel, monkeypatch):
    """As many train.step spans as steps taken, each holding train.draw,
    train.em (with train.match), train.erase, train.eval and train.update,
    under one train.batch; at least one EM iteration a step."""
    steps = []
    step = train_fused._step

    def counted(*a, **k):
        steps.append(1)
        return step(*a, **k)
    monkeypatch.setattr(train_fused, "_step", counted)
    table, geno, _ = panel
    trace.enable()
    ht.train_parallel(table, geno, device="cpu", **TRAIN_KW)
    snap = trace.snapshot()
    (batch,) = _by_name(snap, "train.batch")
    st = _by_name(snap, "train.step")
    assert len(st) == len(steps) > 0
    ids = {s["id"] for s in st}
    assert all(s["parent"] == batch["id"] for s in st)
    for name in ("train.draw", "train.em", "train.erase", "train.eval",
                 "train.update"):
        got = _by_name(snap, name)
        assert len(got) == len(st) and all(s["parent"] in ids for s in got)
    em = {s["id"] for s in _by_name(snap, "train.em")}
    match = _by_name(snap, "train.match")
    assert match and all(s["parent"] in em for s in match)
    assert all(s["root"] == batch["id"] for s in snap["spans"])
    counts = trace.summary(snap)["counters"]
    assert counts["train.em_iterations"] >= len(st)
    assert counts["host_syncs"] >= counts["train.em_iterations"]


def test_predict_spans(model, panel):
    """One predict.call holding align, prepare, a block and a fetch per
    block and finalize, whose host times sum to no more than the call's."""
    held = panel[2]
    trace.enable()
    ht.predict(model, held, device="cpu", block=16)
    snap = trace.snapshot()
    (call,) = _by_name(snap, "predict.call")
    n_blocks = -(-held.genotype.shape[1] // 16)
    for name in PREDICT_SPANS:
        got = _by_name(snap, name)
        assert len(got) == (n_blocks if name in ("predict.block",
                                                  "predict.fetch") else 1)
        assert all(s["parent"] == call["id"] for s in got)
    inner = sum(s["host_ms"] for s in snap["spans"]
                if s["name"] in PREDICT_SPANS)
    assert inner <= call["host_ms"]
    assert call["self_host_ms"] == pytest.approx(call["host_ms"] - inner)
    assert trace.summary(snap)["counters"] == {"host_syncs": n_blocks}


def test_mesh_predict_blocks_on_threads(model, panel, monkeypatch):
    """Two shards on threads (as on cards): each block's predict.block
    spans run on two threads under the call's root id."""
    def threaded(devices, fns):
        gate = threading.Barrier(len(fns))      # no thread takes two

        def gated(fn):
            def run():
                gate.wait()
                return fn()
            return run
        return tmesh.run_threads([gated(fn) for fn in fns])
    monkeypatch.setattr(tmesh, "run_shards", threaded)
    trace.enable()
    res = ht.predict(model, panel[2], devices=["cpu", "cpu"])
    snap = trace.snapshot()
    (call,) = _by_name(snap, "predict.call")
    blocks = _by_name(snap, "predict.block")
    assert len(blocks) == 2
    assert len({s["thread"] for s in blocks}) == 2
    assert all(s["root"] == call["id"] == s["parent"] for s in blocks)
    one = ht.predict(model, panel[2], device="cpu")
    np.testing.assert_array_equal(res.prob, one.prob)


def test_launch_records_leave_launches(panel):
    """A launch record does not count a launch, and a traced training
    counts the launches an untraced one does."""
    def counts():
        return (dict(ts.LAUNCHES), ens_acc.LAUNCHES, post_scores.LAUNCHES)
    table, geno, _ = panel
    before = counts()
    ht.train_parallel(table, geno, device="cpu", **TRAIN_KW)
    untraced = counts()
    trace.enable()
    with trace.launch("em_estep", {"K": 1, "S": 8, "H": 32, "C": 2,
                                   "tier": "int8"},
                      lambda: torch.tensor([1, 2, 3])) as rec:
        assert rec.marks == (None, None)          # no card: no events
    ht.train_parallel(table, geno, device="cpu", **TRAIN_KW)
    assert counts() == untraced == before
    (rec,) = trace.snapshot()["launches"]
    assert rec["name"] == "em_estep" and rec["counts"] == [1, 2, 3]
    assert rec["device_ms"] is None and rec["dims"]["H"] == 32


def test_eval_counts():
    """ok slots, heterozygous words and row cells per classifier."""
    K, C, H, N, A = 2, 3, 5, 4, 3
    fA = torch.zeros((K, C, H))
    fB = torch.zeros((K, C, H))
    fA[0, 0, [0, 2]] = 0.1            # classifier 0: slots 0, 2, 3 ok
    fB[0, 2, 3] = 0.2
    fB[1, 1, :] = 0.1                 # classifier 1: all 5 ok
    allele = torch.tensor([[0, 1, 2, 2, 0], [0, 0, 1, 1, 1]])
    geno = torch.full((K, N, 128), 3, dtype=torch.int8)
    geno[0, 0, [1, 40, 41]] = 1       # words 0 and 1
    geno[0, 3, 127] = 1               # word 3
    geno[1, 2, 64] = 2                # no heterozygous code
    got = ts.eval_counts(allele, fA, fB, geno, A).tolist()
    # classifier 0: alleles of the ok slots 0, 2, 2 -> counts [1, 0, 2];
    # alleles with ok slots at or after a: a=0: 2, a=2: 1 -> 1*2 + 2*1 = 4
    # classifier 1: counts [2, 3, 0] -> 2*2 + 3*1 = 7
    assert got == [[3, 5], [3, 0], [4, 7]]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_device_times_on_the_card(cuda):
    """A span given a card records CUDA events: the device time of a span
    around device work covers its child's and is read in snapshot()."""
    x = torch.randn((2048, 2048), device=cuda)
    torch.cuda.synchronize()
    trace.enable()
    with trace.span("outer", x):
        with trace.span("inner", cuda):
            for _ in range(20):
                x = x @ x
                x = x / x.norm()
    snap = trace.snapshot()
    s = {x["name"]: x for x in snap["spans"]}
    assert s["inner"]["device_ms"] > 0.5
    assert s["outer"]["device_ms"] >= s["inner"]["device_ms"]
    assert s["outer"]["self_device_ms"] == pytest.approx(
        s["outer"]["device_ms"] - s["inner"]["device_ms"])


@pytest.mark.gpu
def test_span_names_in_the_profiler_trace(cuda, panel):
    """While a profiler records, every span is a record_function range of
    its name: a fused batch's layers show in the trace."""
    table, geno, _ = panel
    trace.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ht.train_parallel(table, geno, device="cuda", **TRAIN_KW)
    names = {e.name for e in prof.events()}
    for name in ("train.batch", "train.step", "train.em", "train.match",
                 "train.eval"):
        assert name in names
    launches = trace.snapshot()["launches"]
    ev = [x for x in launches if x["name"] == "evaluate_candidates_kernel"]
    assert ev and all(len(x["counts"]) == 3 and x["device_ms"] > 0
                      for x in ev)


@pytest.mark.gpu
def test_off_makes_nothing_on_the_card(cuda, panel, model, monkeypatch):
    """With tracing off a predict() and a fused batch on the card make no
    CUDA event, profiler range or count reduction; under a device-only
    profiler two untraced runs launch the same kernels."""
    table, geno, held = panel

    def run():
        ht.predict(model, held, device="cuda")
        ht.train_parallel(table, geno, device="cuda", **TRAIN_KW)
        torch.cuda.synchronize()

    def kernels():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    run()                       # the ensemble's copy to the card, once
    first = kernels()
    made = []
    event, rf, counts = (torch.cuda.Event, torch.profiler.record_function,
                         ts.eval_counts)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append("event") or event(*a, **k))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append("range") or rf(*a, **k))
    monkeypatch.setattr(ts, "eval_counts",
                        lambda *a: made.append("counts") or counts(*a))
    run()
    assert made == []
    monkeypatch.undo()
    assert kernels() == first
