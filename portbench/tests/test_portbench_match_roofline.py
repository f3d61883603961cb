"""The reader of match_pairs.roofline on synthetic launch records: the
bytes bound of work/match_bounds.py over the event time of the window's
matching launches, nothing without them or off the card."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.work import match_bounds, peaks

INT8 = {"K": 8, "n": 1000, "Hp": 256, "mode": "int8"}
PACKED = {"K": 8, "n": 1000, "Hp": 512, "mode": "packed"}


class Fake:
    """A stand-in for the program's trace module."""

    def __init__(self, launches=()):
        self.snap = {"spans": [], "launches": list(launches), "counters": []}

    def snapshot(self):
        return self.snap


def launch(name, t0, device_ms, dims):
    return {"name": name, "dims": dims, "counts": None,
            "t0_ns": int(t0 * 1e9), "t1_ns": int((t0 + 1e-4) * 1e9),
            "device_ms": device_ms}


def ctx(popc_rate=4.0e12):
    return SimpleNamespace(calls=[(10.0, 11.0, 0, None),
                                  (11.0, 12.0, 1, None)],
                           popc_rate=popc_rate)


@pytest.fixture(scope="module")
def reader():
    r = run.load_metric("match_pairs.roofline")
    yield r
    if r.TRACE is not None:
        r.TRACE.disable()
        r.TRACE.reset()


def read(reader, fake, c=None):
    saved, reader.TRACE = reader.TRACE, fake
    try:
        return reader.read(c or ctx())
    finally:
        reader.TRACE = saved


def test_reads_the_window_launches(reader):
    fake = Fake([launch("match_pairs", 10.2, 0.25, INT8),
                 launch("match_pairs_packed", 11.5, 0.15, PACKED),
                 launch("em_estep", 10.3, 0.3, {"K": 8}),
                 launch("match_pairs", 12.5, 99.0, INT8)])
    least = (match_bounds.match_bytes(8, 1000, 256, False)
             + match_bounds.match_bytes(8, 1000, 512, True)) \
        / peaks.MEM_BYTES_PER_S
    assert read(reader, fake) == pytest.approx(100 * least / 0.4e-3)


def test_nothing_to_read(reader):
    assert read(reader, Fake()) is None
    assert read(reader, None) is None
    # a program without the kernel: other launches only
    assert read(reader, Fake([launch("em_estep", 10.3, 0.3, {})])) is None
    # off the card
    fake = Fake([launch("match_pairs", 10.2, None, INT8)])
    assert read(reader, fake, ctx(popc_rate=None)) is None
    assert read(reader, fake) is None
