"""The general traffic generator: a mix (portbench/traffic/<mix>.json) names
its ``kind``, and the kind's driver (portbench/kinds/<kind>.py, class
``Driver``) is found by that name. A driver makes its inputs from the run's
seed with the frozen generators (gen/synthetic.py) and a configuration's
sizes (portbench/configs/<config>.json), hands them to the program's entry
point that the mix names (``entry``, an attribute of ``hibag_tpu_torch``)
with the mix's own keyword arguments (``call``), and runs a closed loop
with one caller: the next call starts when the last one has returned its
outputs to the host. After the window it hands the same inputs, and the
outputs it kept, to the plain reference (portbench/reference/), which
judges them.

A driver has: ``kind``; ``setup()`` (inputs, the program's objects, a
warm-up of every shape the window uses); ``window(seconds, span=None)``
-> (start, end); ``calls``, a list of (t0, t1, input id, outputs);
``stretch(n, span)`` (n more calls for the profiler); ``end_to_end``,
``stats``, ``context`` (what the per-layer readers need);
``release()``; ``check(n, judge, control_dtype=None)`` -> the numbers
compared. A new kind is a new file there, and edits no other.
"""

from __future__ import annotations

import importlib

import numpy as np


def sub_seed(seed: int, k: int) -> int:
    """A 32-bit seed for stream `k` of the run's seed (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), k])
    return int(ss.generate_state(1, np.uint32)[0])


def driver(cfg, mix, seed, device, program=None, chips=1):
    """The driver of `mix`'s kind, found by name."""
    mod = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    return mod.Driver(cfg, mix, seed, device, program, chips)


def entry(mix):
    """The program's entry point that `mix` names."""
    import hibag_tpu_torch as ht
    return getattr(ht, mix["entry"])
