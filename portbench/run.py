"""Runs one cell of the benchmark of ``hibag_tpu_torch`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The cell names a configuration (portbench/configs/<config>.json) and a
traffic mix (portbench/traffic/<mix>.json) in BENCHMARK.json; its limits
are portbench/limits/<cell>.json, and each per-layer metric is read by
portbench/metrics/<metric>.py. Set-up makes the inputs from the seed and
warms every shape the traffic uses; the window then calls the program for
``--seconds`` seconds. With ``--trace 0`` the result carries the cell's
end-to-end metrics (where one is taken from the device's trace, the whole
window runs under the profiler, the device alone); with ``--trace 1`` its
per-layer metrics, read from
spans around the program's layers during the window and from a profiled
stretch of calls after it. After the window the program's state is freed
and the plain reference judges answers drawn from the seed.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, then checks: each
number compared with its limit); the checks are also the last lines of
standard error. A mix's ``launches`` bound the program's kernel launches
per call of the window (``launch_gap``), so a cell cannot pass on
another path than the one it exists for. Without enough CUDA cards, or with jax, jaxlib, flax or
hibag_tpu loaded once the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

# one host thread a pool: the host shares its cores, and runs with one
# thread spread less and ran faster on the card's machine (PERF.md)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "hibag_tpu")


def since_process_start() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_metric(name):
    """The reader module of per-layer metric `name`."""
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    listing the cell under "workloads", and those without the key that move
    (per_layer) or are (end_to_end) one of the cell's end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def launch_counts(names):
    """The program's kernel launch counters: ``name`` is a module of
    ``hibag_tpu_torch.ops`` whose ``LAUNCHES`` is a count, ``module:key``
    one whose ``LAUNCHES`` is a dict of counts."""
    import importlib

    out = {}
    for name in names:
        mod, _, key = name.partition(":")
        n = importlib.import_module(f"hibag_tpu_torch.ops.{mod}").LAUNCHES
        out[name] = int(n[key] if key else n)
    return out


def run_cell(bench, cell, seed, seconds, trace, device="cuda", program=None,
             control_dtype=None, cfg=None, mix=None, limits=None, log=print):
    """One run of `cell`; returns the result's dict. `program` replaces the
    program's entry point (tests plant faults there); `control_dtype` puts
    the reference in that precision in the program's place for the check;
    `cfg`, `mix` and `limits` replace the cell's files."""
    import torch

    from . import drive, trace as tr
    from .reference import judge

    wl = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = cfg or load_json("portbench", "configs", f"{wl['config']}.json")
    mix = mix or load_json("portbench", "traffic", f"{wl['traffic']}.json")
    limits = limits or load_json("portbench", "limits", f"{cell}.json")
    cuda = torch.device(device).type == "cuda"
    chips = wl["chips"] if cuda else 1
    drv = drive.driver(cfg, mix, seed, device, program, chips)
    if cuda:
        from hibag_tpu_torch.ops import _build
        log(f"kernel library built before set-up: "
            f"{os.path.exists(_build.library_path())}")
    drv.setup()
    setup_s = since_process_start()
    log(f"set-up {setup_s:.3f} s; card before the window: {smi()}")

    expect = mix.get("launches", {})
    before = launch_counts(expect)
    out = {"metrics": {}}
    if not trace:
        e2e = cell_metrics(bench, cell, "end_to_end")
        if cuda and any(m["source"] == "device_trace" for m in e2e):
            # the whole window under the profiler, the device alone
            win, (t_start, t_end) = tr.profile(
                lambda: drv.window(seconds), set(), host=False)
            log(f"window traced on the device: busy "
                f"{win['busy_s']:.6f} s of {win['window_s']:.3f} s")
        else:
            win = None
            t_start, t_end = drv.window(seconds)
        calls = list(drv.calls)
        launched = launch_counts(expect)
        values = dict(drv.end_to_end(t_start, t_end, calls, win),
                      setup_s=setup_s)
        for m in e2e:
            # off the card no device metric is written
            if m["name"] in values:
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    else:
        readers = {m["name"]: (m, load_metric(m["name"]))
                   for m in cell_metrics(bench, cell, "per_layer")}
        specs = list(dict.fromkeys(s for _, r in readers.values()
                                   for s in r.LAYERS))
        with tr.Layers(specs) as layers:
            t_start, t_end = drv.window(seconds, span=layers.span)
        calls = list(drv.calls)
        launched = launch_counts(expect)
        n_prof = mix["profile_calls"]
        labels = {s[2] for s in specs} | {"call", "batch"}
        # the device alone first (busy and idle time, kernel times), then
        # host and device (idle gaps by what the host was doing), whose
        # recording of every host operation slows a host-bound stretch
        with tr.Layers([], profiling=True) as marks:
            prof, stretch = tr.profile(
                lambda: drv.stretch(n_prof, span=marks.span), labels,
                host=False)
        with tr.Layers(specs, profiling=True) as marks:
            gaps, _ = tr.profile(
                lambda: drv.stretch(n_prof, span=marks.span), labels)
        log(f"profiled stretches: device only {prof['window_s']:.3f} s, "
            f"with the host {gaps['window_s']:.3f} s")
        ctx = SimpleNamespace(
            layers={k: tuple(v) for k, v in layers.stats.items()},
            window_s=t_end - t_start, calls=calls, profile=prof,
            popc_rate=_popc_rate(cuda), mix=mix, cfg=cfg)
        drv.context(ctx, calls, stretch)
        for name, (m, reader) in readers.items():
            v = reader.read(ctx)
            if v is not None and math.isfinite(v):
                out["metrics"][name] = {"value": v, "unit": m["unit"]}
        log(f"spans: {json.dumps(ctx.layers)}")
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": gaps["idle_gaps"]}
    peak = max((torch.cuda.max_memory_allocated(k) for k in range(chips)),
               default=0) if cuda else 0
    counts = {k: launched[k] - before[k] for k in expect}
    log(f"card after the window: {smi()}")
    log(f"window: {json.dumps(drv.stats(calls))} in {t_end - t_start:.3f} s;"
        f" kernel launches {json.dumps(counts)}")

    drv.release()
    numbers = drv.check(mix["compare"], judge, control_dtype)
    # off the card the plain versions run and no launch is counted
    numbers["launch_gap"] = (judge.launches(counts, len(calls), expect)
                             if cuda else 0)
    correct, checks = judge.decide(numbers, limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": 0, "metrics": out["metrics"], "device": dev}
    if trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def _popc_rate(cuda):
    """The card's popcount rate; None off the card, where no device metric
    is read."""
    if not cuda:
        return None
    from .work import peaks
    return peaks.popc_rate(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl[0]["chips"]:
        print(f"the cell needs {wl[0]['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} against the limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
