"""What the benchmark loads: the import closure of the harness, traffic,
metric and reference modules, compared by whole top-level names (the
program's name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "hibag_tpu"}


def _module_file(name):
    """The file of portbench module `name` (dotted), or None."""
    parts = name.split(".")
    base = os.path.join(ROOT, *parts)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _imports(path, modname):
    """Top-level-resolved names imported anywhere in the file (functions
    included)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    pkg = modname.rsplit(".", 1)[0] if not path.endswith("__init__.py") \
        else modname
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
    return out


def closure(roots):
    """Every module name reached from the portbench files `roots`, following
    portbench modules; others are listed, not followed."""
    seen, todo, names = set(), list(roots), set()
    while todo:
        path, modname = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path, modname):
            names.add(name)
            if name.split(".")[0] == "portbench":
                f = _module_file(name)
                if f:
                    todo.append((f, name))
    return names


def _files(sub=""):
    out = []
    for dirpath, _, files in os.walk(os.path.join(PKG, sub)):
        if os.path.basename(dirpath) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[:-9]
                out.append((os.path.join(ROOT, rel), mod))
    return out


def test_harness_traffic_and_metrics_load_no_jax():
    tops = {n.split(".")[0] for n in closure(_files())}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "hibag_tpu_torch" in tops        # the system under test


def test_reference_imports_nothing_of_the_program():
    names = closure(_files("reference") + _files("gen"))
    tops = {n.split(".")[0] for n in names}
    assert not tops & (FORBIDDEN | {"hibag_tpu_torch"}), tops


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run of each kind in a fresh interpreter, on the CPU, then the
    whole top-level names in sys.modules."""
    code = (
        "import sys, json\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "b = run.load_json('BENCHMARK.json')\n"
        "for cell, mix in (('hla_a-predict', tiny.PREDICT),"
        " ('hla_a-train', tiny.TRAIN)):\n"
        "    run.run_cell(b, cell, 5, 0.2, 1, device='cpu', cfg=tiny.CFG,"
        " mix=mix, log=lambda *a: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "hibag_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
