"""hibag_tpu_torch stands alone: importing it pulls in no jax, and its
sources call no fused library operator in place of the kernel."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hibag_tpu_torch"


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def test_import_leaves_jax_out():
    """A fresh interpreter (this process already imported jax in
    conftest.py) imports every module of the port: the package, its CLI,
    io, eval, models, ops, data and utils modules (all but __main__, which
    runs the CLI), and loads no jax, jaxlib or hibag_tpu."""
    mods = sorted(
        "hibag_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py"))
    for m in ("hibag_tpu_torch.cli", "hibag_tpu_torch.io.rdata",
              "hibag_tpu_torch.io.gds", "hibag_tpu_torch.eval.assoc",
              "hibag_tpu_torch.eval.plots", "hibag_tpu_torch.parallel.mesh"):
        assert m in mods
    code = ("import sys, hibag_tpu_torch, " + ", ".join(mods) + "; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'hibag_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_and_its_worker_leave_jax_out():
    """The mesh module and the two-process tests' worker script
    (tests/_torch_dist_worker.py), with the names the worker calls, load in
    a fresh interpreter with no jax, jaxlib or hibag_tpu."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import _torch_dist_worker as w; "
            "from hibag_tpu_torch.parallel.mesh import (ensemble_mesh, "
            "shard_ensemble, replicate, distributed_init, classifier_range, "
            "sample_range, gather_classifiers, predict_distributed, "
            "sharded_predict); "
            "from hibag_tpu_torch import train_distributed, train_dynamic; "
            "w.gather_model([w.gather_classifier(0)]); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'hibag_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("pattern", [
    r"^\s*(from|import)\s+(jax|jaxlib|hibag_tpu)(\.|\s|$)",
    r"torch\.compile", r"scaled_dot_product_attention"])
def test_sources_avoid(pattern):
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
            if re.search(pattern, p.read_text(), re.MULTILINE)]
    assert not hits, hits
