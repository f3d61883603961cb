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
    # a fresh interpreter: this process already imported jax (conftest.py)
    code = ("import sys, hibag_tpu_torch, hibag_tpu_torch.models.predict, "
            "hibag_tpu_torch.utils.synthetic; "
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
