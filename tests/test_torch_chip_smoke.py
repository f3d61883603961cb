"""chip_smoke.py must fail without a CUDA card (no CPU fallback can pass it)
and in a directory that holds nothing else of the repository."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_packed_bound_counts_the_int8_masks_pairs():
    """The EM bound of a case built with its packed mask alone counts the
    set pairs and the rows holding one as the int8 mask would."""
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke

    rng = np.random.default_rng(4)
    c = chip_smoke._train_case(rng, 2, 3, 64, 9, 20, "cpu", masks="packed")
    assert "mask" not in c
    mask = chip_smoke._train_case(np.random.default_rng(4), 2, 3, 64, 9, 20,
                                  "cpu", masks=True)["mask"] != 0
    assert chip_smoke._packed_counts(c["packed"]) == (
        float(mask.sum()), float(mask.any(-1).sum()))
