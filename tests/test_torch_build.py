"""hibag_tpu_torch.ops._build names the library by a hash of the CUDA sources
and the headers they include, so that an edited header builds anew. No nvcc
is needed: only the library's path is computed."""

import shutil

import pytest

from hibag_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that _build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", str(copy))
    return copy


@pytest.mark.parametrize("pattern", ["*.cuh", "*.cu"])
def test_library_path_follows_sources_and_headers(csrc, pattern):
    before = _build.library_path()
    assert before == _build.library_path()  # stable while nothing changes
    src = sorted(csrc.glob(pattern))[0]
    src.write_text(src.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before
    assert after.startswith(_build.BUILD_DIR)


def test_headers_are_hashed(csrc):
    """The package ships the header the prediction kernels include."""
    assert (csrc / "pair_cells.cuh").is_file()
    before = _build.library_path()
    (csrc / "pair_cells.cuh").unlink()
    assert _build.library_path() != before


def test_source_flags_are_hashed(csrc, monkeypatch):
    """A per-source flag is part of the library's name: the evaluation
    kernel's -ftz=true, and any change to it, builds anew."""
    assert _build.SOURCE_FLAGS["eval_cand.cu"] == ["-ftz=true"]
    before = _build.library_path()
    monkeypatch.setitem(_build.SOURCE_FLAGS, "eval_cand.cu", [])
    assert _build.library_path() != before
    monkeypatch.setitem(_build.SOURCE_FLAGS, "em_estep.cu", ["-ftz=true"])
    assert _build.library_path() != before
