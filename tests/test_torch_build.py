"""hibag_tpu_torch.ops._build names the library by a hash of the CUDA sources
and the headers they include, so that an edited header builds anew, and
launches every kernel through `launch`. No nvcc is needed: only the
library's path is computed, and launches go to a fake library."""

import contextlib
import shutil
import types
import weakref

import pytest
import torch

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


class _FakeLib:
    """A library whose one launcher returns `err` and keeps its arguments."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def hibag_fake(self, *args):
        self.calls.append(args)
        self.alive = [r() is not None for r in self.watch]
        return self.err

    def hibag_cuda_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.mark.parametrize("err", [0, 700])
def test_launch_counts_once_or_raises_naming_the_kernel(err, monkeypatch):
    """`launch` passes a tensor as its data pointer, None and numbers as
    they are, then the current stream and the two launch marks (None with
    tracing off), while every tensor it was given is alive (one made in
    the call expression too, whose memory would otherwise go back to the
    caching allocator before the kernel is on the stream); on code 0 it
    counts the launch once, on another code it raises RuntimeError naming
    the kernel and the error, and counts nothing."""
    lib = _FakeLib(err)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    x = torch.zeros(4)
    tally = {"fake": 0}

    def made_here():
        # a tensor with no owner but the call: it must outlive the launch
        t = torch.ones(3)
        lib.watch = [weakref.ref(t)]
        return t

    run = lambda: _build.launch("hibag_fake", "fake_kernel", {"n": 4}, "cpu",
                                x, None, 4, 2.5, made_here(),
                                tally=(tally, "fake"))
    if err:
        with pytest.raises(RuntimeError,
                           match="fake_kernel kernel launch failed: an "
                                 "illegal memory access .*700"):
            run()
    else:
        run()
    ptr = lib.calls[0][4]
    assert lib.calls == [(x.data_ptr(), None, 4, 2.5, ptr, 1234, None, None)]
    assert lib.alive == [True]
    assert tally == {"fake": 0 if err else 1}
