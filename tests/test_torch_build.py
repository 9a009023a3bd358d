"""The kernels' build: the library's name is keyed by every CUDA source and
shared header, and nvcc finds the headers.  Runs on the CPU: nothing here
compiles."""

import shutil

import pytest

from pcx_torch.kernels import _build


def test_library_path_follows_sources_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert (csrc / "tf32x3.cuh").exists()
    p0 = _build.library_path(str(csrc))
    assert p0 == _build.library_path()          # same bytes, same library
    hdr = csrc / "tf32x3.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n")
    p1 = _build.library_path(str(csrc))
    assert p1 != p0                             # an edited header rebuilds
    src = csrc / "gram9.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_path(str(csrc)) not in (p0, p1)


def test_every_compile_gets_the_header_directory(tmp_path, monkeypatch):
    seen = []

    def fake_run_all(cmds):
        cmds = [list(c) for c in cmds]
        seen.extend(cmds)
        return [(c, 1, "stopped before compiling") for c in cmds]

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert len(seen) == len(_build.sources()) >= 3
    for cmd in seen:
        i = cmd.index("-I")
        assert cmd[i + 1] == _build.CSRC
