"""The port's native mask engine (``pcx_torch.native``, the C++/OpenMP copy
of pcx's ``csrc/pcx_geometry.cpp``) against the port's numpy masks and
pcx's (tests/test_geometry.py::test_native_engine_parity): bit-identical
edge and volume masks for every lattice, the shared mask cache, the build
into a fresh directory and from the command line, and a failed build that
raises instead of falling back to numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pcx import geometry as jgeo
from pcx_torch import geometry, lattices, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATTICES = sorted(native.FLAG_IDS)


def test_build_from_the_port_copy_into_a_new_directory(tmp_path):
    path = native.build(build_dir=str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert native.build(build_dir=str(tmp_path)) == path   # no rebuild
    lib = native.load(path)
    ct_inv_t = np.linalg.inv(lattices.ct_matrix("fcc").T)
    np.testing.assert_array_equal(
        native.edge_mask(9, "fcc", ct_inv_t, lib=lib),
        geometry.edge_mask(9, "fcc", cache=False, use_native=False))


@pytest.mark.parametrize("lattice", LATTICES)
def test_native_masks_match_numpy_and_pcx(lattice):
    for n in (9, 32):
        edge = geometry.edge_mask(n, lattice, cache=False, use_native=True)
        vol = geometry.volume_mask(n, lattice, cache=False, use_native=True)
        assert edge.shape == (3, n, n, n) and edge.dtype == bool
        assert vol.shape == (n, n, n) and vol.dtype == bool
        assert 0 < edge.sum() < edge.size
        for want in (geometry.edge_mask(n, lattice, cache=False,
                                        use_native=False),
                     jgeo.edge_mask(n, lattice, cache=False,
                                    use_native=False)):
            np.testing.assert_array_equal(edge, want)
        for want in (geometry.volume_mask(n, lattice, cache=False,
                                          use_native=False),
                     jgeo.volume_mask(n, lattice, cache=False,
                                      use_native=False)):
            np.testing.assert_array_equal(vol, want)


def test_native_masks_round_trip_the_shared_cache(tmp_path, monkeypatch):
    """Masks built natively are cached in pcx's format: the port and pcx
    read the same bits back."""
    monkeypatch.setattr(geometry, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jgeo, "CACHE_DIR", str(tmp_path))
    n, lattice = 12, "sc_curv"
    edge = geometry.edge_mask(n, lattice, use_native=True)
    vol = geometry.volume_mask(n, lattice, use_native=True)
    assert sorted(os.listdir(tmp_path)) == [f"{lattice}_{n}_edge.npz",
                                            f"{lattice}_{n}_volume.npz"]
    for reader in (geometry, jgeo):
        np.testing.assert_array_equal(reader.edge_mask(n, lattice), edge)
        np.testing.assert_array_equal(reader.volume_mask(n, lattice), vol)
    np.testing.assert_array_equal(
        edge, geometry.edge_mask(n, lattice, cache=False, use_native=False))


def test_a_compiler_without_openmp_builds_the_serial_engine(tmp_path,
                                                            monkeypatch):
    """A g++ that cannot link OpenMP (no libgomp.spec) builds the same
    engine single-threaded: the same bits."""
    fake = tmp_path / "gxx"
    fake.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                    '{ echo "cannot read spec file libgomp.spec" >&2; '
                    'exit 1; }; done\nexec g++ "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    path = native.build(build_dir=str(tmp_path / "build"))
    assert os.path.basename(path).startswith("libpcxgeom_serial_")
    ct_inv_t = np.linalg.inv(lattices.ct_matrix("sc_curv").T)
    np.testing.assert_array_equal(
        native.volume_mask(16, "sc_curv", ct_inv_t, lib=native.load(path)),
        geometry.volume_mask(16, "sc_curv", cache=False, use_native=False))


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    """No quiet fallback: a source that does not compile raises, with the
    compiler's message."""
    src = tmp_path / "broken.cpp"
    src.write_text("int pcx_edge_mask( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(src=str(src), build_dir=str(tmp_path / "build"))


def test_native_rejects_an_unknown_lattice():
    with pytest.raises(ValueError, match="no lattice"):
        native.edge_mask(8, "hexagonal", np.eye(3))


def test_native_build_command_exits_zero():
    r = subprocess.run([sys.executable, "-m", "pcx_torch.native", "--build"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(r.stdout.strip().splitlines()[-1])
