"""Kernel K7 (``pcx_torch.kernels.crossdof``, the cross-DoF eps^{-1} in one
pass) on the CPU: what the kernel refuses, the route of ``CrossDofOp``'s
applies (only a complex64 field on the card, with no ``roll_fn``, reaches
the kernel; the CPU, complex128 and a grid-sharded operator keep the eager
composition), the bytes each launch counts, and that the module imports
where there is no CUDA compiler.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""

import os
import subprocess
import sys

import pytest
import torch

from pcx_torch import kernels, tracing
from pcx_torch.kernels import _build
from pcx_torch.kernels import crossdof as k7
from pcx_torch.operators import dielectric

N = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _op(preset=0, k=1, n=N, roll_fn=None):
    op = dielectric.pseudochiral_crossdof_op(n, "sc_curv", "cpu",
                                             eps_opt=preset, k=k)
    if roll_fn is None:
        return op
    return dielectric.CrossDofOp(op.diag64, op.masks64, op.sten, op.eps,
                                 "cpu", roll_fn=roll_fn)


def _field(lead=(2,), n=N, dtype=torch.complex64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(lead + (3, n, n, n), generator=gen, dtype=dtype)


def _refused_cases():
    op, op2 = _op(), _op(k=2)
    x = _field()
    d, m = op.diag32, op.masks32
    return {
        "complex128 field": (x.to(torch.complex128), d, m, op.sten, op.eps),
        "float64 diagonal": (x, op.diag64, m, op.sten, op.eps),
        "float64 masks": (x, d, op.masks64, op.sten, op.eps),
        "complex masks": (x, d, m.to(torch.complex64), op.sten, op.eps),
        "diagonal elsewhere": (x, d.to("meta"), m, op.sten, op.eps),
        "transposed field": (x.transpose(-1, -2), d, m, op.sten, op.eps),
        "strided masks": (x, d, m.transpose(-1, -2), op.sten, op.eps),
        "conjugated field": (x.conj(), d, m, op.sten, op.eps),
        "eight taps": (x, d, m, op2.sten + (0.0,) * 4, op.eps),
        "odd taps": (x, d, m, op2.sten[:3], op.eps),
        "no taps": (x, d, m, (), op.eps),
        "two eps entries": (x, d, m, op.sten, op.eps[:2]),
        "no component axis": (x[:, 0], d, m, op.sten, op.eps),
        "two components": (x[:, :2], d, m, op.sten, op.eps),
        "not a cube": (x[..., :-1], d, m, op.sten, op.eps),
        "diagonal of another grid": (x, d[..., :-1], m, op.sten, op.eps),
        "one mask": (x, d, m[:1], op.sten, op.eps),
        "empty": (x[:0], d, m, op.sten, op.eps),
    }


@pytest.mark.parametrize("case", list(_refused_cases()))
def test_problem_names_what_k7_cannot_read(case):
    """``problem`` refuses each operand K7 cannot read (type, device,
    contiguity, the tap limit, the shapes), and the wrapper raises on it."""
    args = _refused_cases()[case]
    assert k7.problem(*args)
    with pytest.raises(ValueError, match="crossdof_apply"):
        k7.crossdof_apply(*args)


@pytest.mark.parametrize("lead", [(1,), (16,), (4, 3), ()],
                         ids=["one", "block", "lanes", "bare"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_problem_takes_any_leading_axes_and_up_to_six_taps(lead, k):
    op = _op(preset=3, k=k)
    x = _field(lead)
    assert k7.problem(x, op.diag32, op.masks32, op.sten, op.eps) is None
    assert len(op.sten) == 2 * k <= 2 * k7.MAX_K


@pytest.mark.parametrize("preset", [0, 1, 2, 3])
def test_cpu_wrapper_takes_the_eager_composition(preset):
    """For CPU tensors ``crossdof_apply`` is the eager composition, bit for
    bit, and launches nothing."""
    op = _op(preset, k=2)
    x = _field((3,), seed=preset)
    n0 = k7.crossdof_apply.launches
    got = k7.crossdof_apply(x, op.diag32, op.masks32, op.sten, op.eps)
    assert torch.equal(got, k7.crossdof_plain(x, op.diag32, op.masks32,
                                              op.sten, op.eps))
    assert torch.equal(got, op._apply_fn((op.diag32, op.masks32), x))
    assert k7.crossdof_apply.launches == n0


def _halo_roll(v, shift, axis):
    return torch.roll(v, shift, axis)


@pytest.mark.parametrize("how", ["cpu-c64", "cpu-c128", "roll_fn"])
def test_cpu_complex128_and_roll_fn_applies_keep_the_eager_composition(
        how, monkeypatch):
    """On the CPU (complex64 and complex128 alike) and for an operator built
    with a ``roll_fn`` (the grid-sharded path), ``CrossDofOp`` never reaches
    K7 and returns the eager composition."""
    def refuse(*a, **k):
        raise AssertionError("K7 reached")

    monkeypatch.setattr(k7, "crossdof_apply", refuse)
    op = _op(2, roll_fn=_halo_roll if how == "roll_fn" else None)
    dtype = torch.complex128 if how == "cpu-c128" else torch.complex64
    x = _field(dtype=dtype, seed=4)
    diag, masks = op._held("diag", x), op._held("masks", x)
    want = dielectric.make_crossdof_apply(op.sten, *op.eps)((diag, masks), x)
    kernels.reset_launches()
    assert torch.equal(op(x), want)
    assert "k7.bytes" not in tracing.counts()
    assert kernels.launches()["crossdof_apply"] == 0


class _CardField:
    """What ``CrossDofOp.forward`` reads of a field: where it lies and its
    type (the route decides on these alone)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.is_cuda = True


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_a_complex64_field_on_the_card_goes_to_k7(dtype, monkeypatch):
    """A complex64 field on the card is handed to K7 with the operator's
    float32 diagonal and masks, stencil and eps entries; a complex128 one
    (the escalation's refine, ``f64_truth``) takes the eager composition,
    as does any field of an operator built with a ``roll_fn``."""
    calls, eager = [], []
    monkeypatch.setattr(k7, "crossdof_apply",
                        lambda *a: calls.append(a) or "k7")
    for op in (_op(0), _op(0, roll_fn=_halo_roll)):
        monkeypatch.setattr(op, "_apply_fn",
                            lambda params, x: eager.append(x) or "eager")
        x = _CardField(dtype)
        got = op(x)
        if dtype == torch.complex64 and op._k7:
            assert got == "k7"
            (arg, diag, masks, sten, eps), = calls
            assert arg is x and diag is op.diag32 and masks is op.masks32
            assert sten == op.sten and eps == op.eps
        else:
            assert got == "eager"
    assert len(calls) + len(eager) == 2
    assert len(calls) == (dtype == torch.complex64)


def test_the_presets_pairs_and_masks():
    """Preset 0 has pair 12 alone, preset 1 pair 13 alone, presets 2 and 3
    all three: two edge masks read, then three."""
    got = [k7._terms(_op(p).sten, _op(p).eps)[0] for p in range(4)]
    assert got == [0b001, 0b010, 0b111, 0b111]
    assert [k7.masks_read(a) for a in got] == [2, 2, 3, 3]
    assert k7.masks_read(0) == 0 and k7.masks_read(0b100) == 2


def test_terms_hold_half_the_eps_entries_in_float32():
    op = _op(3, k=3)
    active, params = k7._terms(op.sten, op.eps)
    assert len(params) == 12 and params.typecode == "f"
    assert list(params[:6]) == [float(torch.tensor(w, dtype=torch.float32))
                                for w in op.sten]
    half = [0.5 * e for e in op.eps]
    want = torch.tensor([[h.real, h.imag] for h in half],
                        dtype=torch.float32).flatten().tolist()
    assert list(params[6:]) == want
    assert k7._terms((0.5, 0.5), (0j, 0j, 0j))[0] == 0


@pytest.mark.parametrize("preset,nbytes", [(0, 1_361_664_000),
                                           (1, 1_361_664_000),
                                           (2, 1_368_576_000),
                                           (3, 1_368_576_000)])
def test_bytes_count_each_operand_once(preset, nbytes):
    """A launch's ``k7.bytes``: (48 c + 4 (3 + masks)) N^3, x read and y
    written once, the diagonal and the masks the pairs read once: 1.362e9
    at c = 16, N = 120 with pair 12 alone (0.4065 ms at 3.35 TB/s), three
    masks for presets 2-3; lanes count every column."""
    active = k7._terms(_op(preset).sten, _op(preset).eps)[0]

    def meta(*shape):           # shapes alone, no storage
        return torch.empty(shape, dtype=torch.complex64, device="meta")

    assert k7.bytes_moved(meta(16, 3, 120, 120, 120), active) == nbytes
    assert 1e3 * k7.bytes_moved(meta(16, 3, 120, 120, 120), 1) / 3.35e12 \
        == pytest.approx(0.4065, abs=5e-5)
    lanes = k7.bytes_moved(meta(4, 16, 3, 120, 120, 120), active)
    assert lanes == (48 * 64 + 4 * (3 + k7.masks_read(active))) * 120 ** 3


def test_module_imports_and_applies_without_a_compiler():
    """With no CUDA toolkit on the path the kernel module imports, the
    operator applies on the CPU, and nothing is built."""
    code = (
        "import torch\n"
        "from pcx_torch.kernels import _build, crossdof\n"
        "from pcx_torch.operators import dielectric\n"
        "op = dielectric.pseudochiral_crossdof_op(4, 'sc_curv', 'cpu')\n"
        "x = torch.ones((2, 3, 4, 4, 4), dtype=torch.complex64)\n"
        "y = crossdof.crossdof_apply(x, op.diag32, op.masks32, op.sten,"
        " op.eps)\n"
        "assert torch.equal(y, op(x))\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert out.stdout.strip() == "no nvcc"
    assert _build.SIGNATURES["pcx_crossdof"][1] is not None
