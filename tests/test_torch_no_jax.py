"""The port must run where JAX is not installed: no pcx_torch module and not
chip_smoke.py may import ``jax`` or ``pcx`` (``import pcx`` loads JAX via
pcx/__init__.py -> pcx.utils).  Checked in fresh interpreters."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pcx_torch
names = [m.name for m in pkgutil.walk_packages(pcx_torch.__path__,
                                               "pcx_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pcx"))
missing = sorted({"pcx_torch.io", "pcx_torch.metrics",
                  "pcx_torch.kernels.gram9", "pcx_torch.operators.dielectric",
                  "pcx_torch.geometry", "pcx_torch.interop",
                  "pcx_torch.solvers.davidson", "pcx_torch.solvers.lobpcg",
                  "pcx_torch.solvers.lobpcg_rs",
                  "pcx_torch.solvers.rayleigh_ritz", "pcx_torch.cli",
                  "pcx_torch.__main__", "pcx_torch.supervisor",
                  "pcx_torch.run_sweep", "pcx_torch.plotting",
                  "pcx_torch.experiments", "pcx_torch.experiments.__main__",
                  "pcx_torch.experiments.ablations",
                  "pcx_torch.experiments.precision",
                  "pcx_torch.experiments.structure",
                  "pcx_torch.experiments.runtime", "pcx_torch.profiling",
                  "pcx_torch.operators.dense", "pcx_torch.parallel",
                  "pcx_torch.parallel.mesh", "pcx_torch.parallel.fft",
                  "pcx_torch.parallel.solve", "pcx_torch.native",
                  "pcx_torch.f64_truth", "pcx_torch.record_vs_truth",
                  "pcx_torch.rescue_point", "pcx_torch.preflight_queue",
                  "pcx_torch.iter_tail", "pcx_torch.bench",
                  "pcx_torch.bench_matrix"}
                 - set(names))
print(len(names), bad, missing)
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_pcx_torch_module_imports_jax_or_pcx():
    out = _run(["-c", _IMPORT_ALL], ROOT)
    assert out.returncode == 0, out.stderr
    count, bad, missing = out.stdout.strip().split(" ", 2)
    assert int(count) >= 48
    assert missing == "[]", f"modules not imported: {missing}"
    assert bad == "[]", f"modules loaded: {bad}"


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    """No CPU fallback: on a host without CUDA the smoke test exits
    non-zero and prints no result line; alone in a directory it fails
    too."""
    import torch
    if not torch.cuda.is_available():
        out = _run(["chip_smoke.py"], ROOT)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
