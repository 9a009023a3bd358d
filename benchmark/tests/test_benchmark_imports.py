"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference loads no module of the program either."""

import os
import subprocess
import sys

from conftest import ROOT

PROBE = """
import importlib.util, sys
sys.path.insert(0, {root!r})
{body}
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {banned!r}))
"""


def _loaded(body: str, banned: set) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=ROOT, body=body, banned=banned)], capture_output=True,
        text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_run_py_and_the_program_load_no_jax():
    body = """
spec = importlib.util.spec_from_file_location(
    "bench_run", "benchmark/run.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import benchmark.harness, benchmark.calibrate
import pcx_torch.bandstructure, pcx_torch.kernels
for name in ("kpoint_s", "k2_roofline", "device_idle"):
    benchmark.harness.reader(name)
"""
    assert _loaded(body, {"jax", "jaxlib", "flax", "pcx"}) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    body = """
import benchmark.reference.maxwell, benchmark.reference.control
import benchmark.reference.geometry, benchmark.lattices
"""
    assert _loaded(body, {"jax", "jaxlib", "flax", "pcx",
                          "pcx_torch"}) == "[]"
