"""The benchmark of pcx_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up,
whole passes of the cell's traffic for at least ``--seconds``, then the
check of the answers against the plain complex128 reference.  The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each compared number beside its limit); the last lines of
standard error are the same checks.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window.

Exits non-zero without printing a result when no card (or fewer cards
than the cell asks for) is visible, and when JAX or the JAX package is
loaded once the window has closed.  The program's build and kernel caches
stay in fixed directories of the checkout.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["PCX_GEOMETRY_CACHE"] = os.path.join(ROOT, "data",
                                                "geometry_cache")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness
    c = harness.cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        say(f"needs {c.chips} CUDA device(s); torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    say(f"# {args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace} on {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, power limit {power_limit()}")
    result, lines = harness.run_cell(c, args.seed, args.seconds,
                                     bool(args.trace), device, T_START)
    found = harness.loaded_forbidden()
    if found:
        say(f"JAX or the JAX package is loaded: {found}")
        return 3
    say(f"# {len(result['metrics'])} metrics: "
        + ", ".join(f"{k} {v['value']!r} {v['unit']}"
                    for k, v in result["metrics"].items()))
    for ln in lines:
        say(ln)
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or 'unknown'."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "unknown"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
