"""K2's design choices timed on the card against the kernel as it stands.

    python3 -m pcx_torch.k2_variants [--ns 100,120,150] [--b 48]

Copies ``kernels/csrc/axis_dft.cu`` once per variant, edits the copy, builds
every copy with ``nvcc`` at once, binds each like ``_build.load`` and times
one forward pass of B x N^3 for each N (CUDA events, median of 10), the
variants in turns, twice, in opposite orders (min/max printed), beside four
yardsticks of the card's memory on the same x: ``x.clone()``,
``x.permute(0, 2, 3, 1).contiguous()`` (PyTorch's own transpose copy), a sum
over x (reads only) and ``y.zero_()`` (writes only).  The variants:

* ``kernel``: the source as it stands;
* ``l2_promo_256``: TMA loads with 256-byte L2 promotion;
* ``cached_stores``: plain stores in place of streaming ones;
* ``lines_16``: 16-line tiles (half the shared memory per block);
* ``kt_divisor``: k tiles of the even divisor of K in 16..48 nearest 32
  (N=100: 20, N=120 and 150: 30), where one exists: no ragged last tile;
* ``slabs_3``: a 3-deep ring of input slabs;
* ``cp_async``: the cp.async load path at every N;
* ``no_compute``: the loads and stores alone, no FFT (its output is wrong).

Every variant but ``no_compute`` is held to 5e-6 of the output scale of the
plain version.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import statistics
import subprocess
import tempfile

import torch

from pcx_torch.kernels import _build

VARIANTS = {
    "kernel": [],
    "l2_promo_256": [("CU_TENSOR_MAP_L2_PROMOTION_NONE",
                      "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "cached_stores": [("__stcs(yr + e, make_float4(u.x, u.y, v.x, v.y));",
                       "yr[e] = make_float4(u.x, u.y, v.x, v.y);"),
                      ("__stcs(yr + e, o[e]);", "yr[e] = o[e];")],
    "lines_16": [("constexpr int kLines = 32;", "constexpr int kLines = 16;")],
    "kt_divisor": [("    p.kt = kLines, p.jt = 1;\n",
                    "    p.kt = kLines, p.jt = 1;\n"
                    "    for (int d = 16; d <= 48; d += 2)\n"
                    "      if (K % d == 0 && (K % p.kt != 0 || abs(d - kLines)"
                    " < abs(p.kt - kLines)))\n"
                    "        p.kt = d;\n")],
    "slabs_3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "cp_async": [("if (tma_ok(p))", "if (false)")],
    "no_compute": [("if (p.n1 > kMaxRadix) {", "if (p.n1 < 0) {"),
                   ("} else {\n      run_stage1",
                    "} else if (p.n1 < 0) {\n      run_stage1")],
}


def build_variants(tmp: str) -> dict:
    """name -> (ctypes library, ptxas lines) of each edited copy."""
    with open(os.path.join(_build.CSRC, "axis_dft.cu")) as f:
        src = f.read()
    cmds, paths = [], {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   f"axis_dft.cu")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        paths[name] = os.path.join(tmp, f"lib{name}.so")
        cmds.append([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     paths[name], cu])
    out = {}
    for (name, path), (cmd, rc, log) in zip(paths.items(),
                                            _build._run_all(cmds)):
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        for sym, (argtypes, restype) in _build.SIGNATURES.items():
            if sym.startswith("pcx_axis_dft"):
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = argtypes, restype
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln])
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", default="100,120,150")
    ap.add_argument("--b", type=int, default=48)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a CUDA device")
    # the module (pcx_torch.kernels.axis_dft is also the wrapper's name)
    k2 = importlib.import_module("pcx_torch.kernels.axis_dft")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    load = _build.load
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(tmp)
        for name, (_, regs) in libs.items():
            print(f"  {name}: {'; '.join(regs)}", flush=True)
        try:
            for n in (int(v) for v in args.ns.split(",")):
                x = torch.randn((args.b, n, n, n), generator=gen, device=dev,
                                dtype=torch.complex64)
                y_p = k2.axis_dft_plain(x, k2.dft_matrix(n, False, dev))
                scale = float(y_p.abs().max())
                y0 = torch.empty_like(x)
                yard = {
                    "clone": cuda_ms(lambda: x.clone()),
                    "permute": cuda_ms(
                        lambda: x.permute(0, 2, 3, 1).contiguous()),
                    "sum": cuda_ms(lambda: x.view(torch.float32).sum()),
                    "zero_": cuda_ms(lambda: y0.zero_())}
                del y0
                times = {name: [] for name in libs}
                for name in list(libs) + list(libs)[::-1]:
                    _build.load = lambda lib=libs[name][0]: lib
                    err = float((k2.axis_dft(x) - y_p).abs().max())
                    if name != "no_compute" and not err <= 5e-6 * scale:
                        raise SystemExit(f"variant {name} N={n}: "
                                         f"{err / scale:.3e} of scale")
                    times[name].append(cuda_ms(lambda: k2.axis_dft(x)))
                bound = 2 * 8 * args.b * n ** 3 / 3.35e12 * 1e3
                print(f"N={n} B={args.b}: bytes bound {bound:.3f} ms; "
                      + ", ".join(f"{k} {v:.3f}" for k, v in yard.items())
                      + " ms; " + ", ".join(
                          f"{k} {min(v):.3f}/{max(v):.3f}"
                          for k, v in times.items()) + " ms", flush=True)
                del x, y_p
        finally:
            _build.load = load


if __name__ == "__main__":
    main()
