"""``benchmark/run.py`` as the driver runs it: without a card it exits
non-zero and prints no result; on the card (the ``gpu`` marker) a traced
run of a cell ends in one result line of the contract's shape."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELL = "fcc_chiral_n120.levers"


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = _run("--workload", CELL, "--seed", "1", "--seconds", "0",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_an_unknown_workload_is_refused():
    out = _run("--workload", "no_such.cell", "--seed", "1", "--seconds",
               "0", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_traced_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run("--workload", CELL, "--seed", str(2 ** 31 + 4242),
               "--seconds", "0", "--trace", "1")
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] == 8 and r["failed"] == 0
    dev = r["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["kind"] == torch.cuda.get_device_name(0)
    for name, m in r["metrics"].items():
        if name.split(".")[0].endswith("roofline"):
            assert 0 < m["value"] <= 100, (name, m)
    assert {"k2_roofline.sweep", "k1_roofline.sweep", "device_idle.sweep",
            "ms_per_iter.sweep"} <= set(r["metrics"])
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
    assert os.path.isdir(os.path.join(ROOT, "pcx_torch", "_build"))
