"""``python -m pcx_torch.route_ab`` on the CPU: one subprocess per tree
imports that tree's ``pcx_torch`` and prints one JSON line per route."""

import json
import os

from pcx_torch import route_ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_route_ab_times_each_route_of_each_tree(capfd):
    route_ab.main([ROOT, "--cpu", "--n", "6", "--iters", "3", "--reps", "2"])
    out = capfd.readouterr().out.splitlines()
    recs = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["route"] for r in recs] == ["complex", "rs"]
    for r in recs:
        assert r["tree"] == ROOT
        assert r["package"] == os.path.join(ROOT, "pcx_torch",
                                             "__init__.py")
        assert r["iterations"] == [3, 3]
        assert len(r["ms_per_iteration"]) == 2
        assert r["median_ms"] > 0.0
