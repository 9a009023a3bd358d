"""The one traffic generator: turns a mix's parameter file and ``--seed``
into the work of one pass.

A mix is ``traffic/<name>.json`` with a ``kind`` and its parameters:

* ``warm_chain``: ``first`` and ``points`` name consecutive indices of the
  configuration's Brillouin-zone path; the pass solves them in order, each
  warm-started from the previous accepted block, from an entry block that
  set-up makes at index ``first - 1`` (a cold solve, then up to
  ``settle_passes`` warm re-solves, ending once one takes at most
  ``settle_iters`` iterations).  Every point, the entry's too, lies
  ``offset`` of a path spacing past its path index, strictly inside one
  path segment: k-points that no committed library row holds.
* ``cold_points``: one cold solve (plane-wave start) at each of
  ``indices``, in an order drawn from the seed.

Every seed gives the same work: the k-points and every start's jitter
(the solve's seed is the point's path index) are fixed, because the
iterations to the FLOOR stop follow the rounding of the start: seeded
starts moved a pass's iterations by 3-11% from seed to seed where
repeats of one seed agreed within 1-2%.  The seed draws the order of the
cold points and the points of each pass whose Ritz block is kept for the
check after the window (``check_per_pass``; every point whose solve was
escalated or retried is kept too).  ``solver_opts`` go to the solver as
given; {} keeps the program's defaults.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from benchmark import lattices

HERE = os.path.dirname(os.path.abspath(__file__))
RETRY_SALT = 10007      # a retried point's cold seed: its seed + RETRY_SALT


class Point(NamedTuple):
    index: int           # path index
    alpha: np.ndarray    # wave vector solved
    seed: int            # the solve's seed (cold start, width fit)


class Plan(NamedTuple):
    kind: str
    entry: Point | None  # warm_chain: where set-up makes the entry block
    points: tuple        # Points of one pass, in order
    solver_opts: dict
    settle_passes: int
    settle_iters: int
    check_per_pass: int
    seed: int


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def plan(mix: dict, config: dict, seed: int) -> Plan:
    path = lattices.k_path(config["lattice"], config["gap"])
    kind = mix["kind"]
    rng = np.random.default_rng(seed)
    common = dict(solver_opts=dict(mix.get("solver_opts", {})),
                  check_per_pass=int(mix["check_per_pass"]), seed=seed)
    if kind == "warm_chain":
        first, count = int(mix["first"]), int(mix["points"])
        t = float(mix["offset"])
        idx = list(range(first - 1, first + count))
        gap = config["gap"]
        # index i + 1 must lie in i's segment, which ends at a symmetry
        # point (index % gap == gap - 1)
        if first < 1 or any(i % gap == gap - 1 for i in idx):
            raise ValueError(f"warm_chain {first}..{first + count - 1} "
                             f"crosses a symmetry point of the path")
        pts = [Point(i, path[i] + t * (path[i + 1] - path[i]), i)
               for i in idx]
        return Plan(kind, pts[0], tuple(pts[1:]),
                    settle_passes=int(mix["settle_passes"]),
                    settle_iters=int(mix["settle_iters"]), **common)
    if kind == "cold_points":
        order = rng.permutation(len(mix["indices"]))
        pts = tuple(Point(int(i), path[int(i)].copy(), int(i))
                    for i in np.asarray(mix["indices"])[order])
        return Plan(kind, None, pts, settle_passes=0, settle_iters=0,
                    **common)
    raise ValueError(f"unknown traffic kind {kind!r}")


def checked(p: Plan, pass_no: int) -> set:
    """Positions in the pass whose blocks are kept for the check in pass
    ``pass_no``: ``check_per_pass`` of them, drawn from the seed."""
    rng = np.random.default_rng([p.seed, pass_no])
    k = min(p.check_per_pass, len(p.points))
    return set(int(i) for i in rng.choice(len(p.points), k, replace=False))
