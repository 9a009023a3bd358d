"""The traffic generator: the same seed gives the same work, another seed
moves the warm chain within its path segment, and the cold points keep
their k-points and draw new starts."""

import numpy as np
import pytest

from benchmark import harness, lattices, traffic

CHAINS = ["warm_chain.10-17", "warm_chain.24-31", "warm_chain_levers.10-17"]
CONFIG = {"fcc": "fcc_chiral_n120", "sc_curv": "sc_curv_crossdof_n120"}
BIG = 2 ** 31 + 977


def _config(mix_name):
    lattice = "sc_curv" if "24" in mix_name or "cold" in mix_name else "fcc"
    return harness.load_json(harness.HERE, "configs",
                             f"{CONFIG[lattice]}.json")


@pytest.mark.parametrize("name", CHAINS)
def test_warm_chain_is_the_same_work_for_every_seed(name):
    mix, cfg = traffic.load(name), _config(name)
    a, b = traffic.plan(mix, cfg, BIG), traffic.plan(mix, cfg, 5)
    assert [(p.index, p.alpha.tolist(), p.seed) for p in (a.entry,) + a.points] \
        == [(p.index, p.alpha.tolist(), p.seed) for p in (b.entry,) + b.points]
    path = lattices.k_path(cfg["lattice"], cfg["gap"])
    for p in (a.entry,) + a.points:
        lo, hi = path[p.index], path[p.index + 1]
        assert np.allclose(p.alpha, lo + mix["offset"] * (hi - lo))
        assert 0.0 < mix["offset"] < 1.0
        assert p.index % cfg["gap"] != cfg["gap"] - 1
    assert [p.index for p in a.points] == list(
        range(mix["first"], mix["first"] + mix["points"]))
    assert a.entry.index == mix["first"] - 1


def test_cold_points_keep_their_starts_in_a_seeded_order():
    name = "cold_points.19-29-39-59"
    mix, cfg = traffic.load(name), _config(name)
    path = lattices.k_path(cfg["lattice"], cfg["gap"])
    orders = set()
    for seed in (BIG, BIG + 1, 5, 6, 7, 8):
        p = traffic.plan(mix, cfg, seed)
        again = traffic.plan(mix, cfg, seed)
        assert [(q.index, q.alpha.tolist()) for q in p.points] == \
            [(q.index, q.alpha.tolist()) for q in again.points]
        assert sorted(q.index for q in p.points) == sorted(mix["indices"])
        for q in p.points:
            assert np.array_equal(q.alpha, path[q.index])
            assert q.seed == q.index
        assert p.entry is None
        orders.add(tuple(q.index for q in p.points))
    assert len(orders) > 1


def test_checked_points_are_drawn_from_the_seed():
    mix, cfg = traffic.load(CHAINS[0]), _config(CHAINS[0])
    p = traffic.plan(mix, cfg, BIG)
    draws = [traffic.checked(p, k) for k in range(20)]
    assert draws == [traffic.checked(p, k) for k in range(20)]
    assert all(len(d) == mix["check_per_pass"] for d in draws)
    assert len({tuple(sorted(d)) for d in draws}) > 1


def test_a_chain_across_a_symmetry_point_is_refused():
    mix, cfg = dict(traffic.load(CHAINS[0]), first=15), _config(CHAINS[0])
    with pytest.raises(ValueError, match="symmetry point"):
        traffic.plan(mix, cfg, 1)
