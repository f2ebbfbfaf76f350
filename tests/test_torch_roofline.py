"""The port's volume model (graphtpu_torch/utils/roofline.py) against the
JAX package's (graphtpu/utils/roofline.py): the same arguments give the
same primitive counts, and a price is those counts' bytes over the card's
published 3.35 TB/s."""

import numpy as np
import pytest

from graphtpu.utils import roofline as jrl

from graphtpu_torch.utils import roofline as rl

KINDS = ("gathers", "scans", "sorts", "scatters")


@pytest.fixture
def counted(monkeypatch):
    """Both modules' roof_seconds replaced by a recorder of the volumes
    they are asked to price; each call returns its own index."""

    def recorder(log):
        def roof(gathers=0.0, scans=0.0, sorts=0.0, scatters=0.0):
            log.append((gathers, scans, sorts, scatters))
            return 0.0
        return roof

    logs = {"jax": [], "torch": []}
    monkeypatch.setattr(jrl, "roof_seconds", recorder(logs["jax"]))
    monkeypatch.setattr(rl, "roof_seconds", recorder(logs["torch"]))
    return logs


BFS_STATS = {
    "tiers": [(65536, 65536), (262144, 262144), (262144, 1048576), (262144, 4194304)],
    "tier_steps": {65536: 2, 262144: 1, 1048576: 0, 4194304: 1},
    "bu_steps": 2, "dense_steps": 1, "t_trunc": 2, "k_bu": 1 << 15, "e_bu": 1 << 18,
}
SSSP_STATS = {"tiers": [(8192, 32768), (65536, 262144)], "tier_steps": {32768: 3, 262144: 1},
              "full_steps": 5, "active_steps": 4, "e_cap": 262144, "k_cap": 65536}
CASES = [
    ("cdlp_executed_roof", (4, 6, 81_234_567, 1 << 18)),
    ("cdlp_executed_roof", (0, 0, 10, 1 << 16)),
    ("wcc_executed_roof", (3, 1, 60_685_550, 1 << 20, 1 << 18, 79_000_000)),
    ("wcc_executed_roof", (4, 2, 60_685_550, 1 << 20, 1 << 18, None)),
    ("wcc_executed_roof", (0, 2, 100, 64, 1024, None)),
    ("sssp_executed_roof", (5, 4, 31_400_984, 1 << 20, 1 << 18, SSSP_STATS)),
    ("sssp_executed_roof", (5, 4, 31_400_984, 1 << 20, 1 << 18, None)),
]


@pytest.mark.parametrize("name,args", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_executed_volumes_equal_jax(counted, name, args):
    getattr(jrl, name)(*args)
    getattr(rl, name)(*args)
    assert counted["torch"] == counted["jax"] and counted["jax"]


def test_bfs_executed_volumes_equal_jax(counted):
    jrl.bfs_executed_roof(BFS_STATS, 60_685_550, 1 << 20)
    rl.bfs_executed_roof(BFS_STATS, 60_685_550, 1 << 20)
    assert counted["torch"] == counted["jax"] and len(counted["jax"]) == 4 + 2


def test_price_is_bytes_over_the_memory_rate():
    assert rl.HBM_BYTES_PER_S == 3.35e12
    for kind, nbytes in (("gathers", 8), ("scans", 4), ("sorts", 8), ("scatters", 8)):
        assert rl.roof_seconds(**{kind: 1_000_000}) == pytest.approx(nbytes * 1e6 / 3.35e12,
                                                                     rel=1e-15)
    both = rl.roof_seconds(gathers=3, scans=5, sorts=7, scatters=11)
    assert both == pytest.approx((3 * 8 + 5 * 4 + 7 * 8 + 11 * 8) / 3.35e12, rel=1e-15)
    # a roof of 1 ms against a run of 4 ms is 25 %, unrounded
    assert rl.sol_pct(4e-3, 1e-3) == 25.0
    assert rl.sol_pct(3e-3, 1e-3) == 100.0 / 3
    assert rl.sol_pct(0.0, 1.0) == 0.0


def test_no_tpu_rates_in_the_port():
    assert not hasattr(rl, "RATES_TPU") and not hasattr(rl, "BFS_STEP_MS")
    assert not hasattr(rl, "rate") and not hasattr(rl, "bfs_floor_roof")


def test_plan_gather_count_matches_jax_on_the_same_plan():
    """The slab plan of one graph, built by each package: the same padded
    gather volume; WCC's statistics take the port's one function."""
    from graphtpu.ops.spmv import build_pull_plan as j_build
    from graphtpu.utils.synth import rmat_graph as j_rmat

    from graphtpu_torch.algorithms import wcc as twcc
    from graphtpu_torch.core.graph import Graph
    from graphtpu_torch.ops.spmv import build_pull_plan

    jg = j_rmat(9, 8, directed=False, seed=3)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, False, False)
    jplan = j_build(jg, wdtype=np.float32, with_values=False)
    tplan = build_pull_plan(tg, device="cpu", wdtype=np.float32, with_values=False)
    assert rl.plan_gather_count(tplan) == jrl.plan_gather_count(jplan) > tg.nnz
    assert twcc.plan_gather_count is rl.plan_gather_count
