"""Speed-of-light accounting by executed volume (counterpart of
graphtpu/utils/roofline.py, without its TPU rates).

The JAX package prices each primitive at a rate measured on its TPU
(``RATES_TPU``, ``BFS_STEP_MS``). The port keeps the JAX package's volume
model, the count of primitive elements each phase of a run executes, and
prices each element at the fewest bytes the primitive must move for it,
over the card's published memory rate (3.35 TB/s, the H100 SXM; the bound
convention of ``chip_smoke.py`` and ``PERF.md`` §6):

    gather   8 B  a 4-byte index read and a 4-byte value written (the table
                  value read is not counted: many indices may share it)
    scan     4 B  a 4-byte term read by the segment reduction
    sort     8 B  a 4-byte key read once and written once
    scatter  8 B  a 4-byte index and a 4-byte value read (the target's
                  writes may merge)

Each count is a lower bound on the bytes the executed volume moves, so a
``sol_pct`` is a share of a true lower bound and cannot exceed 100.
``cdlp_executed_roof``, ``wcc_executed_roof``, ``sssp_executed_roof`` and
``bfs_executed_roof`` are the JAX package's volume functions, term for term.
There is no rate override: a card other than the H100 SXM needs its own
``HBM_BYTES_PER_S``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published

BYTES_PER_ELEMENT = {"gathers": 8, "scans": 4, "sorts": 8, "scatters": 8}


def roof_seconds(gathers: float = 0.0, scans: float = 0.0, sorts: float = 0.0,
                 scatters: float = 0.0) -> float:
    """The least time the card could take for the given primitive volumes."""
    nbytes = (gathers * BYTES_PER_ELEMENT["gathers"] + scans * BYTES_PER_ELEMENT["scans"]
              + sorts * BYTES_PER_ELEMENT["sorts"] + scatters * BYTES_PER_ELEMENT["scatters"])
    return nbytes / HBM_BYTES_PER_S


def sol_pct(measured_seconds: float, roof_s: float) -> float:
    """Share of the roof in percent, unrounded (not clamped)."""
    if measured_seconds <= 0:
        return 0.0
    return 100.0 * roof_s / measured_seconds


def cdlp_executed_roof(full_steps: int, active_steps: int, plan_gathers: int,
                       e_cap: int) -> float:
    """Full step: one slab-plan sweep (plan_gathers label gathers). Active
    step: expand (2 E-sized gathers) + stream min-mode (2 sorts + scan +
    gather over e_cap) + the dedupe of the compacted stream (2 sorts)."""
    full = roof_seconds(gathers=plan_gathers)
    active = roof_seconds(gathers=3 * e_cap, sorts=4 * e_cap, scans=e_cap)
    return full_steps * full + active_steps * active


def wcc_executed_roof(full_steps: int, active_steps: int, nnz: int, n: int, e_cap: int,
                      plan_gathers: "int | None" = None) -> float:
    """Edge-stream full step: label gather + segment-min scan over the
    symmetrized stream, plus two n-sized pointer-jump gathers. Slab full
    step (``plan_gathers`` set): one slab-plan gather sweep plus the jumps.
    Iteration 0 is gather-free in both, so one full step's main volume is
    taken off. Active step: expand (2 E gathers) + label gather + segment-min
    scan over e_cap + dedupe sorts (2) + one n-sized compact sort."""
    if plan_gathers is not None:
        full = roof_seconds(gathers=plan_gathers + 2 * n)
        iter0_discount = roof_seconds(gathers=plan_gathers) if full_steps >= 1 else 0.0
    else:
        full = roof_seconds(gathers=nnz + 2 * n, scans=nnz)
        iter0_discount = roof_seconds(gathers=nnz) if full_steps >= 1 else 0.0
    active = roof_seconds(gathers=3 * e_cap, scans=e_cap, sorts=2 * e_cap + n)
    return full_steps * full - iter0_discount + active_steps * active


def sssp_executed_roof(full_steps: int, active_steps: int, nnz: int, n: int, e_cap: int,
                       stats: "dict | None" = None) -> float:
    """Full step: distance gather + weight load + segment-min scan over the
    pull stream. Tier step at edge budget e: expand (2 E gathers) +
    distance and weight gathers + scatter-min of e candidates + the n-sized
    compact sort. With ``stats`` (per-tier counters) each tier is priced at
    its own budget, else every active step at e_cap."""
    full = roof_seconds(gathers=2 * nnz, scans=nnz)
    total = full_steps * full
    if stats is not None and "tier_steps" in stats:
        for (_k, e), steps in zip(stats["tiers"], stats["tier_steps"].values()):
            total += steps * roof_seconds(gathers=4 * e, scatters=e, sorts=n)
        return total
    return total + active_steps * roof_seconds(gathers=4 * e_cap, scatters=e_cap, sorts=n)


def bfs_executed_roof(stats: dict, nnz: int, n: int) -> float:
    """The adaptive BFS's per-phase volumes from its step counters. Tier
    step at budget e (k rows): n-sized compact sort + expand (2 gathers) +
    unvisited probe gather + dedupe sorts (2) + k scatters. Bottom-up step:
    t_trunc * n probe gather + n-sized residual compact sort + residual
    expand and probe over e_bu. Dense step: frontier gather + segment-max
    scan over the full stream."""
    total = 0.0
    for (k, e), steps in zip(stats["tiers"], stats["tier_steps"].values()):
        total += steps * roof_seconds(gathers=3 * e, sorts=2 * e + n, scatters=k)
    total += stats["bu_steps"] * roof_seconds(gathers=stats["t_trunc"] * n + 3 * stats["e_bu"],
                                              sorts=n)
    total += stats["dense_steps"] * roof_seconds(gathers=nnz, scans=nnz)
    return total


def plan_gather_count(plan) -> int:
    """Gathered slots of one slab-plan sweep (``ops/slab.py:SlabPlan``):
    every slab element plus the heavy stream."""
    total = sum(int(b.slab.numel()) for b in plan.slabs)
    if plan.heavy_neigh is not None:
        total += int(plan.heavy_neigh.shape[0])
    return total
