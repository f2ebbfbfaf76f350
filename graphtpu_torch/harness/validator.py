"""Output validation against Graphalytics golden files — vectorized
(counterpart of graphtpu/harness/validator.py, same match rules).

Replicates the harness-side validation the reference enables with
benchmark.custom.validation-required = true (config-template/
cdlp.properties:21; SURVEY.md §3.5): per-vertex outputs are compared
against the reference result files shipped with each dataset
(e.g. example-data-sets/graphs/example-directed-BFS) under
per-algorithm match rules mirroring graphalytics-core's validation
module:

* BFS — exact integers (unreachable = int64 max, bfs.cpp:61) —
  MatchLongValidationRule;
* CDLP — exact integers (the min-mode tie-break makes labels
  deterministic, LAGraph_cdlp.c:36-45) — MatchLongValidationRule;
* WCC — equivalence-class match: the component *partition* must be
  identical, label values are arbitrary (wcc.cpp:31-33 writes raw matrix
  indices for exactly this reason) — EquivalenceValidationRule;
* PR / LCC / SSSP — epsilon match on doubles, with the literal
  "infinity" for unreachable SSSP (sssp.cpp:45) —
  EpsilonValidationRule. graphalytics-core's rule accepts b when
  |a - b| < eps * |a| with eps = 1e-4 (relative to the golden value);
  EPSILON below matches that constant, with an extra absolute floor so
  golden values that are exactly 0.0 (e.g. LCC of degree-<2 vertices)
  compare sanely in float32.

Everything is array-at-a-time: golden files load through numpy's C
tokenizer (np.loadtxt — strtod parses the literal "infinity" to inf)
and the matchers are whole-array comparisons, so datagen-scale outputs
(16.5M vertices) validate in seconds rather than minutes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from graphtpu_torch.core.graph import Graph

EPSILON = 1e-4  # graphalytics-core EpsilonValidationRule relative tolerance
_ABS_FLOOR = 1e-12  # absolute slack for golden values at/near exact 0.0


def _golden_dtype(algorithm: str):
    if algorithm == "bfs":
        return np.int64  # levels; unreachable = int64 max exactly
    if algorithm in ("wcc", "cdlp"):
        # labels are (original) vertex ids; int64 like graph.mapping —
        # mixing uint64 with int64 promotes comparisons to FLOAT64,
        # which collapses distinct ids above 2^53
        return np.int64
    return np.float64


def load_result_file(path: str, algorithm: str) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, values) from a `vertex value` per-line result file."""
    arr = np.loadtxt(
        path,
        dtype=[("id", np.int64), ("val", _golden_dtype(algorithm))],
        ndmin=1,
    )
    return arr["id"], arr["val"]


def _align(ids_m, vals_m, ids_g, vals_g):
    """Sort both result sets by vertex id; error string if the id sets
    differ, else (mine_sorted, golden_sorted, ids_sorted)."""
    if ids_m.shape[0] != ids_g.shape[0]:
        return f"vertex count mismatch: {ids_m.shape[0]} vs {ids_g.shape[0]}"
    pm = np.argsort(ids_m, kind="stable")
    pg = np.argsort(ids_g, kind="stable")
    ids_ms, ids_gs = ids_m[pm], ids_g[pg]
    if not np.array_equal(ids_ms, ids_gs):
        bad = np.nonzero(ids_ms != ids_gs)[0][0]
        return f"vertex id sets differ (first: {ids_ms[bad]} vs {ids_gs[bad]})"
    return vals_m[pm], vals_g[pg], ids_gs


def _match_exact_int(mine, golden, ids):
    eq = mine == golden
    if eq.all():
        return True, ""
    bad = np.nonzero(~eq)[0][0]
    return False, f"vertex {ids[bad]}: got {mine[bad]}, expected {golden[bad]}"


def _match_epsilon(mine, golden, ids):
    m = mine.astype(np.float64, copy=False)
    g = golden
    inf_ok = np.isinf(m) == np.isinf(g)
    if not inf_ok.all():
        bad = np.nonzero(~inf_ok)[0][0]
        return False, f"vertex {ids[bad]}: got {m[bad]}, expected {g[bad]}"
    finite = ~np.isinf(g)
    with np.errstate(invalid="ignore"):  # inf - inf on matching-inf rows
        diff = np.abs(np.where(finite, m - g, 0.0))
    tol = EPSILON * np.maximum(np.abs(g), 0.0)
    ok = (diff <= tol) | (diff <= _ABS_FLOOR)
    if ok.all():
        return True, ""
    bad = np.nonzero(~ok)[0][0]
    return False, f"vertex {ids[bad]}: got {m[bad]:.17g}, expected {g[bad]:.17g}"


def _match_equivalence(mine, golden, ids):
    """The label partitions must be identical (labels themselves are
    arbitrary): (mine, golden) label pairs must be a bijection."""
    _, mi = np.unique(mine, return_inverse=True)
    _, gi = np.unique(golden, return_inverse=True)
    n_m = int(mi.max()) + 1 if mi.size else 0
    n_g = int(gi.max()) + 1 if gi.size else 0
    pairs = np.unique(mi.astype(np.int64) * max(n_g, 1) + gi)
    if pairs.size == n_m == n_g:
        return True, ""
    return False, (
        f"partition mismatch: {n_m} output classes, {n_g} golden classes, "
        f"{pairs.size} distinct (output, golden) label pairs"
    )


MATCHERS = {
    "bfs": _match_exact_int,
    "cdlp": _match_exact_int,
    "wcc": _match_equivalence,
    "pr": _match_epsilon,
    "lcc": _match_epsilon,
    "sssp": _match_epsilon,
}


def _coerce_mine(algorithm: str, vals: np.ndarray) -> np.ndarray:
    dt = _golden_dtype(algorithm)
    if algorithm in ("wcc", "cdlp"):
        return np.asarray(vals).astype(np.int64, copy=False)
    return np.asarray(vals).astype(dt, copy=False)


def validate_result(result, graph: Graph, golden_path: str) -> Tuple[bool, str]:
    ids_g, vals_g = load_result_file(golden_path, result.algorithm)
    ids_m = graph.mapping
    vals_m = _coerce_mine(result.algorithm, result.values)
    aligned = _align(ids_m, vals_m, ids_g, vals_g)
    if isinstance(aligned, str):
        return False, aligned
    ok, msg = MATCHERS[result.algorithm](*aligned)
    return ok, (msg if not ok else "validated")


def validate_files(algorithm: str, output_path: str, golden_path: str) -> Tuple[bool, str]:
    """File-vs-file validation (used by the CLI `validate` command)."""
    ids_g, vals_g = load_result_file(golden_path, algorithm)
    ids_m, vals_m = load_result_file(output_path, algorithm)
    aligned = _align(ids_m, vals_m, ids_g, vals_g)
    if isinstance(aligned, str):
        return False, aligned
    ok, msg = MATCHERS[algorithm](*aligned)
    return ok, (msg if not ok else "validated")
