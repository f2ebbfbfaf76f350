"""Synthetic graph generation (counterpart of graphtpu/utils/synth.py).

The generators are numpy, so for one seed they give arrays bit-identical
to the JAX package's.

The reference benchmarks on LDBC datagen/graph500 datasets downloaded from
the LDBC bucket (small-data-sets/download-dataset-small.sh:13-22); in an
offline environment we synthesize graphs with the same shape statistics:
graph500-style RMAT power-law graphs parameterized by (scale, edge factor),
matching the skew the CUDA fork's degree-dependent kernels were built for
(cdlp_kernel.cu:611-677). Deterministic under a seed.
"""

from __future__ import annotations

import numpy as np

from graphtpu_torch.core.graph import Graph


def rmat_edges(
    scale: int,
    edge_factor: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
):
    """Vectorized RMAT: 2^scale vertices, edge_factor * 2^scale edge samples
    (duplicates/self-loops included, as in Graph500 spec)."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / (a + b)
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return n, src, dst


def _pair_weight(src: np.ndarray, dst: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic per-UNORDERED-pair weight in [0.01, 1.01).

    Undirected Graphalytics graphs carry ONE weight per edge (relabel.py
    writes the symmetric matrix with a single value); deriving the weight
    from the canonical (min, max) pair guarantees w(u,v) == w(v,u) even
    when the sampler emits both orientations independently — Graph's
    keep-first dedupe would otherwise store asymmetric weights and break
    the pull == transposed-push invariant pull_arrays relies on."""
    lo = np.minimum(src, dst).astype(np.uint64)
    hi = np.maximum(src, dst).astype(np.uint64)
    h = lo * np.uint64(0x9E3779B97F4A7C15) ^ (hi + np.uint64(seed)) * np.uint64(
        0xC2B2AE3D27D4EB4F
    )
    h ^= h >> np.uint64(31)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(29)
    return (h >> np.uint64(11)).astype(np.float64) * 2.0**-53 + 0.01


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    directed: bool = True,
    weighted: bool = False,
    seed: int = 0,
    drop_self_loops: bool = True,
) -> Graph:
    """A dense-id RMAT graph (original ids == dense ids)."""
    n, src, dst = rmat_edges(scale, edge_factor, seed=seed)
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    w = None
    if weighted and directed:
        rng = np.random.default_rng(seed + 1)
        w = rng.random(src.shape[0]) + 0.01
    if not directed:
        non_loop = src != dst
        src2 = np.concatenate([src, dst[non_loop]])
        dst2 = np.concatenate([dst, src[non_loop]])
        src, dst = src2, dst2
        if weighted:
            w = _pair_weight(src, dst, seed + 1)
    mapping = np.arange(n, dtype=np.int64)
    return Graph(n, src, dst, w, mapping, directed=directed, weighted=weighted)


def grid_graph(
    side: int,
    *,
    weighted: bool = True,
    torus: bool = True,
    seed: int = 0,
) -> Graph:
    """2D grid or torus: the canonical HIGH-DIAMETER weighted graph
    (diameter about ``side``, against about log n for RMAT), the regime
    delta-stepping's bucket order is meant for (the reference runs
    LAGr_SingleSourceShortestPath with Delta = 2.5, sssp.cpp:70-78).
    Undirected; one weight per unordered pair."""
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // side, idx % side
    if torus:
        right = r * side + (c + 1) % side
        down = ((r + 1) % side) * side + c
        src = np.concatenate([idx, idx])
        dst = np.concatenate([right, down])
    else:
        keep_r = c < side - 1
        keep_d = r < side - 1
        src = np.concatenate([idx[keep_r], idx[keep_d]])
        dst = np.concatenate([idx[keep_r] + 1, idx[keep_d] + side])
    # both orientations (undirected storage)
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    w = _pair_weight(src2, dst2, seed + 1) if weighted else None
    mapping = np.arange(n, dtype=np.int64)
    return Graph(n, src2, dst2, w, mapping, directed=False, weighted=weighted)


def uniform_graph(
    n: int,
    m: int,
    *,
    directed: bool = True,
    weighted: bool = False,
    seed: int = 0,
) -> Graph:
    """Erdős–Rényi-ish uniform random graph (for quick tests)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.random(src.shape[0]) + 0.01 if weighted and directed else None
    if not directed:
        src2 = np.concatenate([src, dst])
        dst2 = np.concatenate([dst, src])
        src, dst = src2, dst2
        if weighted:
            # one weight per UNORDERED pair (see _pair_weight)
            w = _pair_weight(src, dst, seed + 1)
    mapping = np.arange(n, dtype=np.int64)
    return Graph(n, src, dst, w, mapping, directed=directed, weighted=weighted)
