"""graphtpu_torch's delta-stepping device loop (``sssp-impl=delta``) against
the JAX package, on the CPU, where K5, K7, K8's settle mode, K14's bucket
mode, K18, K22 and K24 run their plain PyTorch versions and the loop is the
host walk of its nest (``DELTA_NEST``), reading each condition from the
control words.

Inputs come from numpy with a seed and go to both packages. Distances must
be bit-identical in float32 and float64 (tolerance 0), the step count equal
to the JAX kernel's ``it``, and each of the loop's counters (buckets,
light-active, light-dense, heavy-active and heavy-dense steps) equal to a
numpy walk of ``_sssp_delta_kernel``'s nested loops, which is held to the
JAX kernel's distances and ``it`` too. The step functions' plain versions
are held against the JAX kernel's formulas (graphtpu/algorithms/sssp.py:
``bucket``, ``derive_light``, ``derive_heavy``, the settle and the bucket
advance), written out here where they are nested functions of the jitted
kernel.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_delta_loop.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import sssp as jsssp
from graphtpu.ops import frontier as jf
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import grid_graph as j_grid_graph
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
ROOMY, TINY = (1 << 10, 1 << 14), (4, 16)
DELTAS = (2.5, 0.4, 0.3)
COUNTS = tsssp.DELTA_COUNTS


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, jg.directed, True)


def _cfg(delta, caps, cls=PlatformConfig, **kw):
    return cls(sssp_delta=delta, sssp_frontier_rows=caps[0], sssp_frontier_edges=caps[1], **kw)


def numpy_delta(g, source, delta, caps, np_dtype):
    """``_sssp_delta_kernel``'s nested loops walked in numpy, with the
    port's counters: (dist, it, counts)."""
    k_cap, e_cap = caps
    n = g.n
    imax = INT32_INF
    limit = 4 * n
    inv = np_dtype(1.0 / delta)
    top = np_dtype(2**31 - 1)
    src = np.repeat(np.arange(n), g.out_degree)
    dst, w = g.dst.astype(np.int64), g.w.astype(np_dtype)
    light = w <= np_dtype(delta)
    deg = {True: np.bincount(src[light], minlength=n), False: np.bincount(src[~light], minlength=n)}

    def bucket(d):
        b = np.floor(d * inv)
        return np.where(b >= top, imax, np.where(b >= top, 0, b).astype(np.int64))

    def derive(mask, light_class):
        cnt, fe = int(mask.sum()), int(deg[light_class][mask].sum())
        return np.nonzero(mask)[0], cnt <= k_cap and fe <= e_cap, cnt > 0

    def relax(dist, ids, sel):
        on = np.isin(src, ids) & sel
        new = dist.copy()
        np.minimum.at(new, dst[on], dist[src[on]] + w[on])
        return new, new < dist

    dist = np.full(n, np.inf, np_dtype)
    dist[source] = 0
    changed = np.zeros(n, bool)
    changed[source] = True
    counts = dict.fromkeys(COUNTS, 0)
    k = it = 0
    while k < imax and it < limit:
        counts["buckets"] += 1
        ids, fits, any_a = derive(changed & (bucket(dist) == k), True)
        while any_a and it < limit:
            while any_a and fits and it < limit:
                dist, improved = relax(dist, ids, light)
                changed[ids] = False
                changed |= improved
                ids, fits, any_a = derive(changed & (bucket(dist) == k), True)
                it += 1
                counts["light_active"] += 1
            while any_a and not fits and it < limit:
                dist, changed = relax(dist, np.arange(n), np.ones_like(light))
                ids, fits, any_a = derive(changed & (bucket(dist) == k), True)
                it += 1
                counts["light_dense"] += 1
        if it < limit:
            ids, fits, _ = derive(bucket(dist) == k, False)
            if fits:
                dist, improved = relax(dist, ids, ~light)
                changed[ids] = False
                changed |= improved
            else:
                dist, changed = relax(dist, np.arange(n), np.ones_like(light))
            it += 1
            counts["heavy_active" if fits else "heavy_dense"] += 1
        b = bucket(dist)
        k = int(np.where(b > k, b, imax).min())
    return dist, it, counts


@pytest.fixture(scope="module")
def rmat():
    """A directed and an undirected seeded RMAT graph, with the JAX
    package's run at every (delta, caps) from vertex 0, in both dtypes on
    the directed graph and float32 on the undirected one: one compile each,
    shared by the tests."""
    out = {}
    for directed in (True, False):
        jg = j_rmat_graph(8, 8, directed=directed, weighted=True, seed=11)
        jax_runs = {}
        for delta in DELTAS:
            for caps in (ROOMY, TINY):
                for name, (jdt, _) in DTYPES.items():
                    if directed or name == "float32":
                        jax_runs[delta, caps, name] = jsssp.sssp_delta_run(
                            jg, 0, _cfg(delta, caps, JConfig), jdt)
        out[directed] = (jg, _twin(jg), jax_runs)
    return out


CASES = [(directed, dtype) for directed in (True, False) for dtype in DTYPES
         if directed or dtype == "float32"]


@pytest.mark.parametrize("caps", [ROOMY, TINY], ids=["roomy", "tiny"])
@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("directed,dtype", CASES,
                         ids=[f"{'directed' if d else 'undirected'}-{t}" for d, t in CASES])
def test_host_loop_matches_jax_and_counts(rmat, directed, delta, caps, dtype):
    jg, tg, jax_runs = rmat[directed]
    np_dtype, tdt = DTYPES[dtype]
    want, want_it = jax_runs[delta, caps, dtype]
    got, got_it, stats = tsssp.sssp_delta_run(tg, 0, _cfg(delta, caps, device="cpu"), tdt,
                                              with_stats=True)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_it == want_it
    assert tsssp.last_run["driver"] == "host loop" and tsssp.last_run["condition_reads"] > 0
    nd, n_it, n_counts = numpy_delta(jg, 0, delta, caps, np_dtype)
    np.testing.assert_array_equal(nd, want)  # the numpy walk is JAX's kernel
    assert n_it == want_it
    assert {k: stats[k] for k in COUNTS} == n_counts
    assert sum(stats[k] for k in COUNTS[1:]) == want_it
    if caps == TINY and delta == 0.3:
        assert stats["light_dense"] > 0 and stats["heavy_dense"] > 0


def test_empty_heavy_class_and_the_steps_it_still_counts(rmat):
    """At delta 2.5 every RMAT weight ([0.01, 1.01)) is light: the heavy CSR
    has no edges, yet each bucket's heavy step runs (it only clears the
    bucket's marks) and counts, as in JAX."""
    jg, tg, jax_runs = rmat[False]
    light, heavy = tsssp.sssp_delta_prep(tg, 2.5, torch.float32, "cpu")
    assert heavy.dst.numel() == 0 and light.dst.numel() == tg.nnz
    _, it, stats = tsssp.sssp_delta_run(tg, 0, _cfg(2.5, ROOMY, device="cpu"), with_stats=True)
    assert it == jax_runs[2.5, ROOMY, "float32"][1]
    assert stats["heavy_active"] + stats["heavy_dense"] == stats["buckets"] > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_edgeless_graph(dtype):
    """No edge at all: the source's bucket is walked and left; every other
    vertex stays at infinity (the JAX kernel raises on an empty edge list)."""
    np_dtype, tdt = DTYPES[dtype]
    tg = Graph.from_arrays(5, np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0),
                           np.arange(5, dtype=np.uint64), True, True)
    got, it, stats = tsssp.sssp_delta_run(tg, 2, _cfg(2.5, ROOMY, device="cpu"), tdt,
                                          with_stats=True)
    assert got.tolist() == [np.inf, np.inf, 0.0, np.inf, np.inf]
    want, want_it, want_counts = numpy_delta(tg, 2, 2.5, ROOMY, np_dtype)
    assert it == want_it == 2 and {k: stats[k] for k in COUNTS} == want_counts


def test_grid_torus_matches_jax():
    """A small weighted torus (grid_graph): many buckets, the outer WHILE's
    case."""
    jg = j_grid_graph(10, torus=True, seed=4)
    tg = _twin(jg)
    for delta, caps in ((0.3, ROOMY), (0.4, TINY)):
        want, want_it = jsssp.sssp_delta_run(jg, 0, _cfg(delta, caps, JConfig))
        got, it, stats = tsssp.sssp_delta_run(tg, 0, _cfg(delta, caps, device="cpu"),
                                              with_stats=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert it == want_it and stats["buckets"] > 3
        assert {k: stats[k] for k in COUNTS} == numpy_delta(jg, 0, delta, caps, np.float32)[2]


# ---- the step functions' plain versions against the JAX kernel's formulas

def _jax_bucket(dist, inv):
    """graphtpu/algorithms/sssp.py:242-247."""
    b = jnp.floor(dist * inv)
    return jnp.where(b >= jnp.asarray(2**31 - 1, dist.dtype), jnp.int32(INT32_INF),
                     b.astype(jnp.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bucket_matches_jax(dtype):
    np_dtype, _ = DTYPES[dtype]
    rng = np.random.default_rng(5)
    for delta in (2.5, 0.3, 1e-3):
        inv = np_dtype(1.0 / delta)
        # multiples of delta and their neighbours, random values, infinity,
        # and values whose bucket overflows int32
        base = np.arange(50) * np_dtype(delta)
        d = np.concatenate([base, np.nextafter(base, np_dtype(np.inf)),
                            np.nextafter(base, np_dtype(0)),
                            rng.random(200) * 40, [np.inf, 2.0**31 * delta, 2.0**40,
                                                   (2.0**31 - 1) * delta]]).astype(np_dtype)
        want = np.asarray(_jax_bucket(jnp.asarray(d), jnp.asarray(inv)))
        got = tf.delta_bucket_plain(torch.from_numpy(d), float(inv)).numpy()
        np.testing.assert_array_equal(got, want)


def _graph_state(seed=6, n=200):
    """A weighted graph's light and heavy classes at delta 0.5, distances
    with a few infinite, a changed mask and a bucket k that holds vertices."""
    jg = j_rmat_graph(7, 6, directed=True, weighted=True, seed=seed)
    tg = _twin(jg)
    light, heavy = tsssp.sssp_delta_prep(tg, 0.5, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    dist = (rng.random(tg.n) * 3).astype(np.float32)
    dist[rng.random(tg.n) < 0.1] = np.inf
    changed = rng.random(tg.n) < 0.4
    return jg, tg, light, heavy, dist, changed


@pytest.mark.parametrize("caps", [ROOMY, (12, 40)], ids=["roomy", "tight"])
@pytest.mark.parametrize("light_class", [True, False], ids=["light", "heavy"])
def test_derive_and_route_match_jax_derive(caps, light_class):
    """K14's bucket mode and K24's derive stages: JAX's derive_light
    (:258-261) and derive_heavy (:294-297): ids, fits, any; then the phase
    conditions (:266-268, :285-287, :305-308, :324-327)."""
    k_cap, e_cap = caps
    _, tg, light, heavy, dist, changed = _graph_state()
    csr = light if light_class else heavy
    inv = np.float32(2.0)
    for k in range(4):
        active = _jax_bucket(jnp.asarray(dist), jnp.asarray(inv)) == k
        if light_class:
            active = active & jnp.asarray(changed)
        ids_j, cnt = jf.compact(active, k_cap)
        fe = jnp.sum(jnp.where(active, jnp.asarray(csr.deg_pad.numpy()[:-1]), 0),
                     dtype=jnp.int32)
        fits = bool((cnt <= k_cap) & (fe <= e_cap))
        ctl = torch.zeros(tsssp.DCTL_WORDS, dtype=torch.int32)
        ctl[tsssp.DCTL_K], ctl[tsssp.DCTL_IT], ctl[tsssp.DCTL_LIMIT] = k, 3, 10
        ids = torch.full((k_cap,), tg.n, dtype=torch.int32)
        tf.compact_bucket_into(torch.from_numpy(dist), float(inv), ctl[:1],
                               torch.from_numpy(changed) if light_class else None, csr.deg_pad,
                               ids, ctl[tsssp.DCTL_CNT:tsssp.DCTL_FE + 1])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        assert int(ctl[tsssp.DCTL_CNT]) == int(cnt)
        stage = tsssp.DSTAGE_DERIVE_LIGHT if light_class else tsssp.DSTAGE_DERIVE_HEAVY
        tsssp.sssp_delta_route_plain(torch.from_numpy(dist), torch.from_numpy(changed),
                                     torch.zeros(1, dtype=torch.int32), ctl, stage, float(inv),
                                     10, k_cap, e_cap)
        c = ctl[tsssp.DCTL_COND:tsssp.DCTL_COUNTS].tolist()
        if light_class:
            any_a = int(cnt) > 0
            assert c[1:4] == [any_a, any_a and fits, any_a and not fits]
            assert int(ctl[tsssp.DCTL_COUNTS]) == 1  # a bucket begun
        else:
            assert c[4:6] == [fits, not fits]
    ctl[tsssp.DCTL_IT] = 10  # at the limit nothing runs
    tsssp.sssp_delta_route_plain(torch.from_numpy(dist), torch.from_numpy(changed),
                                 torch.zeros(1, dtype=torch.int32), ctl, tsssp.DSTAGE_LIGHT,
                                 float(inv), 10, k_cap, e_cap)
    assert ctl[tsssp.DCTL_COND:tsssp.DCTL_COND + 6].tolist()[1:4] == [0, 0, 0]


@pytest.mark.parametrize("light_class", [True, False], ids=["light", "heavy"])
def test_settle_matches_jax_relax_frontier(light_class):
    """K8's settle mode: JAX's relax_frontier (:249-256) and
    ``changed.at[ids].set(False, mode="drop") | improved`` (:277, :321)."""
    jg, tg, light, heavy, dist, changed = _graph_state(seed=8)
    csr = light if light_class else heavy
    n, k_cap, e_cap = tg.n, 64, 1 << 12
    inv = np.float32(2.0)
    mask = np.asarray(_jax_bucket(jnp.asarray(dist), jnp.asarray(inv)) == 1) & changed
    ids_j, _ = jf.compact(jnp.asarray(mask), k_cap)
    a = {f: jnp.asarray(getattr(csr, f).numpy()) for f in ("deg_pad", "indptr", "dst", "w")}
    exp = jf.expand(ids_j, a["deg_pad"], a["indptr"], a["dst"], e_cap)
    du = j_table_gather(jnp.asarray(dist), jnp.where(exp.valid, exp.row_ids, 0))
    cand = du + j_table_gather(a["w"], exp.gpos)
    targets = jnp.where(exp.valid, exp.neigh, jnp.int32(n))
    new = jnp.asarray(dist).at[targets].min(jnp.where(exp.valid, cand, jnp.inf), mode="drop")
    want_changed = jnp.asarray(changed).at[ids_j].set(False, mode="drop") | (new < dist)
    d, ch = torch.from_numpy(dist.copy()), torch.from_numpy(changed.copy())
    ids = torch.from_numpy(np.array(ids_j))
    texp = tf.expand(ids, csr.deg_pad, csr.indptr, csr.dst, e_cap, with_row_ids=False)
    tf.relax_min_settle(d, ids, texp, csr.w, ch)
    np.testing.assert_array_equal(d.numpy(), np.asarray(new))
    np.testing.assert_array_equal(ch.numpy(), np.asarray(want_changed))
    assert (np.asarray(new) < dist).any()
    # a class without edges: only the frontier's marks clear
    ch = torch.from_numpy(changed.copy())
    tf.relax_min_settle(torch.from_numpy(dist.copy()), ids, None, csr.w, ch)
    np.testing.assert_array_equal(
        ch.numpy(), np.asarray(jnp.asarray(changed).at[ids_j].set(False, mode="drop")))


def test_advance_and_init_match_jax():
    """K24's advance: ``k_next = min(where(bucket(dist) > k, bucket(dist),
    imax))`` (:358-359) and the outer condition (:336-337); its init: dist0
    with the source at 0, changed0 (:339-340)."""
    _, tg, _, _, dist, changed = _graph_state(seed=9)
    inv = np.float32(2.0)
    b = _jax_bucket(jnp.asarray(dist), jnp.asarray(inv))
    for k, it in ((0, 0), (2, 5), (5, 7), (int(np.asarray(b[b < INT32_INF]).max()), 1)):
        want = int(jnp.min(jnp.where(b > k, b, jnp.int32(INT32_INF))))
        ctl = torch.zeros(tsssp.DCTL_WORDS, dtype=torch.int32)
        ctl[tsssp.DCTL_K], ctl[tsssp.DCTL_IT], ctl[tsssp.DCTL_LIMIT] = k, it, 6
        tsssp.sssp_delta_route_plain(torch.from_numpy(dist), torch.from_numpy(changed),
                                     torch.zeros(1, dtype=torch.int32), ctl,
                                     tsssp.DSTAGE_ADVANCE, float(inv), 6, 4, 16)
        assert int(ctl[tsssp.DCTL_K]) == want
        assert int(ctl[tsssp.DCTL_COND]) == int(want < INT32_INF and it < 6)
    d, ch = torch.zeros(tg.n), torch.ones(tg.n, dtype=torch.bool)
    ctl = torch.full((tsssp.DCTL_WORDS,), 7, dtype=torch.int32)
    tsssp.sssp_delta_route_plain(d, ch, torch.tensor([3], dtype=torch.int32), ctl,
                                 tsssp.DSTAGE_INIT, float(inv), 40, 4, 16)
    want_d = np.full(tg.n, np.inf, np.float32)
    want_d[3] = 0
    np.testing.assert_array_equal(d.numpy(), want_d)
    assert ch.nonzero().flatten().tolist() == [3]
    assert ctl.tolist() == [0, 0, 40, 0, 0, 1] + [0] * 10


def test_nest_walks_the_jax_loops_order():
    """The nest: init, then WHILE outer { derive_light, WHILE inner { WHILE
    light_active {light}, WHILE light_dense {dense_light} }, derive_heavy,
    IF heavy_active {heavy}, IF heavy_dense {dense_heavy}, advance }, its six
    conditions each once."""
    from graphtpu_torch.ops import device_loop

    assert device_loop.conditions(tsssp.DELTA_NEST) == 6
    st = tsssp._delta_state(tsssp.sssp_prep(_twin(j_rmat_graph(5, 4, weighted=True, seed=1)),
                                            torch.float32, "cpu"), 32, 8, handles=False)
    assert [name for name, _ in tsssp._delta_steps(None, None, None, st, 1.0, 8, 64)] == [
        "init", "derive_light", "light", "dense_light", "derive_heavy", "heavy", "dense_heavy",
        "advance"]
