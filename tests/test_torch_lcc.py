"""graphtpu_torch's LCC against the JAX package, on the CPU: the edge hash,
the oriented wedge plan, the two LCC paths and the slice as a whole.

Both packages get the same graph (the JAX package's generators, handed over
as numpy arrays). Everything here is integers, so every comparison is
``assert_array_equal``: hash rows, tables, spill masks, plans, credits and
numerators. The coefficients are held to ``assert_array_equal`` too: both
sides divide the same int64 numerators by the same degrees in numpy float64.
The JAX side runs as its own tests run it on the CPU (plain jit, no Pallas
kernel is on this path). On the CPU the port's kernel wrappers (K9
``edgehash_probe``, K10 ``wedge_rowblock``, K1 ``gather_rows``) take their
plain versions; K10 closes a wedge by a search of the plan's closing CSR, not
by the hash probe of its plain version, so a numpy model of that rule is held
against the plain version, and a model of K10's dealing of work over blocks,
warps and list pieces, written from the constants in its source, stands in
for the kernel's index arithmetic, which only the card can run.
"""

import logging
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.core.graph import Graph as JGraph
from graphtpu.ops import edgehash as jeh
from graphtpu.ops import triangles as jtri
from graphtpu.ops.slab import optimal_bucket_bounds as j_optimal_bucket_bounds
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph
from graphtpu.utils.synth import uniform_graph as j_uniform_graph

from graphtpu_torch.algorithms import lcc as tlcc
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ops import edgehash as teh
from graphtpu_torch.ops import triangles as ttri
from graphtpu_torch.ops.slab import optimal_bucket_bounds
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDENS = ["example-directed", "example-undirected", "test-lcc-directed", "test-lcc-undirected"]
CPU = PlatformConfig(device="cpu")


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


def _structured():
    """Triangle + pendant + isolate (tests/test_triangles.py), an edgeless
    graph, and a star, whose every oriented out-degree is below 2."""
    tri = (5, [0, 1, 2, 1, 2, 0, 3], [1, 2, 0, 0, 1, 2, 0])
    edgeless = (4, [], [])
    star = (9, [0] * 8, list(range(1, 9)))
    out = {}
    for name, (n, src, dst) in (("triangle", tri), ("edgeless", edgeless), ("star", star)):
        jg = JGraph(n, np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64), None,
                    np.arange(n, dtype=np.uint64), directed=True, weighted=False)
        out[name] = jg
    return out


GRAPHS = {
    "rmat-directed-0": lambda: j_rmat_graph(8, 10, directed=True, seed=0),
    "rmat-directed-4": lambda: j_rmat_graph(8, 10, directed=True, seed=4),
    "rmat-undirected-0": lambda: j_rmat_graph(8, 10, directed=False, seed=0),
    "rmat-undirected-4": lambda: j_rmat_graph(8, 10, directed=False, seed=4),
    "uniform": lambda: j_uniform_graph(300, 4000, directed=True, seed=9),
    "triangle": lambda: _structured()["triangle"],
    "edgeless": lambda: _structured()["edgeless"],
    "star": lambda: _structured()["star"],
}


def _random_keys(seed, size=5000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 40, size=size, dtype=np.int64))
    return keys, rng.integers(1, 3, size=keys.shape[0], dtype=np.int64)


# ---------------- edge hash ----------------


def test_edge_hash_roundtrip_and_absent_keys():
    keys, payload = _random_keys(0)
    eh, spilled = teh.build_edge_hash(keys, payload)
    assert not spilled.any()
    found, pay = teh.probe_edge_hash(eh, torch.from_numpy(keys))
    assert bool(found.all())
    np.testing.assert_array_equal(pay.numpy(), payload)
    absent = (keys[:100] + 1)[~np.isin(keys[:100] + 1, keys)]
    f2, p2 = teh.probe_edge_hash(eh, torch.from_numpy(absent).reshape(-1, 1))
    assert f2.shape == (absent.shape[0], 1) and not bool(f2.any()) and not bool(p2.any())


def test_edge_hash_spill_at_tiny_fill():
    """An overfull table spills; the spilled keys are absent, the rest
    probe right, and the mask equals the JAX package's."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 40, size=4000, dtype=np.int64))
    payload = np.ones(keys.shape[0], dtype=np.int64)
    eh, spilled = teh.build_edge_hash(keys, payload, fill=8.0)  # a mean of 64 keys a row
    assert spilled.any()
    found = teh.probe_edge_hash(eh, torch.from_numpy(keys))[0].numpy()
    assert not found[spilled].any() and found[~spilled].all()
    np.testing.assert_array_equal(spilled, jeh.build_edge_hash(keys, payload, fill=8.0)[1])


def test_hash_rows_match_host_hash_and_jax():
    """The port's rows (int64 arithmetic in 16-bit pieces) against the
    uint32 host hash, on halves with every high bit set and clear."""
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 1 << 32, size=20000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size=20000, dtype=np.uint64).astype(np.uint32)
    lo[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    hi[:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0, 0x80000000]
    for rows in (16, 1 << 10, 1 << 21, 1 << 31):
        want = teh._host_hash(lo, hi, rows)
        np.testing.assert_array_equal(want, jeh._host_hash(lo, hi, rows))
        got = teh._hash_rows(torch.from_numpy(lo.astype(np.int64)),
                             torch.from_numpy(hi.astype(np.int64)), rows)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill", [0.25, 8.0])
def test_tables_equal_host_device_and_jax(fill):
    keys, payload = _random_keys(3, size=30000)
    j_table, j_spilled = jeh.build_edge_hash(keys, payload, fill=fill)
    host, host_spilled = teh.build_edge_hash(keys, payload, fill=fill)
    dev, dev_spilled = teh.build_edge_hash_device(
        torch.from_numpy(keys), torch.from_numpy(payload.astype(np.int32)), fill=fill)
    jd_table, jd_spilled = jeh.build_edge_hash_device(
        jnp.asarray(keys), jnp.asarray(payload.astype(np.int32)), fill=fill)
    assert host.rows == dev.rows == j_table.rows == jd_table.rows
    for table in (host.table, dev.table):
        np.testing.assert_array_equal(table.numpy(), np.asarray(j_table.table))
        np.testing.assert_array_equal(table.numpy(), np.asarray(jd_table.table))
    for spilled in (host_spilled, dev_spilled, jd_spilled):
        np.testing.assert_array_equal(spilled, j_spilled)
    assert j_spilled.any() == (fill == 8.0)


def test_probe_xy_matches_jax_and_all_ones_key_misses():
    """Pair keys whose shift wraps past 32 bits (id_bits 20, ids up to
    2^20), against the JAX probe; the key of all-ones halves matches no empty
    slot."""
    rng = np.random.default_rng(4)
    id_bits = 20
    x = rng.integers(0, 1 << id_bits, size=3000).astype(np.int32)
    y = rng.integers(0, 1 << id_bits, size=3000).astype(np.int32)
    keys = np.unique((x.astype(np.int64) << id_bits) | y)
    payload = rng.integers(1, 3, size=keys.shape[0])
    eh, _ = teh.build_edge_hash(keys, payload)
    j_eh, _ = jeh.build_edge_hash(keys, payload)
    px = np.concatenate([x[:1500], rng.integers(0, 1 << id_bits, size=1500).astype(np.int32)])
    py = np.concatenate([y[:1500], rng.integers(0, 1 << id_bits, size=1500).astype(np.int32)])
    found, pay = teh.probe_edge_hash_xy(eh, torch.from_numpy(px).reshape(30, 100),
                                        torch.from_numpy(py).reshape(30, 100), id_bits)
    j_found, j_pay = jeh.probe_edge_hash_xy(j_eh, jnp.asarray(px), jnp.asarray(py), id_bits)
    np.testing.assert_array_equal(found.numpy().reshape(-1), np.asarray(j_found))
    np.testing.assert_array_equal(pay.numpy().reshape(-1), np.asarray(j_pay))
    assert found.numpy().reshape(-1)[:1500].all()
    ones = torch.full((3,), -1, dtype=torch.int32)
    f, p = teh.edgehash_probe(eh, ones, ones)
    assert not bool(f.any()) and not bool(p.any())


def test_k9_partition_size_and_size_rule():
    """A partition holds about K9_CHUNK / 2 of the call's probes, and a table
    has at most K9_MAX_PARTS of them; the probes are binned from
    K9_BIN_MIN_PROBES on, and only where they are at least the table's rows."""
    half = teh.K9_CHUNK // 2
    assert teh.k9_partition_shift(1 << 21, 1 << 22) == 10        # 2,048 probes a partition
    assert teh.k9_parts(1 << 21, 10) == 2048
    assert (1 << teh.k9_partition_shift(1 << 16, 1 << 20)) * (1 << 20) // (1 << 16) == half
    assert teh.k9_parts(1 << 30, teh.k9_partition_shift(1 << 30, 1 << 26)) == teh.K9_MAX_PARTS
    assert teh.k9_partition_shift(1 << 4, 1 << 24) == 0            # a partition of one row
    assert teh.k9_partition_shift(1 << 4, 1) == 4                  # the whole table
    m = teh.K9_BIN_MIN_PROBES
    assert teh.k9_bins(1 << 16, m) and not teh.k9_bins(1 << 16, m - 1)
    assert teh.k9_bins(m, m) and not teh.k9_bins(2 * m, 2 * m - 1)


@pytest.mark.parametrize("pshift", [0, 3, 6])
def test_k9_bin_plan_reorders_probes(pshift):
    """The bin order is a permutation under which the partitions (row >>
    pshift) do not decrease; probing in bin order and taking each probe's
    result from its place there gives _probe_lanes's results, which are the
    JAX package's."""
    keys, payload = _random_keys(6, size=20000)
    eh, _ = teh.build_edge_hash(keys, payload)
    j_eh, _ = jeh.build_edge_hash(keys, payload)
    rng = np.random.default_rng(6)
    probes = np.where(rng.random(30001) < 0.5, rng.choice(keys, 30001),
                      rng.integers(0, 1 << 40, 30001, dtype=np.int64))
    klo = torch.from_numpy((probes & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    khi = torch.from_numpy((probes >> 32).astype(np.int32))
    perm = teh.probe_bin_plan(eh, klo, khi, pshift)
    assert torch.equal(torch.sort(perm).values, torch.arange(perm.shape[0]))
    part = teh._hash_rows(klo.long() & teh._U32, khi.long() & teh._U32, eh.rows) >> pshift
    assert bool((part[perm].diff() >= 0).all())
    assert int(part.unique().numel()) > 1
    bklo, bkhi, pos, starts = teh.edgehash_bin(eh, klo, khi, pshift)  # the CPU: the plan's
    assert torch.equal(bklo, klo[perm]) and torch.equal(bklo[pos.long()], klo)
    np.testing.assert_array_equal(starts.numpy(), np.searchsorted(part[perm].numpy(),
                                                                  np.arange(starts.numel())))
    b_found, b_pay = teh._probe_lanes(eh, bklo, bkhi)
    found, pay = b_found[pos.long()], b_pay[pos.long()]
    want_found, want_pay = teh._probe_lanes(eh, klo, khi)
    assert torch.equal(found, want_found) and torch.equal(pay, want_pay)
    assert bool(found.any()) and not bool(found.all())
    j_found, j_pay = jeh.probe_edge_hash(j_eh, jnp.asarray(probes))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(j_pay))


def test_wrappers_refuse_bad_arguments():
    keys, payload = _random_keys(5, size=200)
    eh, _ = teh.build_edge_hash(keys, payload)
    k32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="1-D int32"):
        teh.edgehash_probe(eh, k32.long(), k32)
    with pytest.raises(TypeError, match="1-D int32"):
        teh.edgehash_probe(eh, k32, k32[:3])
    with pytest.raises(TypeError, match="contiguous int32"):
        teh.edgehash_probe(teh.EdgeHash(eh.table[:, :64], eh.rows), k32, k32)
    with pytest.raises(ValueError, match="power of two"):
        teh.edgehash_probe(teh.EdgeHash(eh.table, eh.rows + 1), k32, k32)
    with pytest.raises(ValueError, match="id_bits"):
        teh.probe_edge_hash_xy(eh, k32, k32, 32)
    slab = torch.zeros((3, 4), dtype=torch.int32)
    cl = ttri.ClosingCSR(torch.zeros(33, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.uint8))
    with pytest.raises(TypeError, match="2-D int32"):
        ttri.wedge_rowblock(slab.long(), slab, eh, 5, 4, cl)
    with pytest.raises(ValueError, match="one shape"):
        ttri.wedge_rowblock(slab, slab[:2], eh, 5, 4, cl)
    with pytest.raises(ValueError, match="chunk_cols"):
        ttri.wedge_rowblock(slab, slab, eh, 5, 3, cl)
    with pytest.raises(ValueError, match="outside"):
        ttri.wedge_rowblock(torch.zeros((4097, 1), dtype=torch.int32),
                            torch.zeros((4097, 1), dtype=torch.int32), eh, 5, 1, cl)
    with pytest.raises(TypeError, match="closing CSR"):
        ttri.wedge_rowblock(slab, slab, eh, 5, 4, cl._replace(mult=cl.mult.int()))
    with pytest.raises(TypeError, match="closing CSR"):
        ttri.wedge_rowblock(slab, slab, eh, 5, 4, cl._replace(indptr=cl.indptr.long()))
    with pytest.raises(ValueError, match="multiplicities"):
        ttri.wedge_rowblock(slab, slab, eh, 5, 4,
                            cl._replace(ids=torch.zeros(2, dtype=torch.int32)))
    wu, we = ttri.wedge_rowblock(slab, slab, eh, 5, 4, cl)
    assert not wu.any() and not we.any()


# ---------------- bucket bounds and the wedge plan ----------------


@pytest.mark.parametrize("kind,k,lo", [("pairs", 16, 1), ("pairs", 4, 1), ("elements", 10, 0)])
def test_optimal_bucket_bounds_match_jax(kind, k, lo):
    """On the oriented out-degrees of an RMAT graph and on a heavy-tailed
    sample with more distinct degrees than buckets."""
    plan = jtri.prepare_wedge_plan(j_rmat_graph(10, 8, directed=False, seed=7))
    d_plus = np.bincount(plan.ex, minlength=plan.n)
    rng = np.random.default_rng(0)
    tail = np.minimum((rng.pareto(1.2, size=20000) * 4).astype(np.int64), 4096)
    for deg in (d_plus, tail, np.array([0, 1, 2, 2, 3, 7, 7, 9]), np.array([1, 1, 0])):
        want = j_optimal_bucket_bounds(deg, k=k, kind=kind, lo=lo)
        assert optimal_bucket_bounds(deg, k=k, kind=kind, lo=lo) == want
    assert ttri._optimal_bucket_bounds(tail) == jtri._optimal_bucket_bounds(tail)
    assert ttri._optimal_bucket_bounds(np.array([0, 1, 2, 2, 3, 7, 7, 9])) == [2, 3, 7, 9]
    with pytest.raises(ValueError, match="unknown kind"):
        optimal_bucket_bounds(tail, kind="squares")


def _port_plan(jplan):
    """A JAX WedgePlan, its device arrays as numpy, as the port's."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    buckets = tuple(
        ttri.WedgeBucket(np.asarray(b.rows), t(b.slab), t(b.mslab), b.r_real, b.chunk_cols)
        for b in jplan.buckets
    )
    has = bool(buckets)
    return ttri.WedgePlan(
        buckets, jplan.n, jplan.id_bits, jplan.deg_s, jplan.rank,
        teh.EdgeHash(t(jplan.ehash.table), jplan.ehash.rows),
        t(jplan.edge_pos) if has else None, t(jplan.head_indptr) if has else None,
        torch.from_numpy(np.concatenate([b.rows for b in buckets])) if has else None,
        jplan.ex, jplan.ey, jplan.mult, jplan.spilled,
        ttri.closing_csr(t(jplan.ex), t(jplan.ey), t(jplan.mult), jplan.spilled, jplan.n),
    )


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def plans(request):
    jg = j_rmat_graph(9, 10, directed=request.param, seed=7)
    return jg, jtri.prepare_wedge_plan(jg), ttri.prepare_wedge_plan(_twin(jg), device="cpu")


def test_wedge_plan_matches_jax(plans):
    _, jplan, tplan = plans
    assert (tplan.n, tplan.id_bits) == (jplan.n, jplan.id_bits)
    for name in ("deg_s", "rank", "ex", "ey", "mult", "spilled"):
        np.testing.assert_array_equal(getattr(tplan, name), getattr(jplan, name), err_msg=name)
    assert tplan.ehash.rows == jplan.ehash.rows
    np.testing.assert_array_equal(tplan.ehash.table.numpy(), np.asarray(jplan.ehash.table))
    assert len(tplan.buckets) == len(jplan.buckets) > 1
    for tb, jb in zip(tplan.buckets, jplan.buckets):
        assert (tb.r_real, tb.chunk_cols) == (jb.r_real, jb.chunk_cols)
        assert tuple(tb.slab.shape) == tuple(jb.slab.shape)
        np.testing.assert_array_equal(tb.rows, jb.rows)
        np.testing.assert_array_equal(tb.slab.numpy(), np.asarray(jb.slab))
        np.testing.assert_array_equal(tb.mslab.numpy(), np.asarray(jb.mslab))
    np.testing.assert_array_equal(tplan.edge_pos.numpy(), np.asarray(jplan.edge_pos))
    np.testing.assert_array_equal(tplan.head_indptr.numpy(), np.asarray(jplan.head_indptr))
    np.testing.assert_array_equal(tplan.bucket_rows.numpy(),
                                  np.concatenate([b.rows for b in jplan.buckets]))


def test_rowblock_and_aggregate_match_jax_on_jax_plan(plans):
    """K10's plain version and the head aggregation on the JAX package's
    own plan, bucket by bucket, and the numerator from either plan."""
    _, jplan, tplan = plans
    from_jax = _port_plan(jplan)
    pair_cache = {}
    flat_j, flat_t = [], []
    for jb, tb in zip(jplan.buckets, from_jax.buckets):
        _, rc, pc, pairs, _ = jtri.bucket_probe_schedule(jb, "rowblock", 1 << 30, pair_cache)
        ju, je = jtri._wedge_bucket_rowblock(jb.slab, jb.mslab, jplan.ehash, jplan.id_bits,
                                             *pairs, rc, pc)
        w = tb.slab.shape[0]
        assert ttri.plain_pair_chunk(w, tb.chunk_cols) == pc
        tu, te = ttri._wedge_bucket_rowblock(
            tb.slab, tb.mslab, from_jax.ehash, from_jax.id_bits,
            *ttri._pair_list_padded(w, pc, "cpu"), rc, pc)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        wu, we = ttri.wedge_rowblock(tb.slab, tb.mslab, from_jax.ehash, from_jax.id_bits,
                                     tb.chunk_cols, from_jax.closing)
        assert torch.equal(wu, tu) and torch.equal(we, te)
        flat_j.append(je.reshape(-1))
        flat_t.append(te.reshape(-1))
    want = jtri._aggregate_heads(jnp.concatenate(flat_j), jplan.edge_pos, None,
                                 jplan.head_indptr)
    got = ttri._aggregate_heads(torch.cat(flat_t), from_jax.edge_pos, from_jax.head_indptr)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    numerator = jtri.lcc_oriented_numerator(jplan)
    np.testing.assert_array_equal(ttri.lcc_oriented_numerator(from_jax), numerator)
    np.testing.assert_array_equal(ttri.lcc_oriented_numerator(tplan), numerator)


# ---------------- the closing CSR and K10's closing rule ----------------


def _forced_spill_plan(monkeypatch, tg):
    """The port's plan of ``tg`` with a hash built to spill heavily (the
    build is swapped in the module where prepare_wedge_plan looks it up)."""
    orig = teh.build_edge_hash_device
    monkeypatch.setattr(teh, "build_edge_hash_device",
                        lambda k, p, fill=0.25: orig(k, p, fill=64.0))
    plan = ttri.prepare_wedge_plan(tg, device="cpu")
    monkeypatch.setattr(teh, "build_edge_hash_device", orig)
    assert plan.spilled.any(), "expected forced spills"
    return plan


def _three_plans(plans, monkeypatch):
    jg, jplan, tplan = plans
    return {"port": tplan, "jax": _port_plan(jplan),
            "forced-spill": _forced_spill_plan(monkeypatch, _twin(jg))}


def test_closing_csr_holds_the_hash_keys(plans, monkeypatch):
    """Every non-spilled key of the oriented stream is in the closing CSR
    with payload = mult, every spilled key is absent, each list ascends, and
    the hash finds every key of the CSR with the same payload."""
    for name, plan in _three_plans(plans, monkeypatch).items():
        indptr, ids, mult = (t.numpy() for t in plan.closing)
        assert (indptr.dtype, ids.dtype, mult.dtype) == (np.int32, np.int32, np.uint8), name
        assert indptr.shape == (plan.n + 1,) and indptr[0] == 0 and indptr[-1] == ids.shape[0]
        tails = np.repeat(np.arange(plan.n), np.diff(indptr))
        keys = (tails.astype(np.int64) << plan.id_bits) | ids
        assert (np.diff(keys) > 0).all(), name  # ascending by (tail, head): each list ascends
        stream = (plan.ex << plan.id_bits) | plan.ey
        keep = ~plan.spilled
        np.testing.assert_array_equal(keys, stream[keep], err_msg=name)
        np.testing.assert_array_equal(mult, plan.mult[keep], err_msg=name)
        assert not np.isin(stream[plan.spilled], keys).any(), name
        found, pay = teh.probe_edge_hash(plan.ehash, torch.from_numpy(keys))
        assert bool(found.all()), name
        np.testing.assert_array_equal(pay.numpy(), mult, err_msg=name)
        assert (name == "forced-spill") == bool(plan.spilled.any())


def _closing_rule_credits(slab, mslab, closing):
    """K10's rule in numpy: for each real entry i of a row, each later entry
    y is searched in out(x) of the closing CSR, x = slab[i]; a hit credits
    the row, i and j as the kernel does."""
    indptr, ids, mult = (t.numpy().astype(np.int64) for t in closing)
    w, r = slab.shape
    u = np.zeros(r, dtype=np.int64)
    e = np.zeros((w, r), dtype=np.int64)
    for c in range(r):
        row = slab[:, c][slab[:, c] >= 0]
        for i in range(row.shape[0] - 1):
            lst = ids[indptr[row[i]]:indptr[row[i] + 1]]
            later = row[i + 1:]
            pos = np.minimum(np.searchsorted(lst, later), max(lst.shape[0] - 1, 0))
            hit = (lst[pos] == later) if lst.shape[0] else np.zeros(later.shape, bool)
            j = i + 1 + np.nonzero(hit)[0]
            u[c] += mult[indptr[row[i]] + pos[hit]].sum()
            e[i, c] += mslab[j, c].sum()
            e[j, c] += mslab[i, c]
    return u.astype(np.int32), e.astype(np.int32)


def test_closing_rule_equals_the_plain_rowblock(plans, monkeypatch):
    """The closing-CSR search and the plain version's hash probe give the
    same credits bit for bit, bucket by bucket, on the port's plan, on the
    JAX package's own plan and on a plan whose hash spilled; the spilled
    keys' triangles are left to the host patch by both."""
    for name, plan in _three_plans(plans, monkeypatch).items():
        assert plan.buckets, name
        for b in plan.buckets:
            want = ttri.wedge_rowblock(b.slab, b.mslab, plan.ehash, plan.id_bits,
                                       b.chunk_cols, plan.closing)
            got = _closing_rule_credits(b.slab.numpy(), b.mslab.numpy(), plan.closing)
            np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg=name)
            np.testing.assert_array_equal(got[1], want[1].numpy(), err_msg=name)
    np.testing.assert_array_equal(ttri.lcc_oriented_numerator(plan),
                                  tlcc.lcc_sweep_numerator(_twin(plans[0]), "cpu")[0])


# ---------------- a model of K10's dealing of work ----------------


def _k10_constants():
    src = (REPO / "graphtpu_torch" / "csrc" / "wedge_rowblock.cu").read_text()
    val = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    return (val("K10_THREADS"), val("K10_ITEMS"), val("K10_UNROLL"), val("K10_SLOTS"),
            val("K10_FILTER"), val("K10_MAX_WIDTH"))


def _k10_hash(v, lr):
    return ((v * 0x9E3779B1) ^ (lr * 0x85EBCA77)) & 0xFFFFFFFF


def _k10_walk(w, rows, lists):
    """Every item (row, i) the kernel takes, every list entry each item
    probes and every hit (row, i, j), by the kernel's own arithmetic: the
    host's rows per block, chunks and hash size, a block's item range and
    early return, its filter and hash of (row, id) with linear probing, and a warp's
    pieces of out(x) with the stop past the row's largest id. ``rows`` are
    the rows' real ids, ``lists`` the ascending out-lists by id."""
    threads, max_items, unroll, slots_per, filter_per, max_width = _k10_constants()
    assert 2 <= w <= max_width
    r = len(rows)
    rpb = min(1 if w >= max_items else max_items // w, r)
    held_max = rpb * w
    chunks = -(-held_max // max_items)
    ipc = -(-held_max // chunks)
    bits, fbits = 3, 5
    while (1 << bits) < slots_per * held_max:
        bits += 1
    while (1 << fbits) < filter_per * held_max:
        fbits += 1
    shift, mask, fshift = 32 - bits, (1 << bits) - 1, 32 - fbits
    smem = held_max * 9 + (4 << bits) + (1 << (fbits - 3)) + rpb * 12 + 4
    assert smem <= 232448  # the block's shared memory
    piece = 32 * unroll
    items, probes, hits = [], [], []
    for block in range(-(-r // rpb) * chunks):
        group, chunk = divmod(block, chunks)
        r0 = group * rpb
        nrows = min(rpb, r - r0)
        t_lo, t_hi = chunk * ipc, min(nrows * w, chunk * ipc + ipc)
        if chunks > 1 and (t_lo + 1 >= w or len(rows[r0]) <= t_lo + 1):
            continue
        ids = [-1] * (rpb * w)
        table = [-1] * (1 << bits)
        filt = set()
        for lr in range(nrows):
            for j, v in enumerate(rows[r0 + lr]):
                ids[lr * w + j] = v
                filt.add(_k10_hash(v, lr) >> fshift)
                s = _k10_hash(v, lr) >> shift
                while table[s] != -1:
                    s = (s + 1) & mask
                table[s] = lr * w + j
        for t in range(t_lo, t_hi):  # the warps' shared counter hands out each once
            lr, i = divmod(t, w)
            row = rows[r0 + lr]
            if i + 1 >= len(row):
                continue
            items.append((r0 + lr, i))
            lst, cut, base = lists[ids[t]], max(row), lr * w
            for p in range(0, len(lst), piece):
                z = [lst[q] if q < len(lst) else -1 for q in range(p, p + piece)]
                for q, zk in zip(range(p, p + piece), z):
                    if zk < 0 or zk > cut:
                        continue
                    probes.append((r0 + lr, i, q))
                    if _k10_hash(zk, lr) >> fshift not in filt:
                        continue
                    s = _k10_hash(zk, lr) >> shift
                    while table[s] >= 0 and (ids[table[s]] != zk or not 0 <= table[s] - base < w):
                        s = (s + 1) & mask
                    if table[s] >= 0 and table[s] - base > i:
                        hits.append((r0 + lr, i, table[s] - base))
                if z[-1] > cut:
                    break
    return items, probes, hits


@pytest.mark.parametrize("w,r", [(2, 1), (2, 3000), (3, 127), (16, 300), (33, 127), (64, 70),
                                 (128, 9), (129, 5), (625, 3), (4096, 1)])
def test_k10_walk_visits_each_real_pair_once(w, r):
    """Rows of random length (the first of W entries) over ids with
    out-lists that are empty, short, or longer than several of a warp's
    pieces, many rows to a block, and rows split over blocks: every item
    (row, i) with a later entry is taken once, every list entry up to the
    row's largest id is probed once, so every (row, i, j), i < j < d, is
    searched exactly once, and the hits are exactly the pairs with y in
    out(x)."""
    unroll = _k10_constants()[2]
    rng = np.random.default_rng(w + r)
    n = 4 * w + 300
    degs = [int(d) for d in rng.integers(0, w + 1, size=r)]
    degs[0] = w
    rows = [sorted(rng.choice(n, size=d, replace=False).tolist()) for d in degs]
    lists = {}
    for x in sorted({v for row in rows for v in row}):
        size = int(rng.choice([0, rng.integers(1, 20), rng.integers(100, 7 * 32 * unroll)],
                              p=[0.3, 0.5, 0.2]))
        lists[x] = np.unique(rng.integers(x + 1, n + 1, size=size)).tolist()
    items, probes, hits = _k10_walk(w, rows, lists)
    want_items = [(c, i) for c in range(r) for i in range(degs[c] - 1)]
    assert len(items) == len(set(items)) == len(want_items) and set(items) == set(want_items)
    want_probes = [(c, i, q) for c, i in want_items
                   for q, z in enumerate(lists[rows[c][i]]) if z <= rows[c][-1]]
    assert len(probes) == len(set(probes)) and set(probes) == set(want_probes)
    sets = {x: set(lst) for x, lst in lists.items()}
    want_hits = [(c, i, j) for c, i in want_items for j in range(i + 1, degs[c])
                 if rows[c][j] in sets[rows[c][i]]]
    assert len(hits) == len(set(hits)) and set(hits) == set(want_hits)
    assert w < 8 or want_hits  # the wide cases find triangles


# ---------------- LCC end to end ----------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_lcc_matches_jax_under_every_impl(name):
    jg = GRAPHS[name]()
    tg = _twin(jg)
    want = j_run_algorithm("lcc", jg, JParams(), JConfig(lcc_impl="sweep")).values
    if name != "edgeless":  # the JAX sweep takes an edgeless graph, its oriented path too
        np.testing.assert_array_equal(
            j_run_algorithm("lcc", jg, JParams(), JConfig()).values, want)
    for impl in ("auto", "oriented", "sweep"):
        got = run_algorithm("lcc", tg, AlgorithmParams(),
                            PlatformConfig(device="cpu", lcc_impl=impl))
        assert got.algorithm == "lcc" and got.values.dtype == np.float64
        np.testing.assert_array_equal(got.values, want, err_msg=impl)
    # numerators, before the division
    sweep_num, deg_s = tlcc.lcc_sweep_numerator(tg, "cpu")
    plan = ttri.wedge_plan(tg, device="cpu")
    np.testing.assert_array_equal(ttri.lcc_oriented_numerator(plan), sweep_num)
    np.testing.assert_array_equal(plan.deg_s, deg_s)
    if name == "triangle":
        assert want[1] == pytest.approx(1.0) and want[0] == pytest.approx(1.0 / 3.0)
        assert want[4] == 0.0
    if name in ("edgeless", "star"):
        assert not plan.buckets and not want.any()


def test_sweep_pieces_match_jax():
    """prepare_lcc, the pad widths and one bucket's sweep against the JAX
    package's (its chunk padding included)."""
    from graphtpu.algorithms import lcc as jlcc

    jg = j_rmat_graph(8, 10, directed=True, seed=4)
    tg = _twin(jg)
    j_prep, t_prep = jlcc.prepare_lcc(jg), tlcc.prepare_lcc(tg)
    for a, b in zip(t_prep, j_prep):
        np.testing.assert_array_equal(a, b)
    for max_deg in (0, 1, 16, 17, 128, 129, 70000):
        assert tlcc._bucket_bounds(max_deg) == jlcc._bucket_bounds(max_deg)
    s_indptr, s_dst, s_deg, c, o, dc = t_prep
    sel = dc <= 16
    iters = max(1, int(np.ceil(np.log2(max(int(s_deg.max()), 2) + 1))))
    padded = -(-int(sel.sum()) // jlcc._CHUNK) * jlcc._CHUNK
    cb, ob = np.full(padded, -1, np.int32), np.full(padded, -1, np.int32)
    cb[:sel.sum()], ob[:sel.sum()] = c[sel], o[sel]
    want = jlcc._lcc_bucket_sweep(jnp.zeros(jg.n, jnp.int32), jnp.asarray(s_indptr),
                                  jnp.asarray(s_dst), jnp.asarray(cb), jnp.asarray(ob), 16, iters)
    t = torch.from_numpy
    got = tlcc._lcc_bucket_sweep(torch.zeros(tg.n, dtype=torch.int64), t(s_indptr), t(s_dst),
                                 t(c[sel]), t(o[sel]), 16, iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


# ---------------- the sweep's c-row plan (K15) ----------------

# the JAX sweep's arrays are padded to one shape, so each pad compiles once
_PAD_N, _PAD_NNZ, _PAD_ITERS = 64, 1024, 10


def _edge_case_graph(name, directed):
    """Both packages' graph from one vertex and edge list (the file loaders'
    relabel, deduplication and, undirected, both directions stored)."""
    if name.startswith("rmat"):
        jg = j_rmat_graph(5, 6, directed=directed, seed=3)
        v, src, dst = jg.mapping, jg.mapping[jg.src], jg.mapping[jg.dst]
    else:
        v = np.arange(100, 100 + 12, dtype=np.int64)
        src, dst = {
            # self-loops, input edges listed twice and both ways, a pendant
            # (degree 1) and isolated vertices (degree 0)
            "loops_dups": ([0, 1, 2, 0, 1, 1, 2, 3, 3, 4, 5, 2, 6, 0, 0],
                           [1, 2, 0, 0, 2, 0, 3, 0, 4, 5, 3, 2, 7, 1, 1]),
            # a 5-clique and a 6-cycle: every endpoint ties in degree
            "ties": ([0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 5, 6, 7, 8, 9, 10],
                     [1, 2, 3, 4, 2, 3, 4, 3, 4, 4, 6, 7, 8, 9, 10, 5]),
            "edgeless": ([], []),
        }[name]
        src, dst = v[np.array(src, dtype=np.int64)], v[np.array(dst, dtype=np.int64)]
    args = (v, np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64), None,
            directed, False)
    return JGraph.from_original_ids(*args), Graph.from_original_ids(*args)


def _jax_sweep_numerator_padded(jg):
    """The JAX package's sweep numerators, bucket by bucket as its _lcc_sweep
    runs them, with the CSR padded by isolated vertices and unused columns
    to one shape (which adds no hit)."""
    from graphtpu.algorithms import lcc as jlcc

    s_indptr, s_dst, s_deg, c, o, dc = jlcc.prepare_lcc(jg)
    assert jg.n <= _PAD_N and s_dst.shape[0] <= _PAD_NNZ and int(s_deg.max(initial=0)) < 1 << 9
    indptr = np.full(_PAD_N + 1, s_indptr[-1], dtype=np.int32)
    indptr[:jg.n + 1] = s_indptr
    col = np.zeros(_PAD_NNZ, dtype=np.int32)
    col[:s_dst.shape[0]] = s_dst
    num = jnp.zeros((_PAD_N,), jnp.int32)
    for pad in jlcc._bucket_bounds(int(s_deg.max(initial=0))):
        sel = (dc > (0 if pad == 16 else pad // 8)) & (dc <= pad)
        if not sel.any():
            continue
        cb, ob = np.full(jlcc._CHUNK, -1, np.int32), np.full(jlcc._CHUNK, -1, np.int32)
        cb[:sel.sum()], ob[:sel.sum()] = c[sel], o[sel]
        num = jlcc._lcc_bucket_sweep(num, jnp.asarray(indptr), jnp.asarray(col), jnp.asarray(cb),
                                     jnp.asarray(ob), pad, _PAD_ITERS)
    return np.asarray(num)[:jg.n].astype(np.int64)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", ["rmat", "loops_dups", "ties", "edgeless"])
def test_sweep_plan_numerators_match_jax(name, directed):
    """The c-row plan through K15's plain version gives the JAX sweep's
    numerators bit for bit: small RMATs, self-loops with input edges listed
    twice and both ways, degree ties, vertices of degree 0 and 1, and an
    edgeless graph. An undirected plan keeps half the A-edges, weight 2."""
    jg, tg = _edge_case_graph(name, directed)
    plan = tlcc.sweep_plan(tg)
    got, deg_s = tlcc.lcc_sweep_numerator(tg, "cpu")
    np.testing.assert_array_equal(got, _jax_sweep_numerator_padded(jg))
    a_edges = int((tg.src != tg.dst).sum())
    assert plan.weight == (1 if directed else 2)
    assert plan.c.shape[0] * plan.weight == a_edges
    assert np.all(plan.c[1:] >= plan.c[:-1])  # runs of equal c, in ascending c
    np.testing.assert_array_equal(deg_s, plan.s_deg)
    if name in ("rmat", "loops_dups", "ties"):
        assert got.max() > 0
    if name == "ties" and not directed:
        assert np.all(got[:5] == 12) and not got[5:11].any()


def test_sweep_plan_numerators_match_jax_when_stored_one_way():
    """An undirected graph built from one direction alone (the Graph
    constructor stores the edges as given, so they are not symmetric) keeps
    every A-edge, weight 1, grouped by c, and gives the JAX sweep's
    numerators on the same arrays. A symmetric edge multiset passes the
    check, this one does not."""
    n = 6
    src, dst = np.array([4, 0, 1, 0, 1, 2, 3]), np.array([5, 1, 2, 2, 3, 3, 4])
    args = (n, src, dst, None, np.arange(n), False, False)
    jg, tg = JGraph(*args), Graph(*args)
    plan = tlcc.sweep_plan(tg)
    assert plan.weight == 1 and plan.c.shape[0] == src.shape[0]
    assert np.all(plan.c[1:] >= plan.c[:-1])
    got = tlcc.lcc_sweep_numerator(tg, "cpu")[0]
    np.testing.assert_array_equal(got, _jax_sweep_numerator_padded(jg))
    assert got.max() > 0
    assert not tlcc.is_symmetric(src, dst, n)
    assert tlcc.is_symmetric(np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1]), 3)


def _item_cover(plan, c):
    """(entry, neighbour position) pairs that K15's items of entries ``c``
    cover, from the item rows alone, as the kernel reads them."""
    items = tlcc.sweep_items(c, plan.s_deg)
    seen = []
    for e0, e1, xoff in items.tolist():
        assert e0 < e1 and np.all(c[e0:e1] == c[e0])
        d = int(plan.s_deg[c[e0]])
        xr = min(32, d - xoff)
        g = 1 << max(xr - 1, 0).bit_length()
        assert 0 <= xoff < d and xoff % 32 == 0 and e1 - e0 <= (32 // g) * tlcc.K15_STEPS
        seen += [(e, xoff + j) for e in range(e0, e1) for j in range(xr)]
    return seen


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 40), directed=st.booleans(),
       edges=st.lists(st.tuples(st.integers(0, 39), st.integers(0, 39)), max_size=120))
def test_sweep_plan_entries_sum_to_the_a_edges(n, directed, edges):
    """Property: the plan's entries (c, o), each counted weight times, are
    prepare_lcc's A-edges as a multiset (undirected: as unordered pairs,
    both directions of a pair making the same searches), and K15's items
    cover every (entry, neighbour of c) once."""
    from collections import Counter

    e = np.array([(a % n, b % n) for a, b in edges], dtype=np.int64).reshape(-1, 2)
    g = Graph.from_original_ids(np.arange(n), e[:, 0], e[:, 1], None, directed, False)
    plan = tlcc.sweep_plan(g)
    _, _, _, c, o, _ = tlcc.prepare_lcc(g)
    key = (lambda a, b: (a, b)) if directed else (lambda a, b: (min(a, b), max(a, b)))
    want = Counter(key(a, b) for a, b in zip(c.tolist(), o.tolist()))
    got = Counter()
    for a, b in zip(plan.c.tolist(), plan.o.tolist()):
        got[key(a, b)] += plan.weight
    assert got == want
    assert np.all(plan.s_deg[plan.c] <= plan.s_deg[plan.o])
    cover = _item_cover(plan, plan.c)
    assert len(cover) == len(set(cover)) == int(plan.s_deg[plan.c].sum())


def test_forced_spills_are_patched_exactly(monkeypatch):
    """The whole oriented pipeline with a hash built to spill heavily: the
    host patch must give the sweep's answer. The build is swapped in the
    port's module, where prepare_wedge_plan looks it up."""
    jg = j_rmat_graph(9, 12, directed=False, seed=2)
    tg = _twin(jg)
    want = j_run_algorithm("lcc", jg, JParams(), JConfig(lcc_impl="sweep")).values
    orig = teh.build_edge_hash_device
    monkeypatch.setattr(teh, "build_edge_hash_device",
                        lambda k, p, fill=0.25: orig(k, p, fill=64.0))
    plan = ttri.prepare_wedge_plan(tg, device="cpu")
    assert plan.spilled.any(), "expected forced spills"
    np.testing.assert_array_equal(ttri.lcc_oriented(tg, device="cpu"), want)
    assert ttri.wedge_plan(tg, device="cpu").spilled.any()


def test_wedge_cache_roundtrip_and_stale_cache(tmp_path):
    jg = j_rmat_graph(10, 8, directed=False, seed=7)
    want = jtri.lcc_oriented(jg)
    np.testing.assert_array_equal(ttri.lcc_oriented(_twin(jg), device="cpu"), want)

    g2 = _twin(jg)
    g2.name = "cachetest"
    np.testing.assert_array_equal(ttri.lcc_oriented(g2, cache_dir=tmp_path, device="cpu"), want)
    cache = tmp_path / "cachetest" / "wedge-v2.npz"
    assert cache.exists()
    # the file is the JAX package's: either reads the other's
    jg2 = j_rmat_graph(10, 8, directed=False, seed=7)
    jg2.name = "cachetest"
    with np.load(cache) as z:
        assert int(z["version"]) == jtri._WEDGE_CACHE_VERSION == ttri._WEDGE_CACHE_VERSION
        np.testing.assert_array_equal(z["ex"], jtri.prepare_wedge_plan(jg2).ex)
    assert jtri._load_oriented_cache(tmp_path, jg2) is not None

    g3 = _twin(jg)
    g3.name = "cachetest"
    plan = ttri.prepare_wedge_plan(g3, cache_dir=tmp_path, device="cpu")  # from the cache
    fresh = ttri.prepare_wedge_plan(_twin(jg), device="cpu")
    np.testing.assert_array_equal(plan.edge_pos.numpy(), fresh.edge_pos.numpy())
    np.testing.assert_array_equal(plan.ehash.table.numpy(), fresh.ehash.table.numpy())
    np.testing.assert_array_equal(ttri.lcc_oriented(g3, cache_dir=tmp_path, device="cpu"), want)

    # another graph under the same name: detected and rebuilt
    jg4 = j_rmat_graph(9, 8, directed=False, seed=1)
    g4 = _twin(jg4)
    g4.name = "cachetest"
    np.testing.assert_array_equal(ttri.lcc_oriented(g4, cache_dir=tmp_path, device="cpu"),
                                  jtri.lcc_oriented(jg4))
    # an unreadable file is rebuilt too
    cache.write_bytes(b"not an npz")
    g5 = _twin(jg4)
    g5.name = "cachetest"
    np.testing.assert_array_equal(ttri.lcc_oriented(g5, cache_dir=tmp_path, device="cpu"),
                                  jtri.lcc_oriented(jg4))


def test_plan_is_memoized_per_device():
    tg = _twin(j_rmat_graph(7, 6, directed=False, seed=1))
    plan = ttri.wedge_plan(tg, device="cpu")
    assert ttri.wedge_plan(tg, device="cpu") is plan
    assert ("wedge_plan", "cpu") in tg.memo
    assert plan.ehash.table.device.type == "cpu"


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_capacity_error_and_logged_fallback(monkeypatch):
    """An oriented out-degree above the widest bucket: ``oriented`` raises,
    ``auto`` logs the JAX package's warning and gives the sweep's answer;
    no other error is caught there."""
    jg = j_rmat_graph(8, 10, directed=False, seed=0)
    want = j_run_algorithm("lcc", jg, JParams(), JConfig(lcc_impl="sweep")).values
    monkeypatch.setattr(ttri, "_MAX_WEDGE_WIDTH", 4)
    with pytest.raises(ttri.WedgeCapacityError, match="exceeds the largest wedge bucket"):
        run_algorithm("lcc", _twin(jg), AlgorithmParams(),
                      PlatformConfig(device="cpu", lcc_impl="oriented"))
    handler = _Records()
    logger = logging.getLogger("graphtpu_torch.lcc")
    logger.addHandler(handler)
    try:
        got = run_algorithm("lcc", _twin(jg), AlgorithmParams(), CPU)
    finally:
        logger.removeHandler(handler)
    np.testing.assert_array_equal(got.values, want)
    assert handler.messages == ["wedge-plan capacity exceeded; falling back to membership sweep"]

    def broken(*args, **kwargs):
        raise ValueError("a real fault")

    monkeypatch.setattr(ttri, "prepare_wedge_plan", broken)
    with pytest.raises(ValueError, match="a real fault"):
        run_algorithm("lcc", _twin(jg), AlgorithmParams(), CPU)
    with pytest.raises(ValueError, match="unknown lcc-impl"):
        run_algorithm("lcc", _twin(jg), AlgorithmParams(),
                      PlatformConfig(device="cpu", lcc_impl="square"))


@pytest.mark.parametrize("impl", ["auto", "sweep"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name, impl):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             lcc_impl=impl))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, "lcc")
    res = plat.run(spec, "lcc")
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-LCC"))
    assert ok, msg
    # the oriented edge list went to the ingest cache under auto only
    assert (tmp_path / spec.name / "wedge-v2.npz").exists() == (impl == "auto")


@pytest.mark.parametrize("impl", ["auto", "sweep"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name, impl):
    props = tmp_path / "platform.properties"
    props.write_text(f"platform.graphtpu.lcc-impl = {impl}\n")
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", "lcc", "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--platform-properties", str(props), "--output-file", str(tmp_path / "out"),
        "--validation-file", str(fixtures_dir / f"{name}-LCC"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out
    first = (tmp_path / "out").read_text().splitlines()[0].split()
    assert re.fullmatch(r"-?\d\.\d{15}e[+-]\d{2}", first[1])  # 16-digit scientific
