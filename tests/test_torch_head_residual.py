"""graphtpu_torch's K16 (LCC's head-credit sums in slab order,
``ops/triangles.py:lcc_head_credits``) and K17 (BFS's residual test,
``ops/frontier.py:residual_claim``) against the JAX package, on the CPU,
where each wrapper runs its plain PyTorch version.

K16's plain version is held against K7's plain ``sum_i64`` over the plan's
head order (``_aggregate_heads`` with ``edge_pos`` and ``head_indptr``) and
against the JAX package's ``_aggregate_heads`` (graphtpu/ops/triangles.py),
each plus the apex credits, on hub-heavy RMAT plans of scales 10 to 12, on
a plan whose first bucket is mostly pad, on an empty plan, and with credits
near 2^31 against numpy's int64 sums; the oriented numerators stay the JAX
package's. K17's plain version is held against the JAX package's claimed
ids (graphtpu/algorithms/bfs.py:230-248: a cumsum of the hits differenced
at the row starts) on one device and over two gloo ranks. Inputs come from
numpy with a seed; every comparison is exact. The JAX plans and sums are
made once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.core.graph import Graph as JGraph
from graphtpu.ops import frontier as jf
from graphtpu.ops import triangles as jtri
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.bfs import BFS_TRUNC
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.ops import triangles as ttri
from graphtpu_torch.parallel import mesh as mesh_mod
from graphtpu_torch.parallel.adaptive_bfs import _build_prep as bfs_prep
from graphtpu_torch.parallel.adaptive_bfs import bfs_adaptive_dist
from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph

from torch_dist_gather import residual_claims, tests_on_worker_path  # noqa: F401
from torch_native_env import jax_native_on_port_build  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


# ---------------------------------------------------------------- K16


def _head_order(slabs):
    """(edge_pos, head_indptr) of slabs as prepare_wedge_plan makes them:
    each real entry's transposed flat position, stably sorted by head."""
    heads, pos, off = [], [], 0
    for s in slabs:  # in the plan's order: row by row of the [R, W] layout
        w, r = s.shape
        heads.append(torch.where(s >= 0, s, INT32_INF).t().reshape(-1))
        tpos = torch.arange(w, dtype=torch.int32)[None, :] * r + torch.arange(r)[:, None]
        pos.append((tpos + off).to(torch.int32).reshape(-1))
        off += s.numel()
    heads_s, pos_s = ttri._head_sort_kernel(torch.cat(heads), torch.cat(pos))
    real = int((heads_s < INT32_INF).sum())
    return pos_s[:real].contiguous(), heads_s[:real]


def _credits(slabs, r_reals, rng, hi):
    """Random edge credits on the real entries (0 at pads, about half 0
    elsewhere, as a plan's are) and apex credits on the real rows."""
    edge, apex = [], []
    for s, r in zip(slabs, r_reals):
        c = rng.integers(0, hi, size=tuple(s.shape)) * (rng.random(tuple(s.shape)) < 0.5)
        edge.append(torch.from_numpy(np.where(s.numpy() >= 0, c, 0).astype(np.int32)))
        apex.append(torch.from_numpy(rng.integers(0, hi, size=r).astype(np.int32)))
    return edge, apex


def _k7_and_jax(n, slabs, edge, apex, rows):
    """The head sums by K7's plain sum_i64 and by the JAX package's
    _aggregate_heads over the head order, each plus the apex credits."""
    edge_pos, heads = _head_order(slabs)
    hip = torch.from_numpy(np.searchsorted(heads.numpy(), np.arange(n + 1)).astype(np.int32))
    flat = torch.cat([c.reshape(-1) for c in edge])
    k7 = ttri._aggregate_heads(flat, edge_pos, hip)
    jax = np.asarray(jtri._aggregate_heads(jnp.asarray(flat.numpy()), jnp.asarray(edge_pos.numpy()),
                                           None, jnp.asarray(hip.numpy()))).astype(np.int64)
    u = torch.cat(apex).long() if apex else torch.zeros(0, dtype=torch.int64)
    k7.index_add_(0, rows, u)
    np.add.at(jax, rows.numpy(), u.numpy())
    return k7, jax, (edge_pos, hip)


@pytest.fixture(scope="module", params=[(10, 16, False), (11, 16, True), (12, 8, False)],
                ids=["s10", "s11-directed", "s12"])
def rmat_plan(request):
    scale, ef, directed = request.param
    jg = j_rmat_graph(scale, ef, directed=directed, seed=scale)
    return jg, ttri.prepare_wedge_plan(_twin(jg), device="cpu")


def test_head_credits_match_k7_and_jax_on_rmat_plans(rmat_plan):
    """Hub-heavy RMAT plans: K16's plain version (slab order, one
    index_add_) equals K7's plain sum_i64 and the JAX package's gather and
    prefix sum over the plan's own head order, apex credits included; the
    hubs sit at the top ids, where K16 keeps its shared-memory window."""
    _, plan = rmat_plan
    slabs = [b.slab for b in plan.buckets]
    rng = np.random.default_rng(plan.n)
    edge, apex = _credits(slabs, [b.r_real for b in plan.buckets], rng, 3)
    k7, jax, (edge_pos, hip) = _k7_and_jax(plan.n, slabs, edge, apex, plan.bucket_rows)
    assert torch.equal(edge_pos, plan.edge_pos) and torch.equal(hip, plan.head_indptr)
    got = ttri.lcc_head_credits(plan.n, slabs, edge, (apex, plan.bucket_rows))
    assert got.dtype == torch.int64 and got.shape == (plan.n,)
    assert torch.equal(got, k7)
    np.testing.assert_array_equal(got.numpy(), jax)
    # the edge part alone, as a rank sums it, is the same sums less the apex
    alone = ttri.lcc_head_credits(plan.n, slabs, edge)
    alone.index_add_(0, plan.bucket_rows, torch.cat(apex).long())
    assert torch.equal(alone, got)
    top = int(torch.argmax(got))
    assert top >= plan.n - plan.n // 8, (top, plan.n)  # hubs are the top ranks


def test_head_credits_keep_the_oriented_numerators_of_jax():
    """The oriented LCC numerators through K16 (K10's plain credits) equal
    the JAX package's on its own plan and on the port's."""
    jg = j_rmat_graph(10, 16, directed=False, seed=3)
    jplan = jtri.prepare_wedge_plan(jg)
    tplan = ttri.prepare_wedge_plan(_twin(jg), device="cpu")
    np.testing.assert_array_equal(ttri.lcc_oriented_numerator(tplan),
                                  jtri.lcc_oriented_numerator(jplan))


def test_head_credits_on_a_mostly_pad_first_bucket():
    """A plan whose first bucket is mostly pad (rows of 2 to 4 entries in
    a width-12 slab, three quarters pad) beside a dense one: K16's plain version against K7 and
    the JAX package's sums over the same head order."""
    rng = np.random.default_rng(12)
    n = 3000
    slabs = []
    for w, r_pad, lo in ((12, 512, 2), (40, 64, 30)):
        deg = rng.integers(lo, min(lo + 2, w) + 1, size=r_pad)
        slab = np.full((w, r_pad), -1, dtype=np.int32)
        for r in range(r_pad):
            slab[:deg[r], r] = np.sort(rng.choice(n, size=deg[r], replace=False))
        slabs.append(torch.from_numpy(slab))
    assert (slabs[0] < 0).float().mean() > 0.7
    r_reals = [500, 60]
    rows = torch.from_numpy(rng.choice(n, size=sum(r_reals), replace=False).astype(np.int64))
    edge, apex = _credits(slabs, r_reals, rng, 5)
    k7, jax, _ = _k7_and_jax(n, slabs, edge, apex, rows)
    got = ttri.lcc_head_credits(n, slabs, edge, (apex, rows))
    assert torch.equal(got, k7)
    np.testing.assert_array_equal(got.numpy(), jax)


def test_head_credits_empty_plan_and_all_pad():
    """No bucket at all, a bucket of pads only, and a graph without wedges
    (a star: every oriented out-degree below 2) whose numerators are 0, as
    the JAX package's."""
    assert torch.equal(ttri.lcc_head_credits(7, [], []), torch.zeros(7, dtype=torch.int64))
    pads = torch.full((3, 8), -1, dtype=torch.int32)
    got = ttri.lcc_head_credits(5, [pads], [torch.zeros_like(pads)],
                                ([torch.zeros(0, dtype=torch.int32)],
                                 torch.zeros(0, dtype=torch.int64)))
    assert torch.equal(got, torch.zeros(5, dtype=torch.int64))
    star = JGraph(9, np.zeros(8, np.int64), np.arange(1, 9, dtype=np.int64), None,
                  np.arange(9, dtype=np.uint64), directed=True, weighted=False)
    tplan = ttri.prepare_wedge_plan(_twin(star), device="cpu")
    assert not tplan.buckets
    num = ttri.lcc_oriented_numerator(tplan)
    np.testing.assert_array_equal(num, jtri.lcc_oriented_numerator(jtri.prepare_wedge_plan(star)))
    assert not num.any()


def test_head_credits_exact_past_2_32():
    """Credits near 2^31 on few heads: int64 sums past 2^32, equal to K7's
    plain sum_i64 and numpy's."""
    rng = np.random.default_rng(31)
    n = 64
    slab = rng.integers(-1, n, size=(16, 300)).astype(np.int32)
    cred = np.where(slab >= 0, rng.integers((1 << 31) - 1000, (1 << 31) - 1, size=slab.shape),
                    0).astype(np.int32)
    u = rng.integers((1 << 31) - 1000, (1 << 31) - 1, size=20).astype(np.int32)
    rows = rng.integers(0, n, size=20).astype(np.int64)  # repeated rows add up
    got = ttri.lcc_head_credits(n, [_t(slab)], [_t(cred)], ([_t(u)], _t(rows)))
    want = np.zeros(n, dtype=np.int64)
    np.add.at(want, slab[slab >= 0], cred[slab >= 0].astype(np.int64))
    np.add.at(want, rows, u.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() > 1 << 32
    edge_pos, heads = _head_order([_t(slab)])
    hip = torch.from_numpy(np.searchsorted(heads.numpy(), np.arange(n + 1)).astype(np.int32))
    k7 = ttri._aggregate_heads(_t(cred).reshape(-1), edge_pos, hip)
    k7.index_add_(0, _t(rows), _t(u).long())
    assert torch.equal(got, k7)


def test_head_credits_refuse_bad_arguments():
    s = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ttri.lcc_head_credits(4, [s], [s.long()])
    with pytest.raises(ValueError, match="shape"):
        ttri.lcc_head_credits(4, [s], [s[:, :2].contiguous()])
    with pytest.raises(ValueError, match="one credit slab"):
        ttri.lcc_head_credits(4, [s], [])
    with pytest.raises(ValueError, match="row id"):
        ttri.lcc_head_credits(4, [s], [s], ([torch.zeros(2, dtype=torch.int32)],
                                            torch.zeros(3, dtype=torch.int64)))


# ---------------------------------------------------------------- K17


def _csr(rng, n, max_deg):
    deg = rng.integers(0, max_deg, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), neigh


def _jax_claimed(levels, level, ids, deg_pad, indptr, neigh, e_cap, pad, clamp):
    """graphtpu/algorithms/bfs.py:230-248: the hits of the valid slots, a
    cumsum differenced at the row starts (clamped to e_cap with ``clamp``,
    as the port's contract has them for rows the slots cut), a where."""
    fmask_pad = jnp.concatenate([(jnp.asarray(levels) == level).astype(jnp.int32),
                                 jnp.zeros((1,), jnp.int32)])
    exp = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                    jnp.asarray(neigh), e_cap, with_row_ids=False)
    rhit = (exp.valid & (j_table_gather(fmask_pad, exp.neigh) == 1)).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(rhit, dtype=jnp.int32)])
    starts = jnp.minimum(exp.seg_starts, e_cap) if clamp else exp.seg_starts
    seg_hits = j_table_gather(cs, starts[1:]) - j_table_gather(cs, starts[:-1])
    return np.asarray(jnp.where(seg_hits > 0, jnp.asarray(ids), jnp.int32(pad)))


@pytest.mark.parametrize("case", ["fits", "cut", "no_residual"])
def test_residual_claim_matches_jax_claimed_ids(case):
    """One device: K17's plain version (and its wrapper) against the JAX
    package's claimed ids, on residual rows whose edges fit the slots, are
    cut by them, or are none; the pad slots' neighbour 0 is at the level."""
    rng = np.random.default_rng(len(case) + 17)
    n, k = 600, 128
    e_cap = 256 if case == "cut" else 2048
    deg_pad, indptr, neigh = _csr(rng, n, 12)
    cnt = {"fits": 100, "cut": 128, "no_residual": 0}[case]
    ids = np.full(k, n, dtype=np.int32)
    ids[:cnt] = np.sort(rng.choice(n, size=cnt, replace=False))
    levels = rng.choice([0, 1, 2, INT32_INF], size=n, p=[0.1, 0.1, 0.2, 0.6]).astype(np.int32)
    levels[0] = 1
    exp = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(neigh), e_cap, with_row_ids=False)
    got = tf.residual_claim(_t(levels), 1, exp, e_cap, _t(ids), n)
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert torch.equal(got, tf.residual_claim_plain(_t(levels), 1, exp, e_cap, _t(ids), n))
    want = _jax_claimed(levels, 1, ids, deg_pad, indptr, neigh, e_cap, n, clamp=True)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "cut":
        assert int(exp.edge_count) > e_cap
    else:  # every row fits: bfs.py's own unclamped starts give the same ids
        np.testing.assert_array_equal(
            got.numpy(), _jax_claimed(levels, 1, ids, deg_pad, indptr, neigh, e_cap, n, False))
    claimed = int((got != n).sum())
    assert claimed > 0 if cnt else claimed == 0


@pytest.fixture(scope="module")
def gloo2():
    # rank 0 takes one thread, as the worker rank does
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_mod, "GROUP_TIMEOUT_S", 120.0)
        close_mesh()
        make_mesh(2, "cpu")
        yield 2
        close_mesh()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("e_cap", [4096, 64], ids=["fits", "cut"])
def test_residual_claim_over_two_gloo_ranks_matches_jax(gloo2, e_cap):
    """Over two gloo ranks: each rank's residual test (its local rows, the
    replicated global levels, the pad r) on the pull CSR it holds for the
    adaptive BFS, against the JAX package's claimed ids over the same
    slice."""
    jg = j_rmat_graph(9, 8, directed=True, seed=7)
    sg = ShardedGraph(_twin(jg), make_mesh(gloo2, "cpu"))
    qi, qdeg, qsrc = bfs_prep(sg).pull
    bfs_adaptive_dist(sg, 0)  # installs the slices
    r = sg.rows_per_dev
    rng = np.random.default_rng(e_cap)
    levels = rng.choice([0, 1, INT32_INF], size=r * gloo2, p=[0.2, 0.2, 0.6]).astype(np.int32)
    k = 64
    rids = np.full((gloo2, k), r, dtype=np.int32)
    for d in range(gloo2):
        rows = np.nonzero(qdeg[d][:r] > 0)[0]
        pick = np.sort(rng.choice(rows, size=min(48, rows.shape[0]), replace=False))
        rids[d, :pick.shape[0]] = pick
    got = sg.mesh.call(residual_claims, [((sg.key, f"bfs-adaptive-{BFS_TRUNC}"), levels, 1,
                                          rids[d], e_cap) for d in range(gloo2)])
    for d in range(gloo2):
        want = _jax_claimed(levels, 1, rids[d], qdeg[d], qi[d], qsrc[d], e_cap, r, clamp=True)
        np.testing.assert_array_equal(got[d], want)
        assert (got[d] != r).any()
    sg.release()
