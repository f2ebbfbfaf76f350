"""graphtpu_torch's one-WHILE fixed-point device loops (ops/fixed_point.py)
against the JAX package, on the CPU, where every kernel runs its plain
PyTorch version and each loop is the host walk of ``NEST``, reading its
condition from the control words: sssp-impl=device against
``_sssp_kernel``, wcc-impl=device against ``_wcc_kernel``, cdlp-impl=slab
against ``cdlp_slab_run`` (``_cdlp_slab_kernel``) and cdlp-impl=sort against
``_cdlp_sort_kernel`` with skip_checks 0, 2 and past itermax. K25's plain
version is held against the JAX loops' step ends (``changed``, the
``has_neighbors`` where, ``it + 1`` and the WHILE's condition), written out
here where they are nested functions of the jitted kernels.

Inputs come from numpy with a seed and go to both packages; results and
iteration counts must be bit-identical (tolerance 0). The JAX runs are made
once per module (fixtures), so that each compile is shared.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_fixed_point_loop.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import sssp as jsssp
from graphtpu.algorithms import wcc as jwcc
from graphtpu.algorithms.cdlp import _cdlp_sort_kernel as j_sort_kernel
from graphtpu.algorithms.cdlp import build_incidence as j_build_incidence
from graphtpu.core.graph import Graph as JGraph
from graphtpu.ops import minmode as jmm
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import cdlp as tcdlp
from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.algorithms import wcc as twcc
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops import device_loop, fixed_point
from graphtpu_torch.ops import minmode as tmm
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
ITERMAX = 10
SKIPS = (0, 2, 12)


def _twin(jg, weighted=False):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if weighted else None, jg.mapping,
                             jg.directed, weighted)


def _cdlp_graph(directed):
    """A seeded RMAT graph with 20 edgeless vertices appended (they keep
    their labels) and original ids that are not the dense ids."""
    jg = j_rmat_graph(7, 4, directed=directed, seed=31 + directed)
    n = jg.n + 20
    return JGraph(n, jg.src, jg.dst, None, np.arange(n) * 3 + 7, jg.directed, False,
                  _presorted=True)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's runs, each compiled once: SSSP and WCC device on
    a weighted directed RMAT graph from vertex 3; slab CDLP at itermax 10
    and 1 and sort CDLP at every skip on both CDLP graphs."""
    out = {}
    jw = j_rmat_graph(8, 6, directed=True, weighted=True, seed=30)
    out["weighted"] = (jw, _twin(jw, weighted=True))
    for name, (jdt, _) in DTYPES.items():
        coo = jw.device_pull(wdtype=jdt)
        indptr = jnp.asarray(jw.pull_indptr.astype(np.int32))
        dist, it = jsssp._sssp_kernel(coo.src, coo.dst, indptr, coo.w, jnp.int32(3), jw.n)
        out["sssp", name] = (np.asarray(dist), int(it))
    sym = jw.symmetrized()
    coo = sym.device_pull()
    labels, it = jwcc._wcc_kernel(coo.src, coo.dst, jnp.asarray(sym.pull_indptr.astype(np.int32)),
                                  sym.n)
    out["wcc"] = (np.asarray(labels), int(it))
    for directed in (True, False):
        jg = _cdlp_graph(directed)
        centers, neigh = j_build_incidence(jg)
        deg = np.bincount(centers, minlength=jg.n).astype(np.int32)
        out["cdlp", directed] = (jg, _twin(jg), (centers, neigh, deg))
        for itermax in (ITERMAX, 1):
            labels, it = jmm.cdlp_slab_run(jg, centers, neigh, deg, itermax, JConfig())
            out["slab", directed, itermax] = (np.asarray(labels), int(it))
        for skip in SKIPS:
            labels, it = j_sort_kernel(jnp.asarray(centers), jnp.asarray(neigh),
                                       jnp.asarray(deg), jg.n, ITERMAX, skip)
            out["sort", directed, skip] = (np.asarray(labels), int(it))
    return out


def _reads(mod, it_steps):
    """The host loop read the condition once after init and after each step."""
    assert mod.last_run["driver"] == "host loop"
    assert mod.last_run["condition_reads"] == it_steps + 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sssp_device_matches_jax(runs, dtype):
    _, tg = runs["weighted"]
    tdt = DTYPES[dtype][1]
    want, want_it = runs["sssp", dtype]
    dist, it = tsssp._sssp_kernel(tsssp.sssp_prep(tg, tdt, "cpu"), 3, tg.n, tdt)
    assert dist.dtype == tdt and it == want_it > 2
    np.testing.assert_array_equal(dist.numpy(), want)
    _reads(tsssp, it)
    got, it2 = tsssp.sssp_device_run(tg, 3, PlatformConfig(device="cpu"), tdt)
    assert it2 == it and torch.equal(got, dist)


def test_wcc_device_matches_jax(runs):
    jw, tg = runs["weighted"]
    want, want_it = runs["wcc"]
    labels, it = twcc.wcc_device_run(tg, PlatformConfig(device="cpu"))
    assert it == want_it > 1
    np.testing.assert_array_equal(labels.numpy(), want)
    _reads(twcc, it)


@pytest.mark.parametrize("itermax", [ITERMAX, 1])
@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_cdlp_slab_matches_jax(runs, directed, itermax):
    """Iteration 0 before the WHILE (it starts at 1), as ``_cdlp_slab_kernel``."""
    _, tg, (centers, neigh, deg) = runs["cdlp", directed]
    want, want_it = runs["slab", directed, itermax]
    labels, it = tmm.cdlp_slab_run(tg, centers, neigh, deg, itermax, PlatformConfig(device="cpu"))
    assert it == want_it
    np.testing.assert_array_equal(labels.numpy(), want)
    _reads(tmm, it - 1)
    labels0, it0 = tmm.cdlp_slab_run(tg, centers, neigh, deg, 0, PlatformConfig(device="cpu"))
    assert it0 == 0 and labels0.tolist() == list(range(tg.n))


@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_cdlp_sort_matches_jax(runs, directed, skip):
    _, tg, (centers, neigh, deg) = runs["cdlp", directed]
    want, want_it = runs["sort", directed, skip]
    labels, it = tcdlp.cdlp_sort_run(tg, centers, neigh, deg, ITERMAX, skip,
                                     torch.device("cpu"))
    assert it == want_it
    np.testing.assert_array_equal(labels.numpy(), want)
    assert (labels.numpy()[-20:] == np.arange(tg.n - 20, tg.n)).all()  # edgeless: kept
    _reads(tcdlp, it)
    if skip > ITERMAX:
        assert it == ITERMAX


def _jax_step_end(labels, best, it, limit, skip, has_neighbors=None):
    """The step ends of graphtpu/algorithms/cdlp.py:111-114 (with
    ``has_neighbors``), graphtpu/ops/minmode.py:228-229 and
    graphtpu/algorithms/wcc.py:52-56 (``skip`` 0), then the WHILE's cond."""
    new = best if has_neighbors is None else jnp.where(has_neighbors, best, labels)
    changed = (it < skip) | jnp.any(new != labels)
    it = it + 1
    return new, bool(changed), int(it), bool(changed & (it < limit))


@pytest.mark.parametrize("with_deg", [False, True])
@pytest.mark.parametrize("share", [0.0, 0.01, 0.5])
def test_route_compare_mode_matches_jax(share, with_deg):
    rng = np.random.default_rng(int(share * 100) + with_deg)
    n = 300
    labels = rng.integers(0, n, n).astype(np.int32)
    best = np.where(rng.random(n) < share, rng.integers(0, n, n), labels).astype(np.int32)
    deg = (rng.random(n) < 0.7).astype(np.int32) * 3
    for it, limit, skip in ((0, 10, 0), (3, 10, 0), (8, 10, 0), (9, 10, 0), (1, 10, 2),
                            (4, 5, 12)):
        new, changed, it2, cond = _jax_step_end(
            jnp.asarray(labels), jnp.asarray(best), jnp.int32(it), limit, skip,
            jnp.asarray(deg > 0) if with_deg else None)
        fp = fixed_point.control("cpu", False)
        fp.ctl[:] = torch.tensor([it, limit, skip, 0, 1], dtype=torch.int32)
        old = torch.from_numpy(labels.copy())
        fixed_point.fixed_point_route(fp, fixed_point.STAGE_STEP, old=old,
                                      new=torch.from_numpy(best),
                                      deg=torch.from_numpy(deg) if with_deg else None)
        np.testing.assert_array_equal(old.numpy(), np.asarray(new))
        assert fp.ctl.tolist() == [it2, limit, skip, int(bool(np.asarray(new != labels).any())),
                                   int(cond)]
        assert changed == (it < skip or bool(np.asarray(new != labels).any()))


def test_route_flag_mode_and_init_match_jax():
    """The flag mode reads a changed count an earlier kernel wrote (K22's
    for SSSP: ``any(new < dist)`` is a count above 0); init is the JAX
    loops' first state, (changed = True, it = start)."""
    for count, it, limit in ((0, 2, 9), (5, 2, 9), (5, 8, 9), (1, 0, 1)):
        fp = fixed_point.control("cpu", False)
        fp.ctl[:] = torch.tensor([it, limit, 0, 0, 1], dtype=torch.int32)
        flag = torch.tensor([count], dtype=torch.int32)
        fixed_point.fixed_point_route(fp, fixed_point.STAGE_STEP, flag=flag[0])
        assert fp.ctl.tolist() == [it + 1, limit, 0, int(count > 0),
                                   int(count > 0 and it + 1 < limit)]
    for start, limit, skip in ((0, 5, 0), (1, 10, 0), (1, 1, 0), (0, 0, 3)):
        fp = fixed_point.control("cpu", False)
        fp.params[0], fp.params[1] = limit, skip
        fixed_point.fixed_point_route(fp, fixed_point.STAGE_INIT, start=start)
        assert fp.ctl.tolist() == [start, limit, skip, 1, int(start < limit)]
    assert device_loop.conditions(fixed_point.NEST) == 1
    assert fixed_point.runs([4, 10, 0, 0, 0], start=1) == {"init": 1, "step": 3}
    with pytest.raises(ValueError):
        fixed_point.fixed_point_route(fixed_point.control("cpu", False), fixed_point.STAGE_STEP)
