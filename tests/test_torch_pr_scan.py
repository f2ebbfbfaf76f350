"""PageRank's scan arm (pr-impl=scan: a segment sum over the pull CSR on
K7 in mode sum), the spmv-impl key, skip-convergence-checks and the port's
entry point, on the CPU against the JAX package.

Ranks are held to the JAX package's _pr_kernel at rtol 1e-5 in float32 and
1e-12 in float64: the sums add in other orders (JAX differences a float64
prefix sum, the port's plain version adds each row in float64). CDLP labels
and iteration counts must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as j_entry
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.ops.spmv import pull_reduce as j_pull_reduce
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.entry import entry
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ops.spmv import csr_pull_reduce, csr_pull_reduce_plain
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

PR = dict(damping_factor=0.85, num_iterations=20)
RTOL = {"float32": 1e-5, "float64": 1e-12}


def _twins(scale, directed, seed=0, ef=8):
    jg = j_rmat_graph(scale, ef, directed=directed, seed=seed)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, directed, False)
    return jg, tg


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("scale", [8, 10])
def test_pr_scan_matches_jax(scale, directed, precision):
    jg, tg = _twins(scale, directed)
    want = j_run_algorithm("pr", jg, JParams(**PR), JConfig(pr_impl="scan", precision=precision))
    got = run_algorithm("pr", tg, AlgorithmParams(**PR),
                        PlatformConfig(device="cpu", pr_impl="scan", precision=precision))
    assert got.values.dtype == np.dtype(precision)
    assert any(k[0] == "pull_csr" for k in tg.memo if isinstance(k, tuple))
    np.testing.assert_allclose(got.values, want.values, rtol=RTOL[precision], atol=0)
    assert got.iterations == want.iterations == 20


@pytest.mark.parametrize("name", ["example-directed", "example-undirected", "test-pr-directed",
                                  "test-pr-undirected"])
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_pr_scan_goldens_validate(fixtures_dir, tmp_path, name, precision):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             pr_impl="scan", precision=precision))
    plat.load_graph(spec)
    plat.startup()
    res = plat.run(spec, "pr")
    plat.finalize()
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-PR"))
    assert ok, msg


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_pull_reduce_plain_sum_matches_jax_pull_reduce(seed, dtype):
    """Random CSRs with a quarter of the rows empty and one hub row."""
    rng = np.random.default_rng(seed)
    n = 3000
    deg = rng.integers(0, 8, size=n)
    deg[rng.choice(n, size=n // 4, replace=False)] = 0
    deg[n // 3] = 5000
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(deg, out=indptr[1:])
    src = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    x = (rng.random(n) * 2 - 0.5).astype(dtype)  # signed: sums near 0 too
    seg = np.repeat(np.arange(n, dtype=np.int32), deg)
    want = np.asarray(j_pull_reduce("sum", jnp.asarray(x)[src], jnp.asarray(seg),
                                    jnp.asarray(indptr), n, jnp.zeros((), dtype)))
    got = csr_pull_reduce("sum", torch.from_numpy(x), torch.from_numpy(src),
                          torch.from_numpy(indptr))
    assert got.dtype == torch.from_numpy(x).dtype
    assert bool((got[torch.from_numpy(deg == 0)] == 0).all())
    # JAX differences a float64 prefix sum: each row sum carries an error of
    # a few ulps of the prefix's magnitude, which float32 rounding hides
    atol = 0.0 if dtype == np.float32 else 16 * np.finfo(np.float64).eps * np.abs(x[src]).sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[np.dtype(dtype).name], atol=atol)
    np.testing.assert_array_equal(
        got.numpy(), csr_pull_reduce_plain("sum", torch.from_numpy(x), torch.from_numpy(src),
                                           torch.from_numpy(indptr)).numpy())


def test_csr_pull_reduce_sum_refuses_bad_inputs():
    src = torch.tensor([0, 1], dtype=torch.int32)
    indptr = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="sum takes x"):
        csr_pull_reduce("sum", None, src, indptr)
    with pytest.raises(TypeError, match="does not take"):
        csr_pull_reduce("sum", torch.tensor([1, 2], dtype=torch.int32), src, indptr)
    with pytest.raises(ValueError, match="takes no w"):
        csr_pull_reduce("sum", torch.ones(2), src, indptr, torch.ones(2))


def test_spmv_impl_picks_the_arm_as_in_jax():
    """spmv-impl=slab takes the slab arm under pr-impl=scan; scan and xla take
    K7's; pr-impl=segment (the JAX package's name of its segment-sum arm)
    takes K7's with the JAX package's ranks; an unknown pr-impl or spmv-impl
    is refused."""
    jg, tg = _twins(8, True)
    params = AlgorithmParams(**PR)
    base = run_algorithm("pr", tg, params, PlatformConfig(device="cpu"))
    assert not any(k[0] == "pull_csr" for k in tg.memo if isinstance(k, tuple))
    slab = run_algorithm("pr", tg, params,
                         PlatformConfig(device="cpu", pr_impl="scan", spmv_impl="slab"))
    np.testing.assert_array_equal(slab.values, base.values)
    assert not any(k[0] == "pull_csr" for k in tg.memo if isinstance(k, tuple))
    scans = [run_algorithm("pr", tg, params,
                           PlatformConfig(device="cpu", pr_impl="scan", spmv_impl=impl)).values
             for impl in ("scan", "xla")]
    assert any(k[0] == "pull_csr" for k in tg.memo if isinstance(k, tuple))
    np.testing.assert_array_equal(scans[0], scans[1])
    np.testing.assert_allclose(scans[0], base.values, rtol=1e-5)
    segment = run_algorithm("pr", tg, params, PlatformConfig(device="cpu", pr_impl="segment"))
    np.testing.assert_array_equal(segment.values, scans[0])
    want = j_run_algorithm("pr", jg, JParams(**PR), JConfig(pr_impl="segment"))
    np.testing.assert_allclose(segment.values, want.values, rtol=RTOL["float32"], atol=0)
    with pytest.raises(ValueError, match="unknown pr-impl"):
        run_algorithm("pr", tg, params, PlatformConfig(device="cpu", pr_impl="bogus"))
    with pytest.raises(ValueError, match="unknown spmv-impl"):
        run_algorithm("pr", tg, params,
                      PlatformConfig(device="cpu", pr_impl="scan", spmv_impl="ell"))


@pytest.mark.parametrize("skip", [0, 1, 3, 12])
def test_skip_convergence_checks_matches_jax(skip):
    """cdlp-impl=sort with the first k iterations taken as not converged:
    labels and iteration counts equal the JAX package's, k past itermax (10)
    included."""
    jg, tg = _twins(9, False, seed=3, ef=4)
    want = j_run_algorithm("cdlp", jg, JParams(max_iterations=10),
                           JConfig(cdlp_impl="sort", skip_convergence_checks=skip))
    got = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=10),
                        PlatformConfig(device="cpu", cdlp_impl="sort",
                                       skip_convergence_checks=skip))
    np.testing.assert_array_equal(got.values, want.values)
    assert got.iterations == want.iterations
    assert got.iterations >= min(skip + 1, 10)  # no stop before the checks resume


def test_entry_matches_the_jax_entry():
    step, args = entry(device="cpu")
    got = step(*args)
    j_step, j_args = j_entry.entry()
    want = np.asarray(j_step(*j_args))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1024,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    again = step(*args[:-1], got)  # a second step from the first one's ranks
    assert abs(float(again.sum()) - 1.0) < 1e-5
