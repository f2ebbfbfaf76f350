"""The port's sharded checkpoints (graphtpu_torch/parallel/checkpoint.py, the
``shard-checkpoints`` key) over gloo groups of 2 and 4 CPU ranks.

The cases of tests/test_checkpoint.py, ported: the pull partition's round
trip, the rejection of another graph, the repeat run through
run_algorithm that restores the pull partitions and the pr-pull,
cdlp-incidence and wcc-slab plans with every builder replaced by a trap
(results bit for bit, PageRank within 1e-12 in float64), the bucket choice
and the "<name>-sym" partition. Then what the port adds: the files are the
JAX package's, so each package loads what the other wrote, array for
array; each manifest field the JAX reader compares makes both readers
reject; a directory without its manifest loads as absent, an unreadable
shard or a manifest replaced during the read is rejected with a warning.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from graphtpu.parallel import ShardedGraph as JShardedGraph
from graphtpu.parallel import checkpoint as j_ckpt
from graphtpu.parallel import make_mesh as j_make_mesh
from graphtpu.parallel.slab_cdlp import build_dist_slab_plan as j_build_plan
from graphtpu.utils.synth import rmat_graph as j_rmat_graph
from graphtpu.utils.synth import uniform_graph as j_uniform_graph

from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ingest.loader import load_graph_from_spec
from graphtpu_torch.parallel import adaptive_wcc, dispatch, slab_cdlp, slab_pr
from graphtpu_torch.parallel import algorithms as dist
from graphtpu_torch.parallel import checkpoint as ckpt
from graphtpu_torch.parallel import mesh as mesh_mod
from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph
from graphtpu_torch.parallel.slab_cdlp import build_dist_slab_plan, cdlp_slab_dist
from graphtpu_torch.parallel.slab_pr import pr_slab_dist
from graphtpu_torch.utils.config import GraphSpec, PlatformConfig

from conftest import FIXTURES
from torch_native_env import jax_native_on_port_build  # noqa: F401

RTOL = 1e-12
BUCKETS = (4, 8, 16, 32)  # small buckets: many rows take the heavy stream
GROUP_TIMEOUT_S = 120.0
PLAN_KINDS = ("pr-pull", "cdlp-incidence", "wcc-slab")


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_mod, "GROUP_TIMEOUT_S", GROUP_TIMEOUT_S)
        close_mesh()  # a live mesh of another module keeps its own timeout
        make_mesh(request.param, "cpu")
        yield request.param
        close_mesh()
    torch.set_num_threads(threads)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings():
    handler = _Records()
    logger = logging.getLogger("graphtpu_torch.ckpt")
    logger.addHandler(handler)
    yield handler.messages
    logger.removeHandler(handler)


def _twin(jg, name=None):
    g = Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if jg.weighted else None, jg.mapping,
                          jg.directed, jg.weighted)
    g.name = name
    return g


def _trap(*args, **kwargs):
    raise AssertionError("rebuilt despite a saved checkpoint")


def _release(g):
    """Drop ``g``'s sharded views on every rank, keeping the ranks."""
    for key in [k for k in dispatch._sharded_cache if k[0] == id(g)]:
        dispatch._sharded_cache.pop(key).release()


def _coo_equal(a, b, pad_w=True):
    """Equal blocks; ``pad_w`` False leaves out the padding's weights (an
    unweighted file holds no weights, and the JAX reader pads with 1.0
    where a built partition holds 0)."""
    for x, y in zip(a[:4], b[:4], strict=True):
        x, y = np.asarray(x), np.asarray(y)
        if not pad_w and x.dtype.kind == "f":
            x, y = x[np.asarray(a.valid)], y[np.asarray(b.valid)]
        np.testing.assert_array_equal(x, y)


def _plans_equal(a, b):
    assert len(a.bucket_slabs) == len(b.bucket_slabs)
    for x, y in zip(a.bucket_slabs, b.bucket_slabs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (a.heavy is None) == (b.heavy is None)
    for x, y in zip(a.heavy or (), b.heavy or ()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(a.inv_perm), np.asarray(b.inv_perm))
    np.testing.assert_array_equal(np.asarray(a.has_neighbors), np.asarray(b.has_neighbors))


def test_sharded_checkpoint_roundtrip(ranks, tmp_path, monkeypatch):
    """save_pull, then load_pull into a fresh ShardedGraph gives the same
    blocks, and the naive PageRank on the restored partition (nothing
    rebuilt) equals the first run's bit for bit."""
    g = _twin(j_uniform_graph(2000, 16000, directed=True, seed=5))
    naive = PlatformConfig(pr_impl="segment")
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"), wdtype=np.float64)
    before = dist.pr_dist(sg, 0.85, 5, dtype=np.float64, cfg=naive)

    assert not ckpt.exists(tmp_path, "u", ranks)
    d = ckpt.save_pull(sg, tmp_path, "u")
    assert ckpt.exists(tmp_path, "u", ranks) and (d / "shard-0.npz").exists()

    sg2 = ShardedGraph(g, make_mesh(ranks, "cpu"), wdtype=np.float64)
    _coo_equal(ckpt.load_pull(sg2, tmp_path, "u"), sg.pull_host())
    sg2.ckpt = (str(tmp_path), "u")
    monkeypatch.setattr(ShardedGraph, "_pull_of", _trap)
    np.testing.assert_array_equal(dist.pr_dist(sg2, 0.85, 5, dtype=np.float64, cfg=naive),
                                  before)
    sg.release()
    sg2.release()


def test_checkpoint_incompatible_rejected(ranks, tmp_path, warnings):
    g = _twin(j_uniform_graph(1000, 4000, directed=True, seed=6))
    ckpt.save_pull(ShardedGraph(g, make_mesh(ranks, "cpu")), tmp_path, "v")
    g2 = _twin(j_uniform_graph(1500, 4000, directed=True, seed=6))  # another n
    assert ckpt.load_pull(ShardedGraph(g2, make_mesh(ranks, "cpu")), tmp_path, "v") is None
    assert len(warnings) == 1 and "incompatible" in warnings[0]


def _run_all(g, cfg):
    """PR, CDLP and WCC under their defaults (the three slab plans), BFS
    under dense (the pull partition) and WCC under adaptive (the
    symmetrized one), through run_algorithm."""
    spec = GraphSpec.from_properties(FIXTURES / "example-directed.properties")
    runs = (("pr", {}), ("cdlp", {}), ("wcc", {}), ("bfs", {"bfs_impl": "dense"}),
            ("wcc", {"wcc_impl": "adaptive"}))
    return [run_algorithm(algo, g, spec.params.get(algo),
                          dataclasses.replace(cfg, **impl)).values
            for algo, impl in runs]


def test_dispatch_uses_checkpoint_on_repeat_run(ranks, tmp_path, monkeypatch):
    """run_algorithm under num-devices = D on a named graph saves the pull
    partitions and the three slab plans (nothing with shard-checkpoints
    off); a repeat run on a freshly loaded Graph restores every one of
    them with the builders replaced by a trap, rewrites nothing, and gives
    the first run's results bit for bit (PageRank within 1e-12)."""
    spec = GraphSpec.from_properties(FIXTURES / "example-directed.properties")
    g = load_graph_from_spec(spec, intermediate_dir=str(tmp_path))
    assert g.name == "example-directed"
    cfg = PlatformConfig(device="cpu", num_devices=ranks, precision="float64",
                         intermediate_dir=str(tmp_path))
    off = dataclasses.replace(cfg, shard_checkpoints=False)
    _run_all(g, off)
    _release(g)
    assert not ckpt.exists(tmp_path, g.name, ranks)
    assert not any(ckpt.plan_exists(tmp_path, g.name, ranks, k) for k in PLAN_KINDS)

    first = _run_all(g, cfg)
    _release(g)
    for name in (g.name, f"{g.name}-sym"):
        assert ckpt.exists(tmp_path, name, ranks), name
    for kind in PLAN_KINDS:
        assert ckpt.plan_exists(tmp_path, g.name, ranks, kind), kind
    stamps = {p: p.stat().st_mtime_ns for p in tmp_path.rglob("*") if p.is_file()}

    g2 = load_graph_from_spec(spec, intermediate_dir=str(tmp_path))
    monkeypatch.setattr(ShardedGraph, "_pull_of", _trap)
    for mod in (slab_cdlp, slab_pr, adaptive_wcc):
        monkeypatch.setattr(mod, "build_dist_slab_plan_from", _trap)
    monkeypatch.setattr(slab_cdlp, "build_dist_slab_plan", _trap)
    try:
        second = _run_all(g2, cfg)
    finally:
        _release(g2)
    np.testing.assert_allclose(second[0], first[0], rtol=RTOL, atol=0)
    for a, b in zip(second[1:], first[1:]):
        np.testing.assert_array_equal(a, b)
    assert {p: p.stat().st_mtime_ns for p in tmp_path.rglob("*") if p.is_file()} == stamps


def test_plan_checkpoint_invalidated_by_bucket_policy(ranks, tmp_path, warnings):
    """A plan saved under one bucket choice is rejected under another
    (explicit buckets in place of the JAX package's env knobs): CDLP under
    new buckets drops its memo, rejects the saved plan, rebuilds and saves
    it under the new choice, with the same labels."""
    g = _twin(j_uniform_graph(200, 1600, directed=True, seed=4), "policykey")
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"))
    sg.ckpt = (str(tmp_path), "policykey")
    pr_slab_dist(sg, 0.85, 2)  # builds + saves the auto-policy plan
    assert ckpt.plan_exists(tmp_path, "policykey", ranks, "pr-pull")
    assert ckpt.load_plan(tmp_path, "policykey", "pr-pull", ranks, g.n, None) is not None
    assert ckpt.load_plan(tmp_path, "policykey", "pr-pull", ranks, g.n, BUCKETS) is None

    labels, it = cdlp_slab_dist(sg, 5, BUCKETS)
    assert ckpt.load_plan(tmp_path, "policykey", "cdlp-incidence", ranks, g.n,
                          BUCKETS) is not None
    assert ckpt.load_plan(tmp_path, "policykey", "cdlp-incidence", ranks, g.n, None) is None
    again, it2 = cdlp_slab_dist(sg, 5, None)
    np.testing.assert_array_equal(again, labels)
    assert it2 == it
    mf = tmp_path / "policykey" / f"shards-{ranks}" / "plan-cdlp-incidence" / "manifest.json"
    assert json.loads(mf.read_text())["buckets"] == ["auto", "", 10]
    assert sum("incompatible" in m for m in warnings) == 3
    sg.release()


def test_symmetrized_pull_checkpoint(ranks, tmp_path, monkeypatch):
    """Directed WCC's symmetrized partition persists under <name>-sym and
    is restored instead of repartitioning."""
    g = _twin(j_uniform_graph(300, 2400, directed=True, seed=9), "symck")
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"))
    sg.ckpt = (str(tmp_path), "symck")
    coo1 = sg.pull_symmetrized_host()
    assert ckpt.exists(tmp_path, "symck-sym", ranks)
    assert not ckpt.exists(tmp_path, "symck", ranks)

    sg2 = ShardedGraph(g, make_mesh(ranks, "cpu"))
    sg2.ckpt = (str(tmp_path), "symck")
    monkeypatch.setattr(ShardedGraph, "_pull_of", _trap)
    _coo_equal(sg2.pull_symmetrized_host(), coo1)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_files_load_across_the_two_packages(ranks, tmp_path, weighted):
    """The JAX package's save_pull and save_plan on make_mesh(D) load in the
    port, and the port's in the JAX package's load_pull and load_plan,
    equal array for array (the pull partition; CDLP's incidence plan under
    the auto policy and under explicit buckets). An unweighted file holds
    no weights: the port restores the built 0.0 on the padding, the JAX
    reader fills it with 1.0, so there the padding's weights are left out."""
    jg = j_rmat_graph(9, 8, directed=True, weighted=weighted, seed=3)
    g = _twin(jg)
    jmesh = j_make_mesh(ranks)
    jsg = JShardedGraph(jg, jmesh)
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"

    j_ckpt.save_pull(jsg, jax_dir, "x")
    _coo_equal(ckpt.load_pull(sg, jax_dir, "x"), jsg.pull())
    ckpt.save_pull(sg, port_dir, "x")
    jcoo = j_ckpt.load_pull(JShardedGraph(jg, jmesh), port_dir, "x")
    _coo_equal(jcoo, sg.pull_host(), pad_w=weighted)

    for buckets in (None, BUCKETS):
        jplan = j_build_plan(jg, jmesh, buckets)
        plan = build_dist_slab_plan(g, ranks, buckets)
        j_ckpt.save_plan(jplan, jax_dir, "x", ranks, jg.n, "cdlp-incidence", buckets)
        _plans_equal(ckpt.load_plan(jax_dir, "x", "cdlp-incidence", ranks, g.n, buckets), plan)
        ckpt.save_plan(plan, port_dir, "x", ranks, g.n, "cdlp-incidence", buckets)
        _plans_equal(j_ckpt.load_plan(port_dir, "x", "cdlp-incidence", mesh=jmesh, n=jg.n,
                                      buckets=buckets), jplan)
        for name in ("manifest.json", "replicated.npz", "shard-0.npz"):
            for d in (jax_dir, port_dir):
                assert (d / "x" / f"shards-{ranks}" / "plan-cdlp-incidence" / name).exists()
    for d in (jax_dir, port_dir):
        pull_mf = json.loads((d / "x" / f"shards-{ranks}" / "manifest.json").read_text())
        assert pull_mf["version"] == ckpt.CKPT_VERSION == j_ckpt.CKPT_VERSION
        plan_mf = json.loads(
            (d / "x" / f"shards-{ranks}" / "plan-cdlp-incidence" / "manifest.json").read_text())
        assert plan_mf["version"] == ckpt.PLAN_VERSION == j_ckpt.PLAN_VERSION
    sg.release()


MANIFEST_FIELDS = [("pull", k, v) for k, v in (
    ("version", 2), ("num_devices", 99), ("n", 7), ("rows_per_dev", 1), ("wdtype", "float64"),
    ("weighted", True))] + [("plan", k, v) for k, v in (
        ("version", 0), ("num_devices", 99), ("n", 7), ("kind", "pr-pull"),
        ("buckets", ["explicit", [4, 8]]))]


@pytest.mark.parametrize("what,field,value", MANIFEST_FIELDS,
                         ids=[f"{w}-{f}" for w, f, _ in MANIFEST_FIELDS])
def test_manifest_fields_rejected_as_in_jax(ranks, tmp_path, warnings, what, field, value):
    """A manifest that differs in one field the JAX reader compares is
    rejected by both packages' readers, with a warning; as written, both
    load it."""
    jg = j_uniform_graph(500, 3000, directed=True, seed=8)
    g = _twin(jg)
    jmesh = j_make_mesh(ranks)
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"))
    if what == "pull":
        d = ckpt.save_pull(sg, tmp_path, "m")

        def loads():
            return (ckpt.load_pull(sg, tmp_path, "m"),
                    j_ckpt.load_pull(JShardedGraph(jg, jmesh), tmp_path, "m"))
    else:
        d = ckpt.save_plan(build_dist_slab_plan(g, ranks), tmp_path, "m", ranks, g.n,
                           "cdlp-incidence", None)

        def loads():
            return (ckpt.load_plan(tmp_path, "m", "cdlp-incidence", ranks, g.n, None),
                    j_ckpt.load_plan(tmp_path, "m", "cdlp-incidence", mesh=jmesh, n=jg.n,
                                     buckets=None))
    assert all(x is not None for x in loads())
    mf = d / "manifest.json"
    manifest = json.loads(mf.read_text())
    assert manifest[field] != value
    mf.write_text(json.dumps({**manifest, field: value}))
    assert loads() == (None, None)
    assert len(warnings) == 1 and "incompatible" in warnings[0]


def test_manifest_written_last(ranks, tmp_path, warnings, monkeypatch):
    """A save leaves the shards, the replicated arrays and the manifest and
    no temporary file; without its manifest a directory loads as absent
    (no warning); a missing shard, or a manifest replaced while the shards
    are read, is rejected with a warning."""
    g = _twin(j_uniform_graph(400, 3000, directed=True, seed=2))
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"))
    plan = build_dist_slab_plan(g, ranks, BUCKETS)
    d = ckpt.save_pull(sg, tmp_path, "w")
    pd = ckpt.save_plan(plan, tmp_path, "w", ranks, g.n, "cdlp-incidence", BUCKETS)
    shards = {f"shard-{r}.npz" for r in range(ranks)}
    assert {p.name for p in d.iterdir() if p.is_file()} == shards | {"manifest.json"}
    assert {p.name for p in pd.iterdir()} == shards | {"manifest.json", "replicated.npz"}

    def load_plan():
        return ckpt.load_plan(tmp_path, "w", "cdlp-incidence", ranks, g.n, BUCKETS)

    # a manifest replaced (a writer's rename) while the shards are read
    real_load = np.load

    def racing_load(path, *args, **kwargs):
        monkeypatch.setattr(np, "load", real_load)
        ckpt._commit(path.parent, json.loads((path.parent / "manifest.json").read_text()))
        return real_load(path, *args, **kwargs)

    for load, where in ((lambda: ckpt.load_pull(sg, tmp_path, "w"), d), (load_plan, pd)):
        monkeypatch.setattr(np, "load", racing_load)
        assert load() is None
        assert load() is not None  # the replaced manifest is a whole one
        (where / "shard-1.npz").rename(where / "kept.npz")
        assert load() is None
        (where / "kept.npz").rename(where / "shard-1.npz")
        (where / "manifest.json").unlink()
        assert load() is None
    assert not ckpt.exists(tmp_path, "w", ranks)
    assert not ckpt.plan_exists(tmp_path, "w", ranks, "cdlp-incidence")
    assert len(warnings) == 4
    assert sum("changed" in m for m in warnings) == 2
    assert sum("unreadable" in m for m in warnings) == 2
