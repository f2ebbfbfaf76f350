"""graphtpu_torch's native ingest against the JAX package's: the ctypes
binding of native/graphtpu_io.cpp (parsers, counting sort, fused relabel),
its build (one library under concurrent first use, off by
GRAPHTPU_NATIVE_LIB=/dev/null, a failed build raises), the numpy arms, and
the device sort run on the CPU.

The JAX package's binding is pointed at the port's build of the same
source (``jax_native``), so that no test here builds into native/.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from graphtpu.core import graph as JG
from graphtpu.ingest import native as jnative
from graphtpu.ingest import relabel as jrelabel
from graphtpu.utils import synth as jsynth
from graphtpu.utils.config import GraphSpec as JGraphSpec

from graphtpu_torch.core import graph as TG
from graphtpu_torch.ingest import native as tnative
from graphtpu_torch.ingest import relabel as trelabel
from graphtpu_torch.ingest.loader import load_graph
from graphtpu_torch.utils import synth as tsynth
from graphtpu_torch.utils.config import GraphSpec

from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FIXTURE_DIR = REPO / "tests" / "fixtures" / "graphs"
FIXTURE_GRAPHS = sorted(p.stem for p in FIXTURE_DIR.glob("*.properties"))
EDGE_FILES = sorted(p.name for p in FIXTURE_DIR.glob("*.e"))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native binding, loading the port's build."""
    monkeypatch.setenv("GRAPHTPU_NATIVE_LIB", str(tnative.build(tnative._compiler())))
    monkeypatch.setattr(jnative, "_checked", False)
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.relabel_available()
    return jnative


def _assert_graphs_equal(tg, jg):
    assert (tg.n, tg.nnz, tg.directed, tg.weighted) == (jg.n, jg.nnz, jg.directed, jg.weighted)
    for name in ("src", "dst", "w", "mapping"):
        a, b = getattr(tg, name), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.fixture(scope="module")
def awkward_files(tmp_path_factory):
    """80,000 edge lines over ids above 2^53 (up to 2^63 - 1), stray blanks,
    tabs and a trailing blank line; weights in 17 and in 6 significant
    digits."""
    d = tmp_path_factory.mktemp("awkward")
    rng = np.random.default_rng(11)
    ids = np.unique(np.concatenate([
        rng.integers(2**53, 2**53 + 10**7, 3000), rng.integers(2**62, 2**63 - 1, 3000),
        np.array([0, 2**63 - 1], dtype=np.int64),
    ]))
    rng.shuffle(ids)
    vpath = d / "awk.v"
    vpath.write_text("".join(f"{v}\n" if i % 7 else f"  {v}\t\n" for i, v in enumerate(ids))
                     + "\n")
    m = 80_000
    src, dst = rng.choice(ids, m), rng.choice(ids, m)
    w = rng.random(m) * 10
    epath = d / "awk.e"
    with open(epath, "w") as f:
        for i in range(m):
            sep = "\t" if i % 5 == 0 else " "
            f.write(f"{src[i]}{sep}{dst[i]}{sep}{w[i]:.17g}\n" if i % 2
                    else f"{src[i]}{sep}{dst[i]}{sep}{w[i]:.6g}\n")
    return vpath, epath


@pytest.mark.parametrize("name", EDGE_FILES + ["awk"])
def test_native_parse_matches_jax_and_numpy(name, awkward_files, jax_native):
    """Both arms of the port's parsers give the JAX package's arrays, bit
    for bit, ids as int64 (ids above 2^53 intact)."""
    if name == "awk":
        vpath, epath = map(str, awkward_files)
    else:
        epath = str(FIXTURE_DIR / name)
        vpath = epath[:-2] + ".v"
    lines = [ln.split() for ln in Path(epath).read_text().splitlines() if ln.strip()]
    weighted_ok = all(len(ln) >= 3 for ln in lines)

    want_v = jrelabel._parse_vertices_numpy(vpath)
    for got in (tnative.parse_vertices(vpath), jax_native.parse_vertices(vpath),
                trelabel._parse_vertices_numpy(vpath), trelabel.parse_vertex_file(vpath)):
        assert got.dtype == np.int64 and np.array_equal(got, want_v)
    for weighted in (False, True) if weighted_ok else (False,):
        want = jrelabel._parse_edges_numpy(epath, weighted)
        for got in (tnative.parse_edges(epath, weighted), jax_native.parse_edges(epath, weighted),
                    trelabel._parse_edges_numpy(epath, weighted),
                    trelabel.parse_edge_file(epath, weighted)):
            for a, b in zip(got[:2], want[:2]):
                assert a.dtype == np.int64 and np.array_equal(a, b)
            if weighted:
                assert got[2].dtype == np.float64 and np.array_equal(got[2], want[2])
            else:
                assert got[2] is None and want[2] is None


@pytest.mark.parametrize("directed,weighted", [(True, True), (False, False)])
def test_relabel_of_awkward_file_matches_jax(directed, weighted, awkward_files, jax_native):
    """80,000 lines: the port's relabel takes the native arm unforced and
    gives the JAX package's Graph. (Undirected, the file's random weights
    conflict on pairs listed both ways, so it is read unweighted.)"""
    vpath, epath = map(str, awkward_files)
    before = dict(tnative.call_counts)
    tg = trelabel.relabel(vpath, epath, directed, weighted)
    moved = {k: tnative.call_counts[k] - before[k] for k in before}
    assert moved == {"gtio_count_lines": 2, "gtio_parse_vertices": 1, "gtio_parse_edges": 1,
                     "gtio_sort_edges": 0, "gtio_relabel_edges": 1}
    _assert_graphs_equal(tg, jrelabel.relabel(vpath, epath, directed, weighted))


@pytest.mark.parametrize("name", FIXTURE_GRAPHS)
def test_fixture_graphs_match_jax_on_both_arms(name, monkeypatch, jax_native):
    """Every fixture through the native relabel (forced) and the numpy one."""
    spec = GraphSpec.from_properties(FIXTURE_DIR / f"{name}.properties")
    jspec = JGraphSpec.from_properties(FIXTURE_DIR / f"{name}.properties")
    args = (spec.vertex_path, spec.edge_path, spec.directed, spec.weighted)
    jargs = (jspec.vertex_path, jspec.edge_path, jspec.directed, jspec.weighted)
    want = jrelabel.relabel(*jargs)
    for floor in (0, 1 << 62):
        monkeypatch.setattr(TG, "NATIVE_SORT_MIN", floor)
        _assert_graphs_equal(trelabel.relabel(*args), want)


def _edge_case(seed, weighted):
    rng = np.random.default_rng(seed)
    n, m = 500, 4000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    src[m // 2:m // 2 + 64], dst[m // 2:m // 2 + 64] = src[:64], dst[:64]  # duplicates
    dst[:16] = src[:16]  # self-loops
    # one weight per unordered pair: never conflicting when undirected
    w = (np.minimum(src, dst) * 1.5 + np.maximum(src, dst) * 0.25 + 1.0) if weighted else None
    vids = np.arange(n, dtype=np.int64) * 5 + 11
    return vids, vids[src], vids[dst], w


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_from_original_ids_native_matches_jax(directed, weighted, monkeypatch, jax_native):
    """The fused native relabel, the counting sort of pull_arrays and of
    symmetrized(): bit-identical to the JAX package's with both sides'
    NATIVE_SORT_MIN at 0, and to the port's numpy arm."""
    vids, s, d, w = _edge_case(7, weighted)
    monkeypatch.setattr(JG, "NATIVE_SORT_MIN", 0)
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 0)
    before = dict(tnative.call_counts)
    tg = TG.Graph.from_original_ids(vids, s, d, w, directed, weighted)
    jg = JG.Graph.from_original_ids(vids, s, d, w, directed, weighted)
    _assert_graphs_equal(tg, jg)
    for a, b in zip(tg.pull_arrays(), jg.pull_arrays()):
        assert np.array_equal(a, np.asarray(b))
    _assert_graphs_equal(tg.symmetrized(), jg.symmetrized())
    assert tnative.call_counts["gtio_relabel_edges"] == before["gtio_relabel_edges"] + 1
    sorts = tnative.call_counts["gtio_sort_edges"] - before["gtio_sort_edges"]
    assert sorts == (2 if directed else 0)  # pull order and symmetrized()

    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 1 << 62)
    tg_np = TG.Graph.from_original_ids(vids, s, d, w, directed, weighted)
    _assert_graphs_equal(tg_np, jg)
    for a, b in zip(tg_np.pull_arrays(), tg.pull_arrays()):
        assert np.array_equal(a, b)


def test_pull_arrays_directed_weighted_through_native_sort(monkeypatch, jax_native):
    """A directed weighted graph's pull order by the native counting sort
    (primary dst, no dedup) equals the JAX package's and the lexsort's."""
    rng = np.random.default_rng(9)
    n, m = 400, 3000
    src, dst, w = rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m)
    vids = np.arange(n, dtype=np.int64)
    monkeypatch.setattr(JG, "NATIVE_SORT_MIN", 0)
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 0)
    tg = TG.Graph.from_original_ids(vids, src, dst, w, True, True)
    jg = JG.Graph.from_original_ids(vids, src, dst, w, True, True)
    before = tnative.call_counts["gtio_sort_edges"]
    got = tg.pull_arrays()
    assert tnative.call_counts["gtio_sort_edges"] == before + 1
    perm = TG._lexsort_edges(tg.src, tg.dst, "dst")
    for a, b, c in zip(got, jg.pull_arrays(), (tg.src[perm], tg.dst[perm], tg.w[perm])):
        assert np.array_equal(a, np.asarray(b)) and np.array_equal(a, c)


def test_synth_graph_above_the_native_floor_matches_jax(jax_native):
    """rmat_graph at 2^17 stored edges: Graph() takes the native sort
    unforced on both sides."""
    for weighted in (False, True):
        tg = tsynth.rmat_graph(12, 16, directed=False, weighted=weighted, seed=3)
        jg = jsynth.rmat_graph(12, 16, directed=False, weighted=weighted, seed=3)
        assert tg.nnz >= TG.NATIVE_SORT_MIN
        _assert_graphs_equal(tg, jg)


@pytest.mark.parametrize("floor", [0, 1 << 62])
def test_relabel_error_paths(floor, monkeypatch, jax_native):
    """Duplicate vertex ids, unknown edge ids and conflicting duplicate
    weights raise the JAX package's ValueErrors on the native and the
    numpy arm alike."""
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", floor)
    monkeypatch.setattr(JG, "NATIVE_SORT_MIN", floor)
    vids = np.arange(100, dtype=np.int64)
    big = np.tile(np.arange(90, dtype=np.int64), 800)
    vids_dup = vids.copy()
    vids_dup[5] = vids_dup[4]
    bad = big.copy()
    bad[7] = 555
    s2 = np.array([1, 2] * 40000, dtype=np.int64)
    d2 = np.array([2, 1] * 40000, dtype=np.int64)
    wc = np.ones(80000)
    wc[1] = 5.0
    cases = [((vids_dup, big, big, None, True, False), "duplicate vertex ids in vertex file"),
             ((vids, bad, big, None, True, False), "edge references unknown vertex id"),
             ((vids, s2, d2, wc, False, True),
              "undirected input lists an edge twice with conflicting weights")]
    for args, msg in cases:
        with pytest.raises(ValueError) as t_err:
            TG.Graph.from_original_ids(*args)
        with pytest.raises(ValueError) as j_err:
            JG.Graph.from_original_ids(*args)
        assert str(t_err.value) == str(j_err.value) == msg


def test_refused_file_parses_with_numpy_and_a_warning(tmp_path, jax_native):
    """A '#' comment line is refused by the native parser and taken by
    numpy's: the warning is logged and the arrays are the JAX package's."""
    v = tmp_path / "c.v"
    v.write_text("# a comment\n5\n7\n")
    e = tmp_path / "c.e"
    e.write_text("# a comment\n5 7 0.5\n7 5 0.25\n")
    handler = _Records()
    logger = logging.getLogger("graphtpu_torch.ingest")
    logger.addHandler(handler)
    try:
        got_v = trelabel.parse_vertex_file(str(v))
        got_e = trelabel.parse_edge_file(str(e), True)
    finally:
        logger.removeHandler(handler)
    assert sum("refused" in msg for msg in handler.messages) == 2
    assert np.array_equal(got_v, jrelabel._parse_vertices_numpy(str(v)))
    for a, b in zip(got_e, jrelabel._parse_edges_numpy(str(e), True)):
        assert np.array_equal(a, b)
    with pytest.raises(tnative.NativeRefused):
        tnative.parse_vertices(str(v))


def test_device_sort_kernel_on_cpu_matches_jax():
    """The device sort, run on the CPU, gives the JAX kernel's sort,
    positions and keep mask, and the host lexsort's order."""
    rng = np.random.default_rng(3)
    n, m = 200, 2000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    for prim_src in (True, False):
        for dedup in (True, False):
            got = TG._device_sort_kernel(src, dst, prim_src, dedup, True, "cpu")
            want = JG._device_sort_kernel(jnp.asarray(src), jnp.asarray(dst), prim_src, dedup,
                                          True)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))
            perm = TG._lexsort_edges(src, dst, "src" if prim_src else "dst")
            s, d = src[perm], dst[perm]
            keep = np.ones(m, dtype=bool)
            if dedup:
                keep[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
            for a, b in zip(got, (s, d, perm, keep)):
                assert np.array_equal(a.numpy(), b)
    assert TG._device_sort_kernel(src, dst, True, False, False, "cpu")[2] is None


def test_device_sort_without_a_card_returns_none(monkeypatch):
    """With no CUDA card visible the device sort declines and the Graph is
    sorted on the host."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 500).astype(np.int32)
    dst = rng.integers(0, 50, 500).astype(np.int32)
    monkeypatch.setattr(TG, "DEVICE_SORT_MIN", 1)
    monkeypatch.setattr(TG.torch.cuda, "is_available", lambda: False)
    assert TG._device_sort_edges(src, dst, None, "src", True) is None
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 1 << 62)
    g = TG.Graph(50, src, dst, None, np.arange(50), directed=True, weighted=False)
    perm = TG._lexsort_edges(src, dst, "src")
    keep = np.ones(src.shape[0], dtype=bool)
    keep[1:] = (src[perm][1:] != src[perm][:-1]) | (dst[perm][1:] != dst[perm][:-1])
    assert np.array_equal(g.src, src[perm][keep]) and np.array_equal(g.dst, dst[perm][keep])


@pytest.mark.parametrize("card", [True, False])
def test_sort_takes_the_card_first_then_native(card, monkeypatch, jax_native):
    """A stream of DEVICE_SORT_MIN edges or more is sorted on a visible
    card and the native sort is not called; without a card the native sort
    serves. The device arm is stood in for here (its run on a card is
    tests/test_torch_gpu.py's)."""
    rng = np.random.default_rng(6)
    src = rng.integers(0, 300, 4000).astype(np.int32)
    dst = rng.integers(0, 300, 4000).astype(np.int32)
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 0)
    monkeypatch.setattr(TG, "DEVICE_SORT_MIN", 1)
    monkeypatch.setattr(TG.torch.cuda, "is_available", lambda: card)
    used = []

    def device_sort(s, d, w, primary, dedup):
        used.append("device")
        g = TG._device_sort_kernel(s, d, primary == "src", dedup, False, "cpu")
        return g[0][g[3]].numpy(), g[1][g[3]].numpy(), None

    before = tnative.call_counts["gtio_sort_edges"]
    if card:
        monkeypatch.setattr(TG, "_device_sort_edges", device_sort)
    g = TG.Graph(300, src, dst, None, np.arange(300), directed=True, weighted=False)
    sorts = tnative.call_counts["gtio_sort_edges"] - before
    assert (used, sorts) == ((["device"], 0) if card else ([], 1))
    perm = TG._lexsort_edges(src, dst, "src")
    keep = np.ones(src.shape[0], dtype=bool)
    keep[1:] = (src[perm][1:] != src[perm][:-1]) | (dst[perm][1:] != dst[perm][:-1])
    assert np.array_equal(g.src, src[perm][keep]) and np.array_equal(g.dst, dst[perm][keep])


def test_native_sort_declines_ids_outside_the_range(monkeypatch, jax_native):
    """The native sort returns None for ids outside [0, n) (its -1), and a
    Graph with such ids is sorted by numpy all the same."""
    src = np.array([3, 1, 7, 0], dtype=np.int32)
    dst = np.array([2, 9, 1, 1], dtype=np.int32)
    before = tnative.call_counts["gtio_sort_edges"]
    assert tnative.sort_edges(src, dst, None, 5, True) is None
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 0)
    assert TG._native_sort_edges(src, dst, None, 5, "dst", False) is None
    assert tnative.call_counts["gtio_sort_edges"] == before + 2
    s, d, _ = TG._sort_edges(src, dst, None, 5, "src", True)
    assert s.tolist() == [0, 1, 3, 7] and d.tolist() == [1, 9, 2, 1]


_BUILD_SCRIPT = """
import json, sys
from pathlib import Path
from graphtpu_torch.ingest import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available()
print(json.dumps({"path": str(native.library_path()), "built": native.build_seconds is not None}))
"""


def test_concurrent_first_use_builds_one_library(tmp_path):
    """Six processes using the library at once into an empty build
    directory: one compiles, all load the same file, no temporary stays."""
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}
    env.pop("GRAPHTPU_NATIVE_LIB", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env) for _ in range(6)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip().splitlines()[-1])
    import json

    res = [json.loads(o) for o in outs]
    assert len({r["path"] for r in res}) == 1
    assert sum(r["built"] for r in res) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(res[0]["path"]).name, "native.lock"])


def test_dev_null_turns_the_library_off(monkeypatch, fixtures_dir):
    """GRAPHTPU_NATIVE_LIB=/dev/null: one warning, no exception, numpy
    parses and sorts."""
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setenv("GRAPHTPU_NATIVE_LIB", "/dev/null")
    monkeypatch.setattr(TG, "NATIVE_SORT_MIN", 0)
    handler = _Records()
    logger = logging.getLogger("graphtpu_torch.native")
    logger.addHandler(handler)
    before = dict(tnative.call_counts)
    try:
        assert not tnative.available() and not tnative.available()
        g = load_graph(str(fixtures_dir / "example-directed.v"),
                       str(fixtures_dir / "example-directed.e"), True, True)
        g.pull_arrays()
    finally:
        logger.removeHandler(handler)
    assert len(handler.messages) == 1 and "/dev/null" in handler.messages[0]
    assert tnative.call_counts == before
    assert g.n == 10 and g.nnz == 17


def test_failed_build_or_load_raises(tmp_path, monkeypatch):
    """A compiler that rejects the source raises with its stderr; a library
    that does not load raises; no compiler turns the library off."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.delenv("GRAPHTPU_NATIVE_LIB", raising=False)
    with pytest.raises(RuntimeError, match="native ingest build failed") as err:
        tnative.available()
    assert "error" in str(err.value).split("\n", 1)[1]  # the compiler's stderr
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())

    monkeypatch.setenv("GRAPHTPU_NATIVE_LIB", str(bad))
    with pytest.raises(OSError):
        tnative.available()

    monkeypatch.delenv("GRAPHTPU_NATIVE_LIB")
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "_compiler", lambda: None)
    assert not tnative.available()
