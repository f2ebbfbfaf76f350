"""graphtpu_torch's .grb/.vtb binary graph files (ingest/grb.py) and the
loader branch that reads a dataset directory holding only graph.grb +
graph.vtb, against the JAX package's reader and the text ingest.

Byte layouts are compared exactly (digests, struct fields), graphs array by
array, and a golden validates through the port's platform on the CPU.
"""

import hashlib
import io
import shutil
import struct

import numpy as np
import pytest

from graphtpu.ingest import grb as jgrb

from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ingest import grb
from graphtpu_torch.ingest.loader import load_graph
from graphtpu_torch.ingest.relabel import relabel
from graphtpu_torch.utils.config import GraphSpec, PlatformConfig
from graphtpu_torch.utils.synth import uniform_graph

from torch_native_env import jax_native_on_port_build  # noqa: F401

INDPTR = np.array([0, 2, 3, 3], dtype=np.uint64)
INDICES = np.array([1, 2, 0], dtype=np.uint64)
VALS = np.array([1.5, 2.5, 3.5], dtype=np.float64)


def _hypersparse_bytes():
    """A hypersparse CSR [6, 6] built byte by byte (graphio.h): rows 1 and
    4 stored, FP64 values."""
    ah = np.array([1, 4], dtype="<u8")
    ap = np.array([0, 2, 3], dtype="<u8")
    ai = np.array([0, 5, 2], dtype="<u8")
    ax = np.array([7.0, 8.0, 9.0], dtype="<f8")
    buf = io.BytesIO()
    buf.write(b"x" * 511 + b"\0")
    buf.write(struct.pack("<iidQQqQQiQ", 0, 1, 0.0625, 6, 6, -1, len(ah), len(ai), 10, 8))
    for a in (ap, ah, ai, ax):
        buf.write(a.tobytes())
    return buf.getvalue()


def test_vtb_roundtrip(tmp_path):
    ids = np.array([3, 9, 12, 1025, 2**40], dtype=np.uint64)
    grb.write_vtb(tmp_path / "graph.vtb", ids)
    raw = (tmp_path / "graph.vtb").read_bytes()
    assert len(raw) == 8 * len(ids)  # raw little-endian u64 records
    assert struct.unpack("<Q", raw[:8])[0] == 3
    np.testing.assert_array_equal(grb.read_vtb(tmp_path / "graph.vtb"), ids)
    np.testing.assert_array_equal(jgrb.read_vtb(tmp_path / "graph.vtb"), ids)


def test_grb_header_and_scalar_layout(tmp_path):
    grb.write_grb(tmp_path / "m.grb", INDPTR, INDICES, VALS, 3, 3)
    raw = (tmp_path / "m.grb").read_bytes()
    assert raw[:28] == b"SuiteSparse:GraphBLAS matrix"
    assert raw[511:512] == b"\0"
    fmt, kind, hyper, nrows, ncols, nonempty, nvec, nvals, tc, ts = struct.unpack_from(
        "<iidQQqQQiQ", raw, 512)
    assert (fmt, kind, hyper, nonempty) == (0, 2, 0.0625, -1)  # CSR, GxB_SPARSE, not iso
    assert (nrows, ncols, nvec, nvals) == (3, 3, 3, 3)
    assert (tc, ts) == (10, 8)                                   # GrB_FP64
    off = 512 + 68                                               # packed scalars
    np.testing.assert_array_equal(np.frombuffer(raw, "<u8", 4, off), INDPTR)
    np.testing.assert_array_equal(np.frombuffer(raw, "<u8", 3, off + 32), INDICES)
    np.testing.assert_array_equal(np.frombuffer(raw, "<f8", 3, off + 56), VALS)


def test_grb_roundtrip_weighted(tmp_path):
    grb.write_grb(tmp_path / "m.grb", INDPTR, INDICES, VALS, 3, 3)
    ip, ai, ax, nr, nc, by_row = grb.read_grb(tmp_path / "m.grb")
    assert by_row and (nr, nc) == (3, 3)
    np.testing.assert_array_equal(ip, INDPTR.astype(np.int64))
    np.testing.assert_array_equal(ai, INDICES.astype(np.int64))
    np.testing.assert_array_equal(ax, VALS)


def test_grb_roundtrip_pattern_iso(tmp_path):
    grb.write_grb(tmp_path / "m.grb", np.array([0, 1, 2], np.uint64),
                  np.array([1, 0], np.uint64), None, 2, 2)
    raw = (tmp_path / "m.grb").read_bytes()
    assert struct.unpack_from("<ii", raw, 512) == (0, 102)  # sparse + iso
    ip, ai, ax, nr, nc, by_row = grb.read_grb(tmp_path / "m.grb")
    assert ax is None  # a pattern: structure only
    np.testing.assert_array_equal(ai, [1, 0])
    np.testing.assert_array_equal(ip, [0, 1, 2])


def test_grb_reads_hypersparse(tmp_path):
    (tmp_path / "h.grb").write_bytes(_hypersparse_bytes())
    ip, ai, ax, nr, nc, by_row = grb.read_grb(tmp_path / "h.grb")
    assert (nr, nc, by_row) == (6, 6, True)
    np.testing.assert_array_equal(ip, [0, 0, 2, 2, 2, 3, 3])
    np.testing.assert_array_equal(ai, [0, 5, 2])
    np.testing.assert_array_equal(ax, [7.0, 8.0, 9.0])


def test_grb_refuses_bitmap_and_truncated(tmp_path):
    raw = bytearray(_hypersparse_bytes())
    struct.pack_into("<i", raw, 516, 4)  # kind: bitmap
    (tmp_path / "b.grb").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bitmap/full"):
        grb.read_grb(tmp_path / "b.grb")
    (tmp_path / "t.grb").write_bytes(b"x" * 100)
    with pytest.raises(ValueError, match="truncated"):
        grb.read_grb(tmp_path / "t.grb")


def test_grb_byte_golden(tmp_path):
    """The exact bytes of two small files, pinned by digest: the same as the
    JAX package's golden, so neither package's layout can drift."""
    grb.write_grb(tmp_path / "g.grb", INDPTR, INDICES, VALS, 3, 3)
    raw = (tmp_path / "g.grb").read_bytes()
    assert len(raw) == 660
    assert hashlib.sha256(raw).hexdigest() == (
        "983521e13a96f49bc832ba1c21ee882da569a41e9aff9115f95889e0cda288f9")
    grb.write_grb(tmp_path / "iso.grb", INDPTR, INDICES, None, 3, 3)
    raw = (tmp_path / "iso.grb").read_bytes()
    assert len(raw) == 637
    assert hashlib.sha256(raw).hexdigest() == (
        "f35b8fbd110ec9e357a1472c2b86afe76e103ee15578317b3de6d965ac0cfe19")


@pytest.mark.parametrize("kind", ["weighted", "iso", "hypersparse", "csc-int32"])
def test_read_grb_matches_jax(tmp_path, kind):
    """The port's reader and the JAX package's on the same bytes, and
    either writer's bytes equal the other's."""
    p = tmp_path / "m.grb"
    if kind == "hypersparse":
        p.write_bytes(_hypersparse_bytes())
    else:
        vals = {"weighted": VALS, "iso": None,
                "csc-int32": np.array([4, -5, 6], dtype=np.int32)}[kind]
        by_row = kind != "csc-int32"
        grb.write_grb(p, INDPTR, INDICES, vals, 3, 3, by_row=by_row)
        jgrb.write_grb(tmp_path / "j.grb", INDPTR, INDICES, vals, 3, 3, by_row=by_row)
        assert p.read_bytes() == (tmp_path / "j.grb").read_bytes()
    got, want = grb.read_grb(p), jgrb.read_grb(p)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("gname,directed", [("example-directed", True),
                                            ("example-undirected", False)])
def test_graph_binary_cache_parity_with_text_ingest(fixtures_dir, tmp_path, gname, directed):
    """save_graph_grb + load_graph_grb give the text-ingested graph back
    (structure, weights, mapping); the JAX package reads the same files."""
    g = relabel(str(fixtures_dir / f"{gname}.v"), str(fixtures_dir / f"{gname}.e"),
                directed, True)
    grb.save_graph_grb(g, tmp_path)
    g2 = grb.load_graph_grb(tmp_path, directed, True)
    assert (g2.n, g2.nnz) == (g.n, g.nnz)
    for name in ("src", "dst", "w", "mapping"):
        np.testing.assert_array_equal(getattr(g2, name), getattr(g, name), err_msg=name)
    jg = jgrb.load_graph_grb(tmp_path, directed, True)
    np.testing.assert_array_equal(jg.src, g.src)
    np.testing.assert_array_equal(jg.dst, g.dst)
    np.testing.assert_array_equal(jg.w, g.w)


def test_graph_binary_cache_parity_unweighted(tmp_path):
    g = uniform_graph(64, 300, directed=True, weighted=False, seed=5)
    g.mapping = g.mapping * 3 + 7  # sparse original ids
    grb.save_graph_grb(g, tmp_path)
    assert grb.read_grb(tmp_path / "graph.grb")[2] is None  # a pattern matrix
    g2 = grb.load_graph_grb(tmp_path, True, False)
    for name in ("src", "dst", "mapping"):
        np.testing.assert_array_equal(getattr(g2, name), getattr(g, name), err_msg=name)
    with pytest.raises(ValueError, match="pattern matrix"):
        grb.load_graph_grb(tmp_path, True, True)


@pytest.mark.parametrize("gname,directed", [("example-directed", True),
                                            ("example-undirected", False)])
def test_loader_reads_a_grb_only_directory(fixtures_dir, tmp_path, gname, directed):
    """A dataset directory with graph.grb + graph.vtb and no .v/.e loads
    through the loader to the text-ingested Graph, writes the port's cache
    and loads from that the next time."""
    want = relabel(str(fixtures_dir / f"{gname}.v"), str(fixtures_dir / f"{gname}.e"),
                   directed, True)
    ds = tmp_path / "ds"
    grb.save_graph_grb(want, ds)
    inter = tmp_path / "im"
    for _ in range(2):  # from the .grb files, then from the port's cache
        g = load_graph(str(ds / f"{gname}.v"), str(ds / f"{gname}.e"), directed, True,
                       graph_name=gname, intermediate_dir=str(inter))
        assert g.name == gname and (inter / gname / "graph.npz").exists()
        assert (g.n, g.nnz, g.directed, g.weighted) == (want.n, want.nnz, directed, True)
        for name in ("src", "dst", "w", "mapping"):
            np.testing.assert_array_equal(getattr(g, name), getattr(want, name), err_msg=name)
    # without a cache directory nothing is written
    g = load_graph(str(ds / "x.v"), str(ds / "x.e"), directed, True)
    assert g.nnz == want.nnz and not (tmp_path / "x").exists()


@pytest.mark.parametrize("algo", ["bfs", "pr", "lcc", "sssp"])
def test_golden_validates_from_a_grb_only_directory(fixtures_dir, tmp_path, algo):
    """example-directed, its text files replaced by graph.grb + graph.vtb,
    through GraphTorchPlatform on the CPU against its golden."""
    name = "example-directed"
    ds = tmp_path / "ds"
    ds.mkdir()
    shutil.copy(fixtures_dir / f"{name}.properties", ds)
    g = relabel(str(fixtures_dir / f"{name}.v"), str(fixtures_dir / f"{name}.e"), True, True)
    grb.save_graph_grb(g, ds)
    spec = GraphSpec.from_properties(ds / f"{name}.properties")
    assert not (ds / f"{name}.v").exists()
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path / "im")))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    res = plat.run(spec, algo)
    plat.finalize()
    ok, msg = validate_result(res, plat.graphs[spec.name],
                              str(fixtures_dir / f"{name}-{algo.upper()}"))
    assert ok, msg
