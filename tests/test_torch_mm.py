"""graphtpu_torch.ingest.mm against graphtpu.ingest.mm: the same
MatrixMarket and vtx bytes written, the same Graph read back."""

import numpy as np
import pytest

from graphtpu.ingest import mm as jmm
from graphtpu.ingest.relabel import relabel as j_relabel
from graphtpu.utils import synth as jsynth

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ingest import mm as tmm
from graphtpu_torch.ingest.relabel import relabel
from graphtpu_torch.utils import synth as tsynth

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _assert_graphs_equal(tg, jg):
    assert (tg.n, tg.nnz, tg.directed, tg.weighted) == (jg.n, jg.nnz, jg.directed, jg.weighted)
    for name in ("src", "dst", "w", "mapping"):
        assert np.array_equal(getattr(tg, name), np.asarray(getattr(jg, name))), name


@pytest.mark.parametrize("directed,weighted,banner", [
    (True, True, "%%MatrixMarket matrix coordinate real general"),
    (False, False, "%%MatrixMarket matrix coordinate integer symmetric"),
    (False, True, "%%MatrixMarket matrix coordinate real symmetric"),
])
def test_mtx_roundtrip_matches_jax(tmp_path, directed, weighted, banner):
    """write_mtx writes the JAX package's bytes for the same graph, and
    read_mtx of them gives the original graph and the JAX reader's."""
    tg = tsynth.uniform_graph(50, 300, directed=directed, weighted=weighted, seed=0)
    jg = jsynth.uniform_graph(50, 300, directed=directed, weighted=weighted, seed=0)
    tmm.write_mtx(tg, tmp_path / "t.mtx")
    jmm.write_mtx(jg, tmp_path / "j.mtx")
    text = (tmp_path / "t.mtx").read_text()
    assert text == (tmp_path / "j.mtx").read_text()
    assert text.splitlines()[:2] == [banner, "%%GraphBLAS GrB_FP64" if weighted
                                     else "%%GraphBLAS GrB_BOOL"]
    back = tmm.read_mtx(tmp_path / "t.mtx")
    assert isinstance(back, Graph)
    _assert_graphs_equal(back, jmm.read_mtx(tmp_path / "t.mtx"))
    assert np.array_equal(back.src, tg.src) and np.array_equal(back.dst, tg.dst)
    assert np.allclose(back.w, tg.w)


def test_vtx_roundtrip_and_fixture_mtx(tmp_path, fixtures_dir):
    """A vtx file of sparse ids round-trips; a fixture written as .mtx + .vtx
    reads back as the JAX package's read of the same files."""
    name = "example-directed"
    g = relabel(str(fixtures_dir / f"{name}.v"), str(fixtures_dir / f"{name}.e"), True, True)
    jg = j_relabel(str(fixtures_dir / f"{name}.v"), str(fixtures_dir / f"{name}.e"), True, True)
    g.mapping = np.arange(g.n, dtype=np.int64) * 7 + 2**60
    jg.mapping = g.mapping.copy()
    tmm.write_vtx(g, tmp_path / "graph.vtx")
    jmm.write_vtx(jg, tmp_path / "j.vtx")
    assert (tmp_path / "graph.vtx").read_bytes() == (tmp_path / "j.vtx").read_bytes()
    mapping = tmm.read_vtx(tmp_path / "graph.vtx")
    assert mapping.dtype == np.int64 and np.array_equal(mapping, g.mapping)
    tmm.write_mtx(g, tmp_path / "graph.mtx")
    _assert_graphs_equal(tmm.read_mtx(tmp_path / "graph.mtx", mapping),
                         jmm.read_mtx(tmp_path / "graph.mtx", jmm.read_vtx(tmp_path / "j.vtx")))


@pytest.mark.parametrize("text,match", [
    ("1 1 0\n", "missing MatrixMarket banner"),
    ("%%MatrixMarket matrix array real general\n2 2\n", "only coordinate"),
    ("%%MatrixMarket matrix coordinate real general\n2 3 0\n", "square"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 2 1.0\n", "expected 2 entries"),
])
def test_read_mtx_rejects_what_jax_rejects(tmp_path, text, match):
    p = tmp_path / "bad.mtx"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        tmm.read_mtx(p)
    with pytest.raises(ValueError, match=match):
        jmm.read_mtx(p)
