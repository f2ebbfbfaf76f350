"""graphtpu_torch.ingest.download and the CLI's download command, with
file:// archives only (no network): .tar, .tar.gz and .tar.zst, unsafe
member paths refused, a .tar.zst without the zstandard module refused by
name, and a downloaded dataset that then loads and validates."""

import io
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest

from graphtpu.ingest import download as jdownload

from graphtpu_torch.cli import main
from graphtpu_torch.ingest.download import (
    DEFAULT_BASE_URL, SMALL_DATASETS, dataset_url, download_dataset,
)
from graphtpu_torch.ingest.loader import load_graph_from_spec
from graphtpu_torch.utils.config import GraphSpec

from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _make_archive(tmp_path, fixtures_dir, name, compression="zst", member_prefix=""):
    """example-directed's .v, .e and .properties, renamed to ``name``, as
    <name>.tar[.zst|.gz]."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for suffix in (".v", ".e", ".properties"):
            data = (fixtures_dir / f"example-directed{suffix}").read_bytes()
            if suffix == ".properties":
                data = data.replace(b"example-directed", name.encode())
            info = tarfile.TarInfo(name=f"{member_prefix}{name}{suffix}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    raw = buf.getvalue()
    if compression == "zst":
        import zstandard

        path = tmp_path / f"{name}.tar.zst"
        path.write_bytes(zstandard.ZstdCompressor().compress(raw))
    elif compression == "gz":
        import gzip

        path = tmp_path / f"{name}.tar.gz"
        path.write_bytes(gzip.compress(raw))
    else:
        path = tmp_path / f"{name}.tar"
        path.write_bytes(raw)
    return path.as_uri()


@pytest.mark.parametrize("compression", ["zst", "gz", "tar"])
def test_download_extracts_and_loads(tmp_path, fixtures_dir, compression):
    url = _make_archive(tmp_path, fixtures_dir, "mini-set", compression)
    props = download_dataset("mini-set", tmp_path / "graphs", url=url)
    jprops = jdownload.download_dataset("mini-set", tmp_path / "jgraphs", url=url)
    assert props == tmp_path / "graphs" / "mini-set.properties"
    for suffix in (".v", ".e", ".properties"):
        assert (props.parent / f"mini-set{suffix}").read_bytes() == \
            (jprops.parent / f"mini-set{suffix}").read_bytes()
    g = load_graph_from_spec(GraphSpec.from_properties(props),
                             intermediate_dir=str(tmp_path / "im"))
    assert (g.n, g.nnz) == (10, 17)


def test_download_skip_if_exists_and_force(tmp_path, fixtures_dir):
    url = _make_archive(tmp_path, fixtures_dir, "mini-set")
    gdir = tmp_path / "graphs"
    p1 = download_dataset("mini-set", gdir, url=url)
    marker = gdir / "mini-set.v"
    marker.write_text("sentinel")
    assert download_dataset("mini-set", gdir, url="file:///nonexistent.tar") == p1
    assert marker.read_text() == "sentinel"
    download_dataset("mini-set", gdir, url=url, force=True)
    assert marker.read_text() != "sentinel"


def test_download_nested_layout(tmp_path, fixtures_dir):
    url = _make_archive(tmp_path, fixtures_dir, "mini-set", member_prefix="mini-set/")
    props = download_dataset("mini-set", tmp_path / "graphs", url=url)
    assert props == tmp_path / "graphs" / "mini-set" / "mini-set.properties"


@pytest.mark.parametrize("member", ["../evil.properties", "/tmp/evil-abs.properties",
                                    "../graphs-sibling/evil.properties"])
def test_download_rejects_escaping_members(tmp_path, member):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        info = tarfile.TarInfo(name=member)
        info.size = 4
        tf.addfile(info, io.BytesIO(b"pwnd"))
    path = tmp_path / "evil.tar"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="escapes"):
        download_dataset("evil", tmp_path / "graphs", url=path.as_uri())
    assert not (tmp_path / "evil.properties").exists()
    assert not (tmp_path / "graphs-sibling").exists()


def test_zst_without_zstandard_names_the_module(tmp_path, fixtures_dir, monkeypatch, capsys):
    """Without the zstandard module a .tar.zst fails by name, in the library
    and in the CLI (exit 1, no traceback); a .tar.gz still works."""
    zst = _make_archive(tmp_path, fixtures_dir, "mini-set", "zst")
    gz = _make_archive(tmp_path, fixtures_dir, "mini-gz", "gz")
    monkeypatch.setitem(sys.modules, "zstandard", None)  # import raises ImportError
    with pytest.raises(ImportError, match="zstandard"):
        download_dataset("mini-set", tmp_path / "graphs", url=zst)
    rc = main(["download", "--graph", "mini-set", "--graphs-dir", str(tmp_path / "graphs"),
               "--url", zst])
    assert rc == 1 and "zstandard" in capsys.readouterr().err
    assert download_dataset("mini-gz", tmp_path / "graphs", url=gz).exists()


def test_registry_matches_jax():
    assert SMALL_DATASETS == jdownload.SMALL_DATASETS
    assert DEFAULT_BASE_URL == jdownload.DEFAULT_BASE_URL
    assert dataset_url("kgs") == jdownload.dataset_url("kgs")
    assert dataset_url("kgs", "http://m/x/").endswith("/x/kgs.tar.zst")


def test_cli_download_then_run_validates(tmp_path, fixtures_dir):
    """``python -m graphtpu_torch.cli download --url file://...``, then a
    ``run`` of BFS on what it unpacked validates against the golden."""
    url = _make_archive(tmp_path, fixtures_dir, "mini-set", "gz")
    gdir = tmp_path / "graphs"

    def cli(*argv):
        return subprocess.run([sys.executable, "-m", "graphtpu_torch.cli", *argv],
                              capture_output=True, text=True, cwd=REPO, timeout=300)

    proc = cli("download", "--graph", "mini-set", "--graphs-dir", str(gdir), "--url", url)
    assert proc.returncode == 0 and "ready:" in proc.stdout, proc.stderr
    proc = cli("run", "--graph-properties", str(gdir / "mini-set.properties"),
               "--algorithm", "bfs", "--device", "cpu", "--intermediate-dir",
               str(tmp_path / "im"), "--validation-file",
               str(fixtures_dir / "example-directed-BFS"))
    assert proc.returncode == 0 and "validation: PASS" in proc.stdout, proc.stdout + proc.stderr


def test_cli_download_errors(tmp_path, capsys):
    rc = main(["download", "--graph", "nope", "--graphs-dir", str(tmp_path / "graphs"),
               "--url", (tmp_path / "missing.tar").as_uri()])
    assert rc == 1 and "download failed" in capsys.readouterr().err
    assert main(["download", "--graphs-dir", str(tmp_path / "graphs")]) == 2
