"""Dataset download (counterpart of graphtpu/ingest/download.py): the
reference's dataset-acquisition scripts.

The reference fetches the LDBC Graphalytics distribution archives with
`wget <url> | unzstd | tar -x` per dataset
(small-data-sets/download-dataset-small.sh:13-22) into a `graphs/`
directory that the benchmark config then points at. Here the same
contract is a library function + CLI subcommand:

* a registry of the known Graphalytics dataset names → archive URLs
  (the ten datasets the reference's small-set script pulls, same public
  mirror), overridable with ``--base-url`` for private mirrors;
* streaming decompress-while-downloading (``.tar.zst`` via the
  `zstandard` module, ``.tar.gz``/``.tar`` via stdlib) — archives are
  never staged on disk, matching the reference's pipe;
* idempotent skip-if-exists keyed on the dataset's ``.properties``
  descriptor, like load-graph.sh's artifact checks;
* ``file://`` URLs work, so the path is testable with zero egress.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
from pathlib import Path

from graphtpu_torch.utils.logging import get_logger

log = get_logger("download")

# The reference's public mirror (download-dataset-small.sh:13).
DEFAULT_BASE_URL = "https://pub-383410a98aef4cb686f0c7601eddd25f.r2.dev/graphalytics"

# Datasets the reference's small-set script provisions
# (download-dataset-small.sh:13-22).
SMALL_DATASETS = (
    "cit-Patents",
    "datagen-7_5-fb",
    "datagen-7_6-fb",
    "datagen-7_7-zf",
    "datagen-7_8-zf",
    "datagen-7_9-fb",
    "dota-league",
    "graph500-22",
    "kgs",
    "wiki-Talk",
)


def dataset_url(name: str, base_url: str = DEFAULT_BASE_URL) -> str:
    return f"{base_url.rstrip('/')}/{name}.tar.zst"


def _open_tar_stream(url: str, reader):
    """Wrap the (possibly compressed) byte stream as a streaming tarfile."""
    if url.endswith(".zst"):
        try:
            import zstandard
        except ImportError as e:  # an optional module: the other formats need none
            raise ImportError(f"a .zst archive needs the zstandard module, which is not "
                              f"installed ({url})") from e
        return tarfile.open(
            fileobj=zstandard.ZstdDecompressor().stream_reader(reader), mode="r|"
        )
    if url.endswith((".gz", ".tgz")):
        return tarfile.open(fileobj=reader, mode="r|gz")
    return tarfile.open(fileobj=reader, mode="r|")


def _safe_members(tf, dest: Path):
    """Reject archive members that would escape the destination dir."""
    dest = dest.resolve()
    for m in tf:
        p = (dest / m.name).resolve()
        # commonpath, not startswith: "<dest>-sibling" must not pass
        if os.path.commonpath([p, dest]) != str(dest):
            raise ValueError(f"archive member escapes destination: {m.name!r}")
        if not (m.isfile() or m.isdir()):
            log.warning("skipping non-regular archive member %s", m.name)
            continue
        yield m


def download_dataset(
    name: str,
    graphs_dir,
    base_url: str = DEFAULT_BASE_URL,
    url: str | None = None,
    force: bool = False,
) -> Path:
    """Fetch one dataset archive into `graphs_dir` (streaming, idempotent).

    Returns the dataset's `.properties` descriptor path. `url` overrides
    the registry/base-url resolution (any http(s)/file URL to a
    .tar.zst/.tar.gz/.tar archive).
    """
    graphs_dir = Path(graphs_dir)
    graphs_dir.mkdir(parents=True, exist_ok=True)
    props = graphs_dir / f"{name}.properties"
    nested = graphs_dir / name / f"{name}.properties"
    if not force:
        # archives unpack flat OR under a <name>/ subdirectory — honor
        # skip-if-exists for both layouts (re-streaming a multi-GB
        # archive on every call would break the load-graph.sh contract)
        for existing in (props, nested):
            if existing.exists():
                log.info(
                    "dataset %s already present (%s) — skipping download",
                    name, existing,
                )
                return existing
    src = url or dataset_url(name, base_url)
    log.info("downloading %s from %s", name, src)
    with urllib.request.urlopen(src) as reader:
        with _open_tar_stream(src, reader) as tf:
            try:
                tf.extractall(
                    graphs_dir, members=_safe_members(tf, graphs_dir), filter="data"
                )
            except TypeError:
                # Python < 3.10.12 lacks the filter kwarg; _safe_members
                # still rejects traversal/non-regular members
                tf.extractall(graphs_dir, members=_safe_members(tf, graphs_dir))
    # archives may unpack either flat or under a <name>/ subdirectory;
    # normalize the flat-descriptor expectation by searching one level deep
    if not props.exists():
        if nested.exists():
            props = nested
        else:
            raise FileNotFoundError(
                f"archive for {name!r} did not contain {name}.properties"
            )
    log.info("dataset %s ready: %s", name, props)
    return props


def download_small_datasets(
    graphs_dir, base_url: str = DEFAULT_BASE_URL, force: bool = False
) -> list:
    """Provision every dataset from the reference's small-set script."""
    return [
        download_dataset(name, graphs_dir, base_url=base_url, force=force)
        for name in SMALL_DATASETS
    ]
