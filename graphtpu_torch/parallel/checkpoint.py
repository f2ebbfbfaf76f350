"""Sharded checkpoints (counterpart of graphtpu/parallel/checkpoint.py).

The ``shard-checkpoints`` key (default on) persists, under
``<intermediate>/<graph>/shards-<D>/``, what a distributed run builds on
the host from a named graph: the pull partitions (``ShardedGraph.pull_host``,
and ``pull_symmetrized_host`` under ``<graph>-sym``) and the slab plans
(``plan-<kind>/``: ``pr-pull``, ``cdlp-incidence``, ``wcc-slab``). A later run,
in a fresh process or a fresh ShardedGraph, restores them instead of
rebuilding (the reference's skip-if-exists contract, load-graph.sh:50-67),
and installs each rank's part as a built one is installed.

The files are the JAX package's, file for file, so either package loads
what the other wrote: one ``np.savez_compressed`` npz per rank (``src``,
``dst_local``, ``count`` and, when weighted, ``w``; a plan's ``bucket<i>``
and ``heavy_c``, ``heavy_nb``, ``heavy_ip``), a plan's ``replicated.npz``
(``inv_perm``, ``has_neighbors``) and ``manifest.json`` with the JAX keys
and versions. A reader rejects a manifest that differs from the run in any
field the JAX reader compares, with a warning, and the caller rebuilds.

Who writes is the JAX package's choice: the caller of a worker mesh
writes every rank's shard; under ``multihost.initialize`` (one rank a
process) each process writes its own rank's shard, and the primary
(``multihost.is_primary``) the replicated arrays and the manifest. Unlike
the JAX package's writer, each file goes through a temporary name unique to
the writing process and an atomic rename, and the manifest goes first
(removed, then a barrier) and last (written, after a barrier that waits for
every shard): a reader that sees a manifest sees its shards, and one whose
manifest changed while it read rejects what it read. Under
``multihost.initialize`` the processes also agree on every load (one
all-reduce): all restore or all rebuild, so all reach the writer's
barriers. A file that fails to read is rejected like an incompatible
manifest; a file that fails to write raises.
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

import torch.distributed as dist

from graphtpu_torch.ops.slab import bucket_policy_key
from graphtpu_torch.parallel import multihost
from graphtpu_torch.parallel.partition import ShardedCOO
from graphtpu_torch.utils.logging import get_logger

log = get_logger("ckpt")

MANIFEST = "manifest.json"
CKPT_VERSION = 3
PLAN_VERSION = 1
# what a damaged or vanished file raises on read
_READ_ERRORS = (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile)


def _dir(intermediate_dir, graph_name: str, num_devices: int) -> Path:
    return Path(intermediate_dir) / graph_name / f"shards-{num_devices}"


def _plan_dir(intermediate_dir, graph_name: str, num_devices: int, kind: str) -> Path:
    return _dir(intermediate_dir, graph_name, num_devices) / f"plan-{kind}"


def exists(intermediate_dir, graph_name: str, num_devices: int) -> bool:
    return (_dir(intermediate_dir, graph_name, num_devices) / MANIFEST).exists()


def plan_exists(intermediate_dir, graph_name: str, num_devices: int, kind: str) -> bool:
    return (_plan_dir(intermediate_dir, graph_name, num_devices, kind) / MANIFEST).exists()


# -- writing -------------------------------------------------------------------


def _tmp(path: Path) -> Path:
    return path.with_name(f"{path.name}.{os.getpid()}.tmp")


def _write_npz(path: Path, **arrays) -> None:
    tmp = _tmp(path).with_suffix(".npz")  # savez appends .npz to any other name
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _write(d: Path, num_devices: int, shard, manifest: dict, replicated=None) -> None:
    """Write a checkpoint into ``d``: ``shard(dev)`` (the arrays of rank
    ``dev``) for each rank this process holds, ``replicated`` and then the
    manifest on the primary. No reader takes ``d`` between the removal of
    its old manifest and the new one."""
    if multihost.is_primary():
        d.mkdir(parents=True, exist_ok=True)
        (d / MANIFEST).unlink(missing_ok=True)
    multihost.barrier()
    d.mkdir(parents=True, exist_ok=True)
    # one rank a process under multihost.initialize; the caller of a
    # worker mesh holds them all
    own = [dist.get_rank()] if multihost.is_multihost() else range(num_devices)
    for dev in own:
        _write_npz(d / f"shard-{dev}.npz", **shard(dev))
    if replicated is not None and multihost.is_primary():
        _write_npz(d / "replicated.npz", **replicated)
    multihost.barrier()
    if multihost.is_primary():
        _commit(d, manifest)


def _commit(d: Path, manifest: dict) -> None:
    tmp = _tmp(d / MANIFEST)
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, d / MANIFEST)


def save_pull(sg, intermediate_dir, graph_name: str) -> Path:
    """Persist the pull partition of ``sg`` (one npz per rank)."""
    return save_pull_named(sg, intermediate_dir, graph_name, sg.pull_host(), sg.graph)


def save_pull_named(sg, intermediate_dir, graph_name: str, coo: ShardedCOO,
                    source_graph) -> Path:
    """save_pull for any host partition of ``sg``'s ranks (the symmetrized
    pull under "<name>-sym") built from ``source_graph``."""
    d = _dir(intermediate_dir, graph_name, sg.num_devices)
    weighted = bool(source_graph.weighted)

    def shard(dev):
        arrays = {"src": coo.src[dev], "dst_local": coo.dst_local[dev],
                  "count": np.int64(coo.valid[dev].sum())}
        if weighted:
            arrays["w"] = coo.w[dev]
        return arrays

    _write(d, sg.num_devices, shard, {
        "version": CKPT_VERSION, "num_devices": sg.num_devices, "n": sg.n, "n_pad": sg.n_pad,
        "rows_per_dev": sg.rows_per_dev, "wdtype": sg.wdtype.name, "weighted": weighted,
        "edges_per_dev": int(coo.src.shape[1]),
    })
    log.info("sharded checkpoint written: %s (%d shards)", d, sg.num_devices)
    return d


def save_plan(plan, intermediate_dir, graph_name: str, num_devices: int, n: int, kind: str,
              buckets) -> Path:
    """Persist a DistSlabPlan: each rank's bucket slices and heavy stream,
    the replicated assembly arrays, then the manifest."""
    d = _plan_dir(intermediate_dir, graph_name, num_devices, kind)

    def shard(dev):
        arrays = {f"bucket{i}": s[dev] for i, s in enumerate(plan.bucket_slabs)}
        if plan.heavy is not None:
            for k, a in zip(("heavy_c", "heavy_nb", "heavy_ip"), plan.heavy):
                arrays[k] = a[dev]
        return arrays

    _write(d, num_devices, shard, {
        "version": PLAN_VERSION, "num_devices": num_devices, "n": n, "kind": kind,
        "buckets": bucket_policy_key(buckets), "num_buckets": len(plan.bucket_slabs),
        "heavy": plan.heavy is not None,
    }, replicated={"inv_perm": plan.inv_perm, "has_neighbors": plan.has_neighbors})
    log.info("slab plan checkpoint written: %s (%d shards)", d, num_devices)
    return d


# -- reading -------------------------------------------------------------------


def _manifest(d: Path):
    """(manifest, the file's identity); None when absent or unreadable (the
    JAX package writes it in place)."""
    try:
        st = (d / MANIFEST).stat()
        return json.loads((d / MANIFEST).read_text()), (st.st_ino, st.st_mtime_ns)
    except FileNotFoundError:
        return None
    except ValueError as e:
        log.warning("checkpoint manifest at %s unreadable (%s): ignoring", d, e)
        return None


def _still(d: Path, ident) -> bool:
    """True when the manifest read before the shards is still in place."""
    try:
        st = (d / MANIFEST).stat()
    except FileNotFoundError:
        return False
    return (st.st_ino, st.st_mtime_ns) == ident


def load_pull(sg, intermediate_dir, graph_name: str) -> Optional[ShardedCOO]:
    """The pull partition saved for ``sg``'s graph and ranks, as the host
    [D, m_pad] arrays ``ShardedGraph.pull_host`` gives; None when absent or
    incompatible."""
    return load_pull_named(sg, intermediate_dir, graph_name)


def load_pull_named(sg, intermediate_dir, graph_name: str,
                    source_graph_fn=None) -> Optional[ShardedCOO]:
    """load_pull for any named partition (e.g. "<name>-sym").
    ``source_graph_fn`` yields the graph whose weightedness the manifest
    must match (default ``sg.graph``); it is called only when a manifest
    exists."""
    coo = _load_pull_named(sg, intermediate_dir, graph_name, source_graph_fn)
    return coo if multihost.everywhere(coo is not None) else None


def _load_pull_named(sg, intermediate_dir, graph_name: str, source_graph_fn):
    d = _dir(intermediate_dir, graph_name, sg.num_devices)
    found = _manifest(d)
    if found is None:
        return None
    manifest, ident = found
    src_graph = source_graph_fn() if source_graph_fn is not None else sg.graph
    if (manifest.get("version") != CKPT_VERSION
            or manifest.get("num_devices") != sg.num_devices
            or manifest.get("n") != sg.n
            or manifest.get("rows_per_dev") != sg.rows_per_dev
            or manifest.get("wdtype") != sg.wdtype.name
            or manifest.get("weighted") != bool(src_graph.weighted)):
        log.warning("sharded checkpoint at %s incompatible: ignoring", d)
        return None
    cols = {"src": [], "dst_local": [], "w": [], "valid": []}
    try:
        m_pad = manifest["edges_per_dev"]
        for dev in range(sg.num_devices):
            with np.load(d / f"shard-{dev}.npz") as z:
                valid = np.zeros(m_pad, dtype=bool)
                valid[:int(z["count"])] = True
                cols["src"].append(z["src"])
                cols["dst_local"].append(z["dst_local"])
                # unweighted: 1.0 on the edges and 0 on the padding, as built
                cols["w"].append(z["w"] if manifest["weighted"] else valid.astype(sg.wdtype))
            cols["valid"].append(valid)
        coo = ShardedCOO(*(np.stack(cols[k]) for k in ShardedCOO._fields[:4]))
    except _READ_ERRORS as e:
        log.warning("sharded checkpoint at %s unreadable (%s): ignoring", d, e)
        return None
    if any(a.shape != (sg.num_devices, m_pad) for a in coo[:4]) or not _still(d, ident):
        log.warning("sharded checkpoint at %s changed or malformed: ignoring", d)
        return None
    log.info("sharded checkpoint loaded: %s", d)
    return coo


def load_plan(intermediate_dir, graph_name: str, kind: str, num_devices: int, n: int, buckets):
    """The DistSlabPlan saved for these ranks, graph size, kind and bucket
    choice, as host arrays; None when absent or incompatible."""
    plan = _load_plan(intermediate_dir, graph_name, kind, num_devices, n, buckets)
    return plan if multihost.everywhere(plan is not None) else None


def _load_plan(intermediate_dir, graph_name: str, kind: str, num_devices: int, n: int, buckets):
    from graphtpu_torch.parallel.slab_cdlp import DistSlabPlan

    d = _plan_dir(intermediate_dir, graph_name, num_devices, kind)
    found = _manifest(d)
    if found is None:
        return None
    manifest, ident = found
    if (manifest.get("version") != PLAN_VERSION
            or manifest.get("num_devices") != num_devices
            or manifest.get("n") != n
            or manifest.get("kind") != kind
            or manifest.get("buckets") != bucket_policy_key(buckets)):
        log.warning("slab plan checkpoint at %s incompatible: ignoring", d)
        return None
    try:
        per_dev = []
        for dev in range(num_devices):
            with np.load(d / f"shard-{dev}.npz") as z:
                per_dev.append({k: z[k] for k in z.files})

        def stacked(key):
            return np.stack([p[key] for p in per_dev])

        slabs = tuple(stacked(f"bucket{i}") for i in range(manifest["num_buckets"]))
        heavy = (tuple(stacked(k) for k in ("heavy_c", "heavy_nb", "heavy_ip"))
                 if manifest["heavy"] else None)
        with np.load(d / "replicated.npz") as z:
            inv_perm, has_neighbors = z["inv_perm"], z["has_neighbors"]
    except _READ_ERRORS as e:
        log.warning("slab plan checkpoint at %s unreadable (%s): ignoring", d, e)
        return None
    if (inv_perm.shape != (n,) or has_neighbors.shape != (n,)
            or any(s.ndim != 3 for s in slabs) or not _still(d, ident)):
        log.warning("slab plan checkpoint at %s changed or malformed: ignoring", d)
        return None
    log.info("slab plan checkpoint loaded: %s", d)
    return DistSlabPlan(slabs, heavy, inv_perm, has_neighbors)


def cached_plan(sg, attr: str, kind: str, build, buckets=None):
    """Memo, then checkpoint, then build, for a DistSlabPlan: the plan kept
    on the ShardedGraph under ``attr``; else the one saved under
    ``sg.ckpt`` (when set); else ``build()``, saved for the next run when
    ``sg.ckpt`` is set."""
    plan = getattr(sg, attr, None)
    if plan is None:
        ck = getattr(sg, "ckpt", None)
        if ck is not None:
            plan = load_plan(*ck, kind=kind, num_devices=sg.num_devices, n=sg.n,
                             buckets=buckets)
        if plan is None:
            plan = build()
            if ck is not None:
                save_plan(plan, *ck, num_devices=sg.num_devices, n=sg.n, kind=kind,
                          buckets=buckets)
        setattr(sg, attr, plan)
    return plan
