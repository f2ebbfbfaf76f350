"""Sparse linear-algebra primitives over COO edge streams (counterpart of
graphtpu/core/spops.py): the GraphBLAS-named vector operations.

A semiring SpMV is a gather of x at the edge sources (kernel K1 on the
card, ``ops/gather.py``), the semiring's multiply, and one segment
reduction keyed by the edge destinations. The reduction is a
``scatter_reduce`` into an output filled with what ``jax.ops.segment_*``
gives an empty segment, so that empty segments come out as in the JAX
package. ``degrees`` drops keys outside [0, num_segments), as
``jax.ops.segment_sum`` does; ``segment_reduce``, ``spmv``, ``assign`` and
``extract`` (on the CPU; K1 reads 0 for it on the card) raise on such an
index where JAX drops the update or does not raise.
"""

from __future__ import annotations

import torch

from graphtpu_torch.core.semiring import MAX, Monoid, Semiring
from graphtpu_torch.ops.gather import table_gather

# monoid -> (scatter_reduce op, the monoid whose identity fills an empty
# segment). LOR reduces by max and, as jax.ops.segment_max does, leaves an
# empty segment at max's identity (the dtype's lowest), not at its own 0
_SEGMENT = {"plus": ("sum", None), "min": ("amin", None), "max": ("amax", None),
            "lor": ("amax", MAX)}


def segment_reduce(monoid: Monoid, values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, indices_are_sorted: bool = True) -> torch.Tensor:
    """Reduce ``values`` by ``segment_ids`` under ``monoid``. Sorted ids are
    not needed; the flag is kept for the JAX package's signature. An id
    outside [0, num_segments) raises (``jax.ops.segment_*`` drops it)."""
    op, fill_monoid = _SEGMENT[monoid.name]
    fill = (fill_monoid or monoid).identity(values.dtype)
    out = torch.full((num_segments,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, segment_ids.long(), values, reduce=op, include_self=True)


def spmv(semiring: Semiring, edges_src: torch.Tensor, edges_dst: torch.Tensor,
         edges_w: torch.Tensor, x: torch.Tensor, num_segments: int, *,
         sorted_by_dst: bool = True) -> torch.Tensor:
    """y[v] = (+)_{(u,v) in E} (w_uv (x) x[u]): the pull product for edges
    sorted by destination; swap src and dst for the out-neighbour product."""
    terms = semiring.mul(edges_w, table_gather(x, edges_src.to(torch.int32)))
    return segment_reduce(semiring.add, terms, edges_dst, num_segments,
                          indices_are_sorted=sorted_by_dst)


def masked_fill(updated: torch.Tensor, mask: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """GraphBLAS masked assign: ``updated`` where mask, else ``old``."""
    return torch.where(mask, updated, old)


def assign(vec: torch.Tensor, idx: torch.Tensor, vals, mask: torch.Tensor = None) -> torch.Tensor:
    """GrB_Vector_assign: a copy of ``vec`` with vec[idx] = vals (under a
    mask aligned with idx, if given). ``vals`` is a scalar or a tensor
    matching idx. An index outside [0, len(vec)) raises (JAX drops that
    update); a negative one counts from the end, as torch indexing does."""
    idx = idx.long()
    vals = torch.as_tensor(vals, dtype=vec.dtype, device=vec.device)
    if mask is not None:
        vals = torch.where(mask, vals, vec[idx])
    out = vec.clone()
    out[idx] = vals
    return out


def extract(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """GrB_Vector_extract: vec[idx] through the table gather (K1). An index
    outside [0, len(vec)) raises on the CPU and reads 0 on the card (K1),
    where the JAX package's gather does not raise."""
    return table_gather(vec, idx.to(torch.int32))


def reduce_vector(monoid: Monoid, vec: torch.Tensor) -> torch.Tensor:
    """GrB_Vector_reduce: fold the whole vector under a monoid (integer
    sums widen to int64, as jnp.sum's do)."""
    if monoid.name == "plus":
        return vec.sum()
    return vec.min() if monoid.name == "min" else vec.max()


def degrees(edges_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-vertex edge counts (sorted or unsorted keys), int32 [num_segments].
    Keys outside [0, num_segments) are dropped, as jax.ops.segment_sum drops
    them."""
    key = edges_key.long()
    key = key[(key >= 0) & (key < num_segments)]
    return torch.bincount(key, minlength=num_segments).to(torch.int32)


def pack_edge_keys_f64(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """(src, dst) packed into exactly representable float64 keys src * n +
    dst, valid while n^2 < 2^53 (every Graphalytics dataset)."""
    return src.to(torch.float64) * float(n) + dst.to(torch.float64)
