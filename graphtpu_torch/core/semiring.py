"""Semiring algebra for the slab SpMV (counterpart of graphtpu/core/semiring.py).

A semiring is an (additive monoid, multiply) pair. ``mul(edge_val, x_src)``
makes the per-edge term and the monoid reduces the terms of a row; the
identity fills rows without edges. ``ops/spmv.py:slab_spmv`` takes them;
plus.second (PageRank's pull) runs on the hand-written kernel K3.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative associative reduction with identity."""

    name: str
    identity: Callable[[torch.dtype], Any]  # dtype -> identity scalar


def _ident_zero(dtype):
    return 0


def _ident_max(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _ident_min(dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


PLUS = Monoid("plus", _ident_zero)
MIN = Monoid("min", _ident_max)
MAX = Monoid("max", _ident_min)
# logical OR over {0,1} masks is max
LOR = Monoid("lor", _ident_zero)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """add.mul semiring. `mul(edge_val, x_src)` produces the per-edge term."""

    name: str
    add: Monoid
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _second(e, x):
    return x


def _first(e, x):
    return e


def _plus(e, x):
    return e + x


def _times(e, x):
    return e * x


def _pair(e, x):
    """1 for every structurally present operand (triangle counting)."""
    return torch.ones_like(x)


MIN_SECOND = Semiring("min.second", MIN, _second)    # CDLP label propagation
MIN_PLUS = Semiring("min.plus", MIN, _plus)          # SSSP relaxation
PLUS_SECOND = Semiring("plus.second", PLUS, _second)  # PageRank pull
PLUS_TIMES = Semiring("plus.times", PLUS, _times)    # classic SpMV / counting
LOR_LAND = Semiring("lor.land", LOR, _times)         # BFS reachability on {0,1}
MIN_FIRST = Semiring("min.first", MIN, _first)
MAX_SECOND = Semiring("max.second", MAX, _second)
# deterministic ANY: the smallest matching index wins (BFS parents); callers
# pass the index array as x
ANY_SECONDI = Semiring("any.secondi", MIN, _second)
PLUS_PAIR = Semiring("plus.pair", PLUS, _pair)

BY_NAME = {
    s.name: s
    for s in [
        MIN_SECOND, MIN_PLUS, PLUS_SECOND, PLUS_TIMES, LOR_LAND,
        MIN_FIRST, MAX_SECOND, ANY_SECONDI, PLUS_PAIR,
    ]
}
