"""Plan memo of the distributed loops (counterpart of
graphtpu/parallel/checkpoint.py, its ``cached_plan`` memo branch only).

The JAX module also saves the sharded partitions and slab plans to disk
and restores them on a later run (the ``shard-checkpoints`` key); that part
is ROADMAP sub-slice 2e, and the port reads the key and ignores it with a
warning until then.
"""

from __future__ import annotations


def cached_plan(sg, attr: str, build):
    """The host plan kept on the ShardedGraph under ``attr``; ``build()``
    makes it on the first call."""
    plan = getattr(sg, attr, None)
    if plan is None:
        plan = build()
        setattr(sg, attr, plan)
    return plan
