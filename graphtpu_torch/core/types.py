"""Shared constants and dtype policy (counterpart of graphtpu/core/types.py).

Vertex ids are int32 on the device (|V| < 2^31 for every Graphalytics
dataset); 64-bit original ids stay on the host, in ``Graph.mapping``.
"""

from __future__ import annotations

import numpy as np

# Printed for unreachable vertices in BFS output — int64 max, matching the
# reference serializer (bfs.cpp:61).
UNREACHABLE = np.iinfo(np.int64).max

# Host-side dense-id dtype (int32 on the device too).
INDEX_DTYPE = np.int32

# Host-side original-id dtype (sparse uint64 ids in .v files; int64 holds
# every published Graphalytics dataset's ids).
ORIGINAL_ID_DTYPE = np.int64

# Sentinel for "no value" in int32 device computations.
INT32_INF = np.iinfo(np.int32).max
