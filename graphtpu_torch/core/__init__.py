"""graphtpu_torch.core — counterpart of graphtpu.core."""

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core import semiring
from graphtpu_torch.core import spops

__all__ = ["Graph", "semiring", "spops"]
