"""Multi-rank execution (counterpart of graphtpu/parallel/): rank groups
over torch.distributed (``mesh.py``), row-partitioned graphs
(``partition.py``), multi-host launch (``multihost.py``), the routing from
``run_algorithm`` (``dispatch.py``) and the distributed loops: the naive
ones and the wrappers (``algorithms.py``), and the JAX package's defaults,
the slab CDLP and PageRank (``slab_cdlp.py``, ``slab_pr.py``), the
adaptive BFS, SSSP and WCC (``adaptive_bfs.py``, ``adaptive_sssp.py``,
``adaptive_wcc.py``) and the oriented-wedge LCC (``wedge_lcc.py``).
``checkpoint.py`` memoizes the host plans and, under ``shard-checkpoints``,
saves the partitions and slab plans of a named graph to disk in the JAX
package's files and restores them on a later run.
"""
