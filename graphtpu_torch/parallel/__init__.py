"""Multi-rank execution (counterpart of graphtpu/parallel/): rank groups
over torch.distributed (``mesh.py``), row-partitioned graphs
(``partition.py``), multi-host launch (``multihost.py``), the naive
distributed loops (``algorithms.py``) and the routing from
``run_algorithm`` (``dispatch.py``). The JAX package's slab, adaptive,
wedge and checkpoint modules are ROADMAP Queue 1 sub-slices 2b-2e.
"""
