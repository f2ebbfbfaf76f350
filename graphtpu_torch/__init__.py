"""graphtpu_torch — the PyTorch / CUDA port of graphtpu for one NVIDIA H100.

A second package beside ``graphtpu`` (the JAX reference, which it is held
against). It covers all six LDBC Graphalytics algorithms on one device:
PageRank (slab and scan arms), CDLP (adaptive, slab, sort), BFS, WCC and
SSSP (adaptive, device, hybrid; SSSP also delta-stepping) and LCC
(oriented wedges, sweep), each through ``algorithms/common.py:run_algorithm``.
Around them: the ingest (``.v/.e`` text through the native C++ parser or
numpy, the device edge sort, the binary cache, ``.grb``/``.vtb``,
MatrixMarket, dataset download), the host ``Graph``, the Graphalytics
harness (platform lifecycle, suite with killable subprocess jobs,
collector, validator) and ``python -m graphtpu_torch.cli
load|run|validate|benchmark|download|devices``, and the GraphBLAS surface
(``core/spops.py``, ``core/spgemm.py``). ``python -m graphtpu_torch.bench``
is the benchmark entry point (one JSON line, ``utils/sections.py`` and
``utils/roofline.py`` under it; ``--scaling`` prints the distributed
scaling table). ``parallel/`` holds the distributed layer that
``num-devices`` above 1 routes to: rank groups over torch.distributed, row
partitions and the sharded checkpoints that persist them and the slab
plans (``shard-checkpoints``), multi-host launch, the naive distributed
loops and the JAX package's default ones (slab, adaptive, wedge).

Its module tree mirrors ``graphtpu/``, module for module. It
imports torch and numpy, never jax, graphtpu or pandas. Every tensor lives
on the device named by ``PlatformConfig.device``. The hand-written kernels,
CUDA C++ for sm_90a under ``csrc/``, built at first use
(``ops/kernels.py``), are K1 gather_rows, K2 slab_minmode, K3
slab_spmv_sum, K4 vreg_shuffle, K5 frontier_expand, K6 slab_spmv_min, K7
csr_pull_reduce, K8 push_relax_min, K9 edgehash_probe, K10 wedge_rowblock,
K11 masked_spgemm, K12 segment_minmode, K13 bfs_trunc_probe, K14
frontier_compact, K15 lcc_sweep_member, K16 lcc_head_credits, K17
bfs_residual_claim, K18 frontier_starts, K19 cdlp_tier_apply, K20
cdlp_route, K21 wcc_jump, K22 sssp_apply and K23 bfs_apply; each wrapper
takes its plain PyTorch version for a CPU tensor. On a card the adaptive
loops of CDLP, WCC, SSSP and BFS, and BFS's dense loop, each run as one CUDA
graph with conditional nodes (``ops/device_loop.py``).
"""

__version__ = "0.1.0"
