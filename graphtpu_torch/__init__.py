"""graphtpu_torch — the PyTorch / CUDA port of graphtpu for one NVIDIA H100.

A second package beside ``graphtpu`` (the JAX reference, which it is held
against). This slice covers single-device PageRank and CDLP on the
degree-bucketed slab path: ``.v/.e`` ingest, the host ``Graph``, the slab
plan, the iterated kernels, the serializer and the golden validator,
through the platform lifecycle (``harness/platform.py``) and
``python -m graphtpu_torch.cli run``.

Its module tree mirrors ``graphtpu/``. It imports torch and numpy, never
jax, graphtpu or pandas. Every tensor lives on the device named by
``PlatformConfig.device``. The hand-written kernels (K1 gather_rows, K2
slab_minmode, K3 slab_spmv_sum) are CUDA C++ for sm_90a under ``csrc/``,
built at first use (``ops/kernels.py``).
"""

__version__ = "0.1.0"
