"""repro_torch: the MGG system ported to PyTorch and hand-written CUDA
kernels for one NVIDIA H100, beside the JAX package ``repro`` (the
reference).  Imports ``torch`` and numpy, never JAX or ``repro``.

Layout mirrors ``repro``: core (planning, the differentiable ring, the
four GNNs), kernels (CUDA gather-sum, its backward and the row gather,
with plain versions), dist (the virtual ring), obs, serve, train (AdamW,
checkpoints), sample (fanout-bounded blocks), store (tiered features),
launch.
"""
__version__ = "0.1.0"
