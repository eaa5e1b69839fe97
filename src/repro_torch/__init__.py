"""repro_torch: the MGG system ported to PyTorch and hand-written CUDA
kernels for one NVIDIA H100, beside the JAX package ``repro`` (the
reference).  Imports ``torch`` and numpy, never JAX or ``repro``.

Layout mirrors ``repro``: core (planning, ring, GCN), kernels (CUDA
gather-sum + plain versions), dist (the virtual ring), obs, serve, launch.
"""
__version__ = "0.1.0"
