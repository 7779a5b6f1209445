"""PyTorch + CUDA port of the Rainbow hybrid-memory reproduction.

The JAX package ``repro`` is the reference; this package re-implements its
main path -- ``sim.runner.simulate(app, "rainbow")`` -- on PyTorch tensors,
with the interval's per-access TLB walk and the fused observe counter as
hand-written CUDA kernels (``csrc/``).  It imports neither ``jax`` nor
``repro``.  Entry points run on the GPU unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch version.
"""
