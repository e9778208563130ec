"""PyTorch/CUDA port of the SLING SimRank index (``src/repro`` is the
JAX reference it is held against).

The subpackages mirror ``repro`` module for module: ``graph`` (CSR,
generators), ``core`` (plan, Alg-4 walks, Alg-2 HP build, index,
single-source, top-k), ``kernels`` (hand-written Hopper kernels with
their plain PyTorch versions), ``serve`` (``QueryEngine``) and
``launch`` (the serving CLI). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise.

This package imports neither ``jax`` nor ``repro``.
"""
