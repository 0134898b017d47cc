"""PyTorch / CUDA port of the SWARM-LLM reproduction.

Mirrors the layout of the JAX package ``repro`` module by module; imports
``torch`` and never ``jax`` or ``repro``.  Hand-written CUDA kernels for
Hopper live in ``csrc/`` and are bound in ``kernels/``.
"""
