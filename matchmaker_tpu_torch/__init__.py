"""PyTorch + CUDA port of matchmaker_tpu for NVIDIA Hopper (H100).

The JAX package ``matchmaker_tpu`` is the reference; this package follows its
layout and names. Device code is PyTorch, and every Pallas kernel on the
ported path is a hand-written CUDA kernel (``csrc/``, built at first use by
``ops/_build.py``). The port imports no JAX and no flax; it reuses the JAX
package's jax-free host modules (tokenization, loaders, metrics, perf
monitor).
"""
