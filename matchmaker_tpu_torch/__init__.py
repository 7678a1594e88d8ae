"""PyTorch + CUDA port of matchmaker_tpu for NVIDIA Hopper (H100).

The JAX package ``matchmaker_tpu`` is the reference; this package follows its
layout and names. Device code is PyTorch, and every Pallas kernel on the
ported path is a hand-written CUDA kernel (``csrc/``, built at first use by
``ops/_build.py``). The port imports nothing of JAX, flax, optax or the JAX
package: it keeps its own copies of the host code it needs (readers,
tokenization, loaders, metrics, config, experiment, perf monitor, scalar
writer). PyYAML is imported only when a YAML file is read or written.
"""
