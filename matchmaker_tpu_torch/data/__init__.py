"""Host data path of the port: the JAX package's jax-free tokenizers and
loaders, plus a device prefetch for torch tensors."""
