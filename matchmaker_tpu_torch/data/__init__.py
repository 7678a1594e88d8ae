"""Host data path of the port: readers, batching, tokenizers, loaders and a
device prefetch for torch tensors (copies of the JAX package's host code)."""
