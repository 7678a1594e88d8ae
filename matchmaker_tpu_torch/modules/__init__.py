"""Shared modules of the port: counterpart of ``matchmaker_tpu/modules``
(the MLM pre-training head, the pooling utilities and the small transformer
of PARADE's aggregator; the embedder is queued in ROADMAP.md)."""
