"""Shared modules of the port: counterpart of ``matchmaker_tpu/modules``
(the MLM pre-training head; the rest is queued in ROADMAP.md)."""
