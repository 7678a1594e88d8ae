"""Observability of the port: counterpart of ``matchmaker_tpu/obs``."""
