"""Training runtime of the port: counterpart of ``matchmaker_tpu/training``."""
