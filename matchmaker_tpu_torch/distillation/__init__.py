"""Knowledge distillation of the port: counterpart of
``matchmaker_tpu/distillation`` (the dynamic teacher and the static score
files' utilities)."""
