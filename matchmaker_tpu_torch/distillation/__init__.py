"""Knowledge distillation of the port: counterpart of
``matchmaker_tpu/distillation`` (the dynamic teacher; the score files are
queued in ROADMAP.md)."""
