"""Timers and checkpoints (port of `ovr_tpu.utils`)."""
