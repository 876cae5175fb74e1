"""Training: optimizer and schedules, the engine (``fit``), checkpoints and
the run registry."""
