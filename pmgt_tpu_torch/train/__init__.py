"""Training utilities: optimizer and learning-rate schedules."""
