"""Command line of the port: ``train-pmgt``, ``runs``, ``make-synthetic``."""
