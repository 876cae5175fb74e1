"""Command line of the port: ``train-pmgt``, ``train-ncf``, ``train-dcn``,
``train-pmgt-ncf``, ``runs``, ``make-synthetic``."""
