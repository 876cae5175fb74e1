"""Training utilities (counterpart of ``pmgt_tpu/utils``)."""
