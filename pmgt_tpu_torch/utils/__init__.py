"""Training utilities (counterpart of ``pmgt_tpu/utils``)."""
from pmgt_tpu_torch.utils.base import set_seed  # noqa: F401
