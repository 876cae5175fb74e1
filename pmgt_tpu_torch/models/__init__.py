from pmgt_tpu_torch.models.dcn import DCN  # noqa: F401
from pmgt_tpu_torch.models.interop import (  # noqa: F401
    dcn_params_from_flax,
    ncf_params_from_flax,
    params_from_flax,
    pmgt_ncf_params_from_flax,
)
from pmgt_tpu_torch.models.ncf import NCF, fuse_neumf_params, inject_item_embeddings  # noqa: F401
from pmgt_tpu_torch.models.pmgt import (  # noqa: F401
    PMGTForPreTraining,
    PMGTModel,
    gsr_loss_fn,
)
from pmgt_tpu_torch.models.pmgt_ncf import PMGT_NCF  # noqa: F401
from pmgt_tpu_torch.models.pruning import prune_attention_heads  # noqa: F401
