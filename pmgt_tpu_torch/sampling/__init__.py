from pmgt_tpu_torch.sampling.mcn import (  # noqa: F401
    complement_rank_select,
    sample_context,
    sample_context_dense,
)
from pmgt_tpu_torch.sampling.pairs import (  # noqa: F401
    PretrainBatch,
    make_pretrain_batch,
    make_pretrain_batch_cached,
    sample_all_contexts,
    sample_all_pairs,
    sample_pairs,
)
