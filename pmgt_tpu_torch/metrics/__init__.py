from pmgt_tpu_torch.metrics.ranking import (  # noqa: F401
    get_ndcg,
    get_recall,
    roc_auc,
    stable_sigmoid,
)
