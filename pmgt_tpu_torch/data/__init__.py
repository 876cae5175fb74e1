from pmgt_tpu_torch.data.artifacts import (  # noqa: F401
    DatasetArtifacts,
    load_artifacts,
    load_node_init_emb,
    save_native,
)
from pmgt_tpu_torch.data.interactions import InteractionData  # noqa: F401
