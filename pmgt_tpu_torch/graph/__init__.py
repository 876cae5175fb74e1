from pmgt_tpu_torch.graph.container import (  # noqa: F401
    NUM_SPECIAL_NODES,
    DeviceGraph,
    PaddedGraph,
    from_edges,
    from_networkx,
)
