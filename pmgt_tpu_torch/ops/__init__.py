from pmgt_tpu_torch.ops.dual_attention import (  # noqa: F401
    dual_attention_pallas,
    dual_attention_sm,
    dual_attention_sm_reference,
)
