from pmgt_tpu_torch.tasks.dcn_task import DCNTask  # noqa: F401
from pmgt_tpu_torch.tasks.ncf_task import NCFTask  # noqa: F401
from pmgt_tpu_torch.tasks.pmgt_ncf_task import PMGTNCFTask  # noqa: F401
from pmgt_tpu_torch.tasks.pmgt_task import PMGTTask  # noqa: F401
