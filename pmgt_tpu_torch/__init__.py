"""PyTorch/CUDA port of PMGT pre-training and serving for NVIDIA Hopper
(H100).

A second package beside the JAX reference ``pmgt_tpu``; it mirrors that
package's layout (``core``, ``graph``, ``data``, ``sampling``, ``ops``,
``models``, ``metrics``, ``tasks``, ``train``, ``cli``) so each
counterpart is easy to find, but imports only ``torch`` and ``numpy`` —
never JAX and never a module of ``pmgt_tpu``.

It covers PMGT pre-training end to end: the ``train-pmgt`` command
(``cli/main.py``: train, evaluate, export; early stopping, best/last
checkpoints, resume) over ``PMGTTask`` (training steps with GSR + NFR,
dropout and AdamW; validation pair-AUC; per-node CLS embedding export);
the downstream recommenders that consume that export, ``train-ncf``
(GMF / MLP / NeuMF-end / NeuMF-pre, with PMGT item embeddings),
``train-dcn`` and ``train-pmgt-ncf`` (a PMGT item tower inside NCF), with
ranking evaluation and full-catalogue top-k serving; and the public
batch-major op ``ops.dual_attention_pallas``; every option of the
published training scripts runs (the bf16 compute policy ``--mp-enabled``,
bf16/int8 feature tables, per-step sampling, gradient checkpointing,
relative positions), data-parallel over several cards
(``core/mesh.py``), and so do ``hp-tuning`` (data-parallel trials),
``preprocess`` (with the feature extractors) and ``scrape-images``. The
dual attention runs as
two hand-written CUDA kernels, the forward
(``ops/csrc/dual_attention_fwd.cu``) and the backward
(``ops/csrc/dual_attention_bwd.cu``), each in the seq-major and the
batch-major layout, built with ``nvcc`` at first use.

Entry points run on ``device="cuda"`` by default and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

__version__ = "0.1.0"

from pmgt_tpu_torch.core.config import PMGTConfig  # noqa: F401
