"""Configuration dataclasses (counterpart of ``pmgt_tpu/core/config.py``).

Same field names and defaults as the JAX package, so a run's parameters
mean the same thing in both. ``attention_impl`` keeps the reference's
value names: ``"pallas"`` selects the hand-written dual-attention kernel
route (``ops.dual_attention.dual_attention_sm``), ``"xla"`` the plain
batch-major PyTorch formulation (``models.pmgt.dual_attention_plain``).

``TrainArgs`` has the JAX package's fields, defaults and JSON form
(``to_dict`` / ``from_dict`` / ``save`` / ``load``), so a ``--save-args``
file written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


FUSION_AUTO_THRESHOLD = 50_000


def resolve_fusion_strategy(requested: Optional[str], num_nodes: int) -> str:
    """Resolve "auto" by node count: project the whole table then gather
    compact rows below FUSION_AUTO_THRESHOLD nodes, gather raw rows and
    project only those above it."""
    if requested in (None, "auto"):
        return (
            "gather_rows"
            if num_nodes > FUSION_AUTO_THRESHOLD
            else "project_tables"
        )
    if requested not in ("project_tables", "gather_rows"):
        raise ValueError(
            f"fusion_strategy must be auto|project_tables|gather_rows, "
            f"got {requested!r}"
        )
    return requested


@dataclass(frozen=True)
class PMGTConfig:
    """PMGT encoder hyperparameters."""

    hidden_size: int = 128
    feat_hidden_sizes: Tuple[int, ...] = (1536, 768)
    num_hidden_layers: int = 5
    num_attention_heads: int = 1
    intermediate_size: int = 128
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 100
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    beta: float = 0.5  # diversity-promoting attention blend weight
    # {"absolute", "relative_key", "relative_key_query"}
    position_embedding_type: str = "absolute"
    attention_impl: str = "xla"  # {"xla": plain torch, "pallas": kernel}
    dtype: str = "float32"  # compute dtype: {"float32", "bfloat16"}
    gradient_checkpointing: bool = False
    head_dim_override: Optional[int] = None
    # "project_tables" projects the whole frozen table and gathers
    # compact [N+2, H] rows; "gather_rows" gathers raw rows and projects
    # only those. Identical math (gather and projection commute).
    fusion_strategy: str = "project_tables"

    def __post_init__(self):
        object.__setattr__(
            self, "feat_hidden_sizes", _freeze(self.feat_hidden_sizes)
        )
        if (
            self.head_dim_override is None
            and self.hidden_size % self.num_attention_heads != 0
        ):
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be a multiple of "
                f"num_attention_heads ({self.num_attention_heads})"
            )
        if self.fusion_strategy not in ("project_tables", "gather_rows"):
            raise ValueError(
                "PMGTConfig.fusion_strategy must be 'project_tables' or "
                f"'gather_rows', got {self.fusion_strategy!r} (resolve "
                "'auto' via resolve_fusion_strategy first)"
            )

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def all_head_size(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def num_feats(self) -> int:
        return len(self.feat_hidden_sizes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PMGTConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _freeze(v) for k, v in d.items() if k in known})


@dataclass(frozen=True)
class SamplingConfig:
    """Contextual-neighborhood / pair sampling hyperparameters."""

    max_ctx_neigh: int = 5
    hop_sampling_sizes: Tuple[int, ...] = (16, 8, 4)
    max_total_samples: int = 10  # pos + neg pairs per target (training)
    min_neg_samples: int = 5
    # True graph row count (N + special rows); None = derive from shape.
    num_total: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "hop_sampling_sizes", _freeze(self.hop_sampling_sizes)
        )

    @property
    def seq_len(self) -> int:
        return 1 + self.max_ctx_neigh

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SamplingConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _freeze(v) for k, v in d.items() if k in known})


@dataclass
class TrainArgs:
    """Common training arguments, field for field the JAX package's (its
    device-mesh fields kept so saved arguments round-trip). ``extra`` holds
    the workload-specific flags (hidden_size, hop_sampling_sizes, ...),
    readable as attributes."""

    # --- train options -------------------------------------------------
    seed: int = 0
    run_id: Optional[str] = None
    model_name: str = ""
    dataset_name: str = ""
    valid_size: float = 0.2
    num_epochs: int = 20
    optim: str = "adamw"  # {"adamw", "sgd"}
    lr: float = 1e-3
    decay: float = 1e-2
    mp_enabled: bool = False  # bf16 compute policy
    early: int = 5
    early_criterion: str = "loss"
    train_batch_size: int = 256
    test_batch_size: int = 256
    gradient_max_norm: Optional[float] = None
    accumulation_step: int = 1
    scheduler_warmup: Optional[float] = None
    scheduler_type: Optional[str] = None
    mode: str = "train"  # {"train", "eval", "inference"}
    inference_result_path: Optional[str] = None

    # --- log options ---------------------------------------------------
    experiment_name: str = "baseline"
    run_name: Optional[str] = None
    tags: Tuple[Tuple[str, str], ...] = ()
    data_dir: str = "./data"
    log_dir: str = "./logs"
    run_script: Optional[str] = None

    # --- device options ------------------------------------------------
    num_devices: Optional[int] = None  # data-parallel ranks; None = every visible card
    mesh_shape: Optional[Tuple[int, ...]] = None
    profile_dir: Optional[str] = None
    # Evaluate/checkpoint/early-stop every k epochs.
    eval_interval: int = 1
    # Save the resumable `last` checkpoint every k evaluation points
    # (always on stop/preemption; `best` is unaffected).
    ckpt_interval: int = 1

    # --- workload-specific extras (populated by each CLI command) -------
    extra: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        extra = self.__dict__.get("extra")
        if extra is not None and name in extra:
            return extra[name]
        raise AttributeError(name)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items() if k != "extra"}
        d.update(self.extra)
        d["tags"] = [list(t) for t in self.tags]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainArgs":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "extra"}
        base = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        if "tags" in base:
            base["tags"] = tuple(tuple(t) for t in base["tags"])
        if base.get("mesh_shape") is not None:
            base["mesh_shape"] = tuple(base["mesh_shape"])
        return cls(**base, extra=extra)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "TrainArgs":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))
