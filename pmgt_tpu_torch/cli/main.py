"""Command line of the port (counterpart of ``pmgt_tpu/cli/main.py``),
built on ``argparse``:

    python -m pmgt_tpu_torch.cli.main [--device cuda|cpu] [--save-args F] \\
        {train-pmgt,train-ncf,train-dcn,train-pmgt-ncf,runs,hp-tuning,
         make-synthetic,preprocess,scrape-images} ...

(or the ``pmgt-tpu-torch`` console script). The four training commands
take every option of the JAX package's commands, with the same names and
defaults, and ``--save-args`` writes the same JSON. ``--num-devices N``
runs the command data-parallel in N processes, one card each (``core/
mesh.launch``; unset: every visible card, one on the CPU); the multi-host
trio ``--coordinator-address`` / ``--num-processes`` / ``--process-id``
(or the JAX environment trio) joins this host's ranks to a group across
hosts: NCCL joins ranks on cards, gloo ranks on the CPU.
``--shard-feat-tables`` / ``--shard-graph-tables`` row-shard the tables
over the ranks. ``--profile-dir`` writes
a ``torch.profiler`` trace of the training (``--mode train`` only, as the
JAX command traces only the training); ``--scan-epoch`` has no counterpart (the engine runs one epoch at a
time) and is only recorded. ``--device`` belongs to the command group and
stays out of the saved arguments. ``train_model`` is the workload
dispatcher: it finalizes the status (FINISHED or FAILED) only of a run
this invocation created or trained; ``--mode eval`` or ``inference``
against an existing run leaves that run's status as it was.
``hp-tuning`` (``cli/hpo.py``) runs each trial through ``train_model``,
data-parallel over the train config's ``num_devices`` ranks (resolved as
here), one launch for the whole study; the data commands are in
``cli/data_cmds.py``.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

from pmgt_tpu_torch.core import mesh as dist_mesh
from pmgt_tpu_torch.core.config import TrainArgs
from pmgt_tpu_torch.train.checkpoints import read_best_info
from pmgt_tpu_torch.train.registry import RunRegistry

logger = logging.getLogger("pmgt_tpu_torch")

SCHEDULER_TYPES = ("linear", "cosine", "cosine_with_restarts", "polynomial",
                   "constant", "constant_with_warmup")
# The multi-host bring-up options: not TrainArgs fields (as in the JAX
# package, which consumes them before the run).
MULTI_HOST = ("coordinator_address", "num_processes", "process_id")

_COMMON_KEYS = {
    "seed", "run_id", "model_name", "dataset_name", "valid_size",
    "num_epochs", "optim", "lr", "decay", "mp_enabled", "early",
    "early_criterion", "train_batch_size", "test_batch_size",
    "gradient_max_norm", "accumulation_step", "scheduler_warmup",
    "scheduler_type", "mode", "inference_result_path", "experiment_name",
    "run_name", "tags", "data_dir", "log_dir", "run_script", "num_devices",
    "profile_dir", "eval_interval", "ckpt_interval",
}


def log_elapsed_time(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        logger.info("elapsed time of %s: %.1fs", func.__name__, time.time() - start)
        return result

    return wrapper


def _unit_float(text: str) -> float:
    value = float(text)
    if not 0.0 <= value <= 1.0:
        raise argparse.ArgumentTypeError(f"{value} is not in [0, 1]")
    return value


def _existing_path(text: str) -> str:
    if not os.path.exists(text):
        raise argparse.ArgumentTypeError(f"path {text!r} does not exist")
    return text


def _add_common_options(p: argparse.ArgumentParser) -> None:
    """The JAX package's common training options, same names and
    defaults."""
    a = p.add_argument
    a("--seed", type=int, default=0, help="seed for reproducibility")
    a("--run-id", default=None, help="run id to resume, evaluate or export")
    a("--model-name", required=True)
    a("--dataset-name", required=True)
    a("--valid-size", type=float, default=0.2, help="validation dataset size")
    a("--num-epochs", type=int, default=20)
    a("--optim", choices=("adamw", "sgd"), default="adamw")
    a("--lr", type=float, default=1e-3)
    a("--decay", type=float, default=1e-2, help="weight decay")
    a("--mp-enabled", action="store_true",
      help="bf16 compute policy with f32 parameters (PMGT, PMGT_NCF; NCF and "
      "DCN accept it and change nothing, as the JAX package)")
    a("--early", type=int, default=5, help="early stopping patience")
    a("--early-criterion", default="loss")
    a("--num-workers", type=int, default=0, help="unused (kept for config compatibility)")
    a("--train-batch-size", type=int, default=256)
    a("--test-batch-size", type=int, default=256)
    a("--gradient-max-norm", type=float, default=None)
    a("--accumulation-step", type=int, default=1)
    a("--scheduler-warmup", type=_unit_float, default=None)
    a("--scheduler-type", choices=SCHEDULER_TYPES, default=None)
    a("--mode", choices=("train", "eval", "inference"), default="train")
    a("--inference-result-path", default=None)
    a("--experiment-name", default="baseline")
    a("--run-name", default=None)
    a("--tags", nargs=2, action="append", default=None, metavar=("KEY", "VALUE"))
    a("--data-dir", default="./data")
    a("--log-dir", default="./logs")
    a("--run-script", type=_existing_path, default=None)
    a("--num-devices", type=int, default=None,
      help="data-parallel ranks, one process and one card each (default: every "
      "visible card; one on the CPU)")
    a("--coordinator-address", default=None,
      help="multi-host: host:port of process 0 (or JAX_COORDINATOR_ADDRESS)")
    a("--num-processes", type=int, default=None,
      help="multi-host: number of hosts (or JAX_NUM_PROCESSES)")
    a("--process-id", type=int, default=None,
      help="multi-host: this host's index (or JAX_PROCESS_ID)")
    a("--profile-dir", default=None,
      help="write a torch.profiler trace of the training to this directory")
    a("--swa-start", type=int, default=None,
      help="enable Stochastic Weight Averaging from this epoch")
    a("--eval-init", action="store_true",
      help="evaluate the initial parameters as a best-checkpoint candidate "
      "before any training")
    a("--eval-interval", type=int, default=1,
      help="evaluate/checkpoint/early-stop every k epochs (patience counts "
      "evaluation points)")
    a("--ckpt-interval", type=int, default=1,
      help="save the resumable 'last' checkpoint every k evaluation points "
      "(always on stop/preemption; 'best' is unaffected)")


def _add_train_pmgt(sub) -> None:
    p = sub.add_parser("train-pmgt", help="pre-train PMGT",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_common_options(p)
    a = p.add_argument
    a("--max-ctx-neigh", type=int, default=5)
    a("--hop-sampling-sizes", type=int, action="append", default=None,
      help="repeat per hop (default 16 8 4)")
    a("--max-total-samples", type=int, default=10)
    a("--min-neg-samples", type=int, default=5)
    a("--hidden-size", type=int, default=128)
    a("--intermediate-size", type=int, default=128)
    a("--num-hidden-layers", type=int, default=5)
    a("--num-attention-heads", type=int, default=1)
    a("--beta", type=float, default=0.5)
    a("--random-node-ratio", type=float, default=0.2 * 0.1)
    a("--mask-node-ratio", type=float, default=0.2 * 0.8)
    a("--attention-impl", choices=("xla", "pallas"), default=None,
      help="dual attention: 'pallas' the hand-written kernels (default), "
      "'xla' the plain PyTorch formulation")
    a("--position-embedding-type", default="absolute",
      choices=("absolute", "relative_key", "relative_key_query"))
    a("--gradient-checkpointing", action="store_true",
      help="recompute each encoder layer in the backward")
    a("--ctx-cache", action=argparse.BooleanOptionalAction, default=True,
      help="per-epoch context cache (off = per-step sampling)")
    a("--scan-epoch", action=argparse.BooleanOptionalAction, default=True,
      help="no counterpart: the engine runs one epoch at a time and "
      "fetches its losses once (recorded for config compatibility)")
    a("--shard-feat-tables", action="store_true",
      help="row-shard the frozen feature tables over the ranks")
    a("--shard-graph-tables", action="store_true",
      help="row-shard the per-node graph tables over the ranks")
    a("--fusion-strategy", choices=("auto", "project_tables", "gather_rows"),
      default="auto")
    a("--feat-tables-dtype", choices=("float32", "bfloat16", "int8"),
      default=None,
      help="feature table storage (default: bfloat16 with --mp-enabled, else float32)")
    p.set_defaults(handler=functools.partial(_train, "pmgt"))


def _add_downstream_common(p: argparse.ArgumentParser) -> None:
    a = p.add_argument
    a("--emb-dropout", type=float, default=0.0)
    a("--dropout", type=float, default=0.0)


def _add_item_init_emb(p: argparse.ArgumentParser) -> None:
    a = p.add_argument
    a("--item-init-emb-path", type=_existing_path, default=None,
      help="PMGT node embeddings (.npy) for the item table")
    a("--freeze-item-init-emb", action="store_true")
    a("--normalize-item-init-emb", action="store_true")
    a("--topk", type=int, default=100,
      help="inference mode: items per user in the serving export")


_TIEBREAK_HELP = ("score eval candidates positives-first with low-index tie-break, "
                  "exactly like the reference (optimistic on tied scores; for "
                  "published-number comparisons only)")


def _add_train_ncf(sub) -> None:
    p = sub.add_parser("train-ncf", help="train NCF (GMF / MLP / NeuMF-end / NeuMF-pre)",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_common_options(p)
    _add_downstream_common(p)
    a = p.add_argument
    a("--layer-norm-eps", type=float, default=1e-12)
    a("--use-layer-norm", action="store_true")
    a("--alpha", type=float, default=0.5, help="GMF/MLP blend for NeuMF-pre")
    a("--factor-num", type=int, default=32)
    a("--num-layers", type=int, default=3)
    a("--num-ng", type=int, default=1)
    a("--max-sample-items", type=int, default=1000)
    a("--gmf-run-id", default=None)
    a("--mlp-run-id", default=None)
    _add_item_init_emb(p)
    a("--reference-tiebreak", action="store_true", help=_TIEBREAK_HELP)
    p.set_defaults(handler=functools.partial(_train, "ncf"))


def _add_train_dcn(sub) -> None:
    p = sub.add_parser("train-dcn", help="train DCN",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_common_options(p)
    _add_downstream_common(p)
    a = p.add_argument
    a("--layer-norm-eps", type=float, default=1e-12)
    a("--use-layer-norm", action="store_true")
    a("--factor-num", type=int, default=32)
    a("--deep-net-num-layers", type=int, default=3)
    a("--cross-net-num-layers", type=int, default=3)
    a("--num-ng", type=int, default=1)
    a("--max-sample-items", type=int, default=5)
    _add_item_init_emb(p)
    p.set_defaults(handler=functools.partial(_train, "dcn"))


def _add_train_pmgt_ncf(sub) -> None:
    p = sub.add_parser("train-pmgt-ncf",
                       help="train PMGT_NCF (a PMGT item tower inside NCF)",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_common_options(p)
    _add_downstream_common(p)
    a = p.add_argument
    a("--factor-num", type=int, default=32)
    a("--num-layers", type=int, default=3)
    a("--num-ng", type=int, default=1)
    a("--max-sample-items", type=int, default=1000)
    a("--max-ctx-neigh", type=int, default=5)
    a("--hop-sampling-sizes", type=int, action="append", default=None,
      help="repeat per hop (default 16 8 4)")
    a("--hidden-size", type=int, default=128)
    a("--intermediate-size", type=int, default=128)
    a("--num-hidden-layers", type=int, default=5)
    a("--num-attention-heads", type=int, default=1)
    a("--beta", type=float, default=0.5)
    a("--attention-impl", choices=("xla", "pallas"), default=None,
      help="dual attention: 'pallas' the hand-written kernels (default), "
      "'xla' the plain PyTorch formulation")
    a("--fusion-strategy", choices=("auto", "project_tables", "gather_rows"),
      default="auto")
    a("--feat-tables-dtype", choices=("float32", "bfloat16", "int8"),
      default=None,
      help="feature table storage (default: bfloat16 with --mp-enabled, else float32)")
    a("--shard-feat-tables", action="store_true",
      help="row-shard the frozen feature tables over the ranks")
    a("--shard-graph-tables", action="store_true",
      help="row-shard the per-node graph tables over the ranks")
    a("--topk", type=int, default=100,
      help="inference mode: items per user in the serving export")
    a("--serve-user-batch", type=int, default=64,
      help="inference mode: users per serving tile")
    a("--serve-item-chunk", type=int, default=1024,
      help="inference mode: catalogue chunk per serving tile")
    a("--reference-tiebreak", action="store_true", help=_TIEBREAK_HELP)
    p.set_defaults(handler=functools.partial(_train, "pmgt_ncf"))


def _add_runs(sub) -> None:
    p = sub.add_parser("runs", help="browse the run registry")
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--experiment-name", default=None, help="restrict to one experiment")
    p.add_argument("--run-id", default=None,
                   help="show one run in detail (params, tags, latest metrics)")
    p.set_defaults(handler=_runs)


def build_parser() -> argparse.ArgumentParser:
    from pmgt_tpu_torch.cli import data_cmds, hpo

    parser = argparse.ArgumentParser(
        prog="pmgt-tpu-torch",
        description="PMGT on PyTorch/CUDA: pre-training, embedding export, "
        "the downstream recommenders (NCF, DCN, PMGT_NCF), hyperparameter "
        "tuning, preprocessing and the run registry",
    )
    parser.add_argument("--save-args", default=None,
                        help="save the resolved arguments to a JSON file and exit")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run ('cpu' runs the plain "
                        "PyTorch versions)")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train_pmgt(sub)
    _add_train_ncf(sub)
    _add_train_dcn(sub)
    _add_train_pmgt_ncf(sub)
    _add_runs(sub)
    hpo.add_hp_tuning(sub)
    data_cmds.add_make_synthetic(sub)
    data_cmds.add_preprocess(sub)
    data_cmds.add_scrape_images(sub)
    return parser


def _make_args(raw: Dict[str, Any]) -> TrainArgs:
    raw.pop("num_workers", None)
    for name in MULTI_HOST:
        raw.pop(name, None)
    if "hop_sampling_sizes" in raw:
        raw["hop_sampling_sizes"] = tuple(raw["hop_sampling_sizes"] or (16, 8, 4))
    base = {k: v for k, v in raw.items() if k in _COMMON_KEYS}
    extra = {k: v for k, v in raw.items() if k not in _COMMON_KEYS}
    base["tags"] = tuple(tuple(t) for t in base.get("tags") or ())
    return TrainArgs(**base, extra=extra)


def train_args(raw: Dict[str, Any]) -> TrainArgs:
    """The ``TrainArgs`` of a training command's options, or of an
    hp-tuning trial's train config with its suggestions (the multi-host
    trio is not a field)."""
    return _make_args(dict(raw))


def _train(train_name: str, ns: argparse.Namespace):
    raw = {k: v for k, v in vars(ns).items()
           if k not in ("save_args", "device", "command", "handler")}
    if ns.save_args:
        _make_args(raw).save(ns.save_args)
        logger.info("saved args to %s", ns.save_args)
        return None
    trio = dist_mesh.distributed_trio(*(raw.get(k) for k in MULTI_HOST))
    return run_training(train_name, train_args(raw), ns.device, trio)


def configure_logging() -> None:
    """INFO records to standard error (the command line's, and each
    spawned rank's)."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def visible_devices(device: str) -> int:
    """The ranks an unset ``num_devices`` takes: every visible card (at
    least one: without a card the run raises), one on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return 1
    return max(torch.cuda.device_count(), 1)


def _rank_main(train_name: str, args: TrainArgs, device: str):
    configure_logging()
    return train_model(train_name, args, device=device)


def run_training(train_name: str, args: TrainArgs, device: str = "cuda", trio=None):
    """``train_model`` on one device, or data-parallel: ``args.num_devices``
    ranks (unset: every visible card, one on the CPU), each a process of
    its own, or with ``trio`` = (coordinator, processes, process id) this
    host's share of a group across hosts. Returns rank 0's result (this
    host's first rank's, across hosts)."""
    n = args.num_devices
    visible = visible_devices(device)
    if trio is None:
        ranks = n if n is not None else visible
        if ranks == 1:
            return train_model(train_name, args, device=device)
        return dist_mesh.launch(_rank_main, ranks, (train_name, args, device), device=device)[0]
    coordinator, processes, process_id = trio
    if n is not None and n % processes:
        raise ValueError(f"--num-devices {n} is not a multiple of --num-processes {processes}")
    local = n // processes if n is not None else visible
    if local == 1:  # this process is the host's one rank
        dist_mesh.initialize_distributed(coordinator, processes, process_id, device=device)
        try:
            return train_model(train_name, args, device=device)
        finally:
            dist_mesh.stop()
    return dist_mesh.launch(_rank_main, local, (train_name, args, device), device=device,
                            coordinator_address=coordinator, num_processes=processes,
                            process_id=process_id)[0]


@log_elapsed_time
def train_model(
    train_name: str,
    args: TrainArgs,
    device: str = "cuda",
    is_hptuning: bool = False,
    trial=None,
    enable_trial_pruning: bool = False,
):
    """The workload contract's dispatch for ``train_name`` in {"pmgt",
    "ncf", "dcn", "pmgt_ncf"}: check, seed, data, model, run, then train /
    evaluate / export by ``args.mode``. Under hp-tuning (``is_hptuning``)
    ``test`` evaluates the validation split and labels it ``test/``; the
    task gets ``trial`` (for ``should_prune``) only with
    ``enable_trial_pruning``."""
    import importlib

    if train_name not in ("pmgt", "ncf", "dcn", "pmgt_ncf"):
        raise ValueError(f"unknown workload {train_name!r}")
    trainer = importlib.import_module(f"pmgt_tpu_torch.tasks.{train_name}_task")

    ctx: Dict[str, Any] = {"device": device}
    trainer.check_args(args)
    trainer.init_run(args)
    trainer.init_dataloader(args, ctx)
    trainer.init_model(args, ctx, trial=trial if enable_trial_pruning else None)

    registry = RunRegistry(args.log_dir)
    if args.run_id is not None:
        run = registry.get_run(args.run_id)
    else:
        run = registry.create_run(
            args.experiment_name,
            args.to_dict(),
            run_name=args.run_name,
            tags=dict(args.tags),
            run_script=args.run_script,
        )
        logger.info("run_id: %s", run.run_id)
    # This invocation finalizes the status only of a run it created or
    # trained: eval or inference against an existing --run-id must leave
    # that run's FINISHED/INTERRUPTED record as it was.
    owns_status = args.run_id is None or args.mode == "train"

    try:
        if args.mode == "inference":
            logger.info("Inference mode")
            out = trainer.inference(args, ctx, registry, run)
        else:
            if args.mode == "train" and args.profile_dir:
                _profiled(lambda: trainer.train(args, ctx, registry, run),
                          args.profile_dir, device)
            elif args.mode == "train":
                trainer.train(args, ctx, registry, run)
            else:
                logger.info("Eval mode")
            out = trainer.test(args, ctx, registry, run, is_hptuning=is_hptuning)
            logger.info("test results: %s", out)
    except Exception:
        if owns_status:
            registry.set_status(run, "FAILED")
        raise
    # A preempted fit marks the run INTERRUPTED; keep it so resume logic
    # keyed on it is not misled.
    if owns_status and run.status != "INTERRUPTED":
        registry.set_status(run, "FINISHED")
    return out


def _profiled(fn, profile_dir: str, device: str) -> None:
    """``fn()`` under ``torch.profiler`` (host, and the card on a CUDA
    device); the trace goes to ``profile_dir`` as a
    ``*.pt.trace.json`` file, also when ``fn`` raises. On a card, a
    session that ran ``fn`` to its end but recorded no device event
    raises instead of writing a trace without the card's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    on_card = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    write = tensorboard_trace_handler(profile_dir)
    finished = []

    def ready(prof):
        if finished and on_card and not any(
                e.device_type == DeviceType.CUDA for e in prof.events()):
            raise RuntimeError(
                f"torch.profiler recorded no device event in this session; no trace "
                f"written to {profile_dir}")
        write(prof)

    with profile(activities=activities, on_trace_ready=ready):
        fn()
        finished.append(True)
    logger.info("profiler trace written to %s", profile_dir)


def _runs(ns: argparse.Namespace) -> None:
    registry = RunRegistry(ns.log_dir)
    if ns.run_id:
        run = registry.get_run(ns.run_id)
        print(f"run {run.run_id}  experiment={run.experiment_name}  status={run.status}")
        tags_path = os.path.join(run.run_dir, "tags.json")
        if os.path.exists(tags_path):
            with open(tags_path, encoding="utf-8") as f:
                tags = json.load(f)
            print("tags: " + "  ".join(f"{k}={v}" for k, v in tags.items()))
        print("params:")
        for k, v in sorted(run.params.items()):
            print(f"  {k} = {v}")
        latest = {m["name"]: m for m in run.metrics()}
        if latest:
            print("latest metrics:")
            for name in sorted(latest):
                m = latest[name]
                print(f"  {name} = {m['value']:.6g}  (epoch {m['epoch']}, step {m['step']})")
        best = read_best_info(run.ckpt_dir)
        if best:
            print(f"best: {best.get('monitor')} = {best.get('value'):.6g}"
                  f" at epoch {best.get('epoch')}")
        return
    print(f"{'RUN_ID':34} {'EXPERIMENT':16} {'STATUS':12} {'MODEL':12} {'DATASET':10} BEST")
    for run in registry.list_runs(ns.experiment_name):
        params = run.params
        best = read_best_info(run.ckpt_dir)
        best_str = (f"{best.get('monitor')}={best.get('value'):.5g}@{best.get('epoch')}"
                    if best else "-")
        print(f"{run.run_id:34} {run.experiment_name:16} {run.status:12} "
              f"{str(params.get('model_name', '-')):12} "
              f"{str(params.get('dataset_name', '-')):10} {best_str}")


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default: ``sys.argv[1:]``) and run the command.
    Returns what the command returns: a training command's test metrics
    or its export (PMGT embeddings, a downstream model's top-k),
    hp-tuning's best trial, preprocess's artifacts, scrape-images' (done,
    failed) counts; None for the others."""
    configure_logging()
    ns = build_parser().parse_args(argv)
    return ns.handler(ns)


def entry() -> int:
    """The console script: exit status 0 when the command returns. Its
    last log line is the process's K1–K4 launches (all zero off the card),
    which tools that drive the CLI in subprocesses read."""
    from pmgt_tpu_torch.ops.dual_attention import launch_counts

    main()
    logger.info("kernel launches: %s", json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(entry())
