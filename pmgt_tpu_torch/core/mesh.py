"""Data parallelism over several cards, one process per card (counterpart
of ``pmgt_tpu/core/mesh.py``).

The JAX package runs one program over a 1-D ``data`` mesh: the batch axis
is sharded, the parameters are replicated and XLA all-reduces the
gradients. The port takes PyTorch's idiom, which is also how the reference
ran (Lightning DDP spawn, reference base_trainer.py:309-311): one process
per card, joined by ``torch.distributed``.

- ``launch`` starts one process per rank (``torch.multiprocessing``
  spawn) and ``initialize_distributed`` joins a process to the group from
  the multi-host trio (``--coordinator-address`` / ``--num-processes`` /
  ``--process-id``, or the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
  / ``JAX_PROCESS_ID`` environment variables). The backend is NCCL when
  every rank has its own card and gloo when the ranks run on the CPU; gloo
  on a card (ranks sharing one card, which NCCL refuses) is chosen only
  when asked for. A rank's global index is ``process_id · local_ranks +
  local_index``.
- ``Mesh`` is one rank's view: world size, rank, device and backend.
  ``make_mesh(num_devices)`` is the process's mesh; ``None`` takes every
  rank there is (1 without a process group).
- Every process computes the same global batch from the shared seeds and
  keeps its contiguous share (``local_slice``; ``rank_chunks`` for each
  evaluation chunk, whose outputs ``gather_chunks`` puts back in order);
  ``ShardedDraws`` draws a generator's tensors in the global batch's shape
  and keeps the rank's lanes, so N ranks draw what one process draws.
- ``shard_rows`` / ``place_graph``: a rank's block of a table whose rows
  are padded to a multiple of the world size (JAX's shard rule: ``degrees``
  stays whole, by name; the flat ``[(N+2)·max_deg]`` tables pad to a
  multiple of ``world · max_deg``, so each node's slots stay on one rank).
  ``gather_rows`` reads rows of such a table across ranks: each rank sends
  the ids it needs to their owners (each distinct id once, unless a
  gradient is wanted), each owner answers from its block and the rows come
  back in order; with a gradient, the backward sends each row's gradient
  back to its owner, which scatter-adds it.
- Collectives run whenever a process group exists, also at one rank, and
  are no-ops without one. Under gloo, ``all_gather`` and ``all_to_all`` of
  card tensors go through host memory (gloo takes card tensors for
  ``all_reduce`` and ``broadcast`` only); nothing falls back from one
  backend to another. ``barrier`` raises when it fails.

``enable_timing`` makes the collectives record their time (CUDA events on
a card, the host clock on the CPU) under ``all_reduce`` and
``gather_rows``; ``timing_ms`` reads and clears the sums.
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import socket
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0

logger = logging.getLogger("pmgt_tpu_torch")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group. ``backend`` is None in
    a process without a group: then ``size`` is 1 and every collective is
    the identity."""

    size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where small bookkeeping tensors live: the card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def stages(self, t: torch.Tensor) -> bool:
        """True when a gather or all-to-all of ``t`` goes through host
        memory (gloo and a card tensor)."""
        return self.backend == "gloo" and t.is_cuda


_MESH: Optional[Mesh] = None
_TIMING: Optional[Dict[str, list]] = None


def current_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The process's mesh: its group's, or one rank on ``device``."""
    if _MESH is not None:
        return _MESH
    return Mesh(device=torch.device(device if device is not None else "cpu"))


def make_mesh(num_devices: Optional[int] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The 1-D data mesh over ``num_devices`` ranks (None: every rank of
    the process's group, 1 without one). Raises, as the JAX package does,
    when more devices are asked for than there are ranks, and when fewer
    are: a rank cannot leave its group."""
    mesh = current_mesh(device)
    if num_devices is None or num_devices == mesh.size:
        return mesh
    if num_devices > mesh.size:
        raise ValueError(f"requested {num_devices} devices but only {mesh.size} are visible")
    raise ValueError(f"requested {num_devices} devices in a group of {mesh.size} ranks; "
                     "--num-devices must equal the number of ranks")


# ----------------------------------------------------------------------
# process groups
# ----------------------------------------------------------------------

def resolve_backend(device: str, ranks_per_host: int, backend: Optional[str] = None) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU. More ranks
    than cards on a host need gloo, asked for explicitly."""
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and ranks_per_host > cards:
            raise ValueError(f"requested {ranks_per_host} devices but only {cards} are visible "
                             "(ranks sharing a card need backend 'gloo')")
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs device 'cuda'")
    return backend


def rank_device(device: str, local_index: int) -> torch.device:
    """The card of the ``local_index``-th rank of a host (cards are shared
    round-robin when there are more ranks than cards), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_index % torch.cuda.device_count())


def start(rank: int, world: int, init_method: str, device: torch.device, backend: str,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join this process to the group as ``rank`` of ``world`` and make
    its mesh the process's."""
    global _MESH
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _MESH = Mesh(size=world, rank=rank, device=device, backend=backend)
    logger.info("rank %d/%d on %s (%s)", rank, world, device, backend)
    return _MESH


def stop() -> None:
    """Leave the group (if any)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def distributed_trio(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """(coordinator, processes, process id) from the arguments, else from
    the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    environment; None when no coordinator is given (one process)."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return None
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs --num-processes and --process-id "
                         "(or JAX_NUM_PROCESSES and JAX_PROCESS_ID)")
    return coordinator_address, int(num_processes), int(process_id)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           local_index: int = 0, local_ranks: int = 1,
                           device: str = "cuda", backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the group of ``num_processes`` hosts with ``local_ranks``
    ranks each, as rank ``process_id · local_ranks + local_index``, over
    ``tcp://<coordinator_address>``. Arguments fall back to the JAX
    environment trio; returns False (and does nothing) without a
    coordinator."""
    trio = distributed_trio(coordinator_address, num_processes, process_id)
    if trio is None:
        return False
    coordinator, processes, pid = trio
    backend = resolve_backend(device, local_ranks, backend)
    start(pid * local_ranks + local_index, processes * local_ranks, f"tcp://{coordinator}",
          rank_device(device, local_index), backend, timeout_s)
    return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_index, fn, args, init_method, world, rank_base, device, backend,
                timeout_s, num_threads, out_dir):
    if num_threads:
        torch.set_num_threads(num_threads)
    start(rank_base + local_index, world, init_method, rank_device(device, local_index),
          backend, timeout_s)
    value = fn(*args)
    stop()
    with open(os.path.join(out_dir, f"rank{local_index}.pkl"), "wb") as f:
        pickle.dump(value, f)


def launch(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device: str = "cuda",
           backend: Optional[str] = None, coordinator_address: Optional[str] = None,
           num_processes: int = 1, process_id: int = 0,
           timeout_s: float = DEFAULT_TIMEOUT_S, run_timeout_s: Optional[float] = None,
           num_threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each, and
    return their values in rank order. The ranks join one group (this
    host's, or with ``coordinator_address`` the group of ``num_processes``
    hosts, this one ``process_id``). ``timeout_s`` bounds each collective
    (a rank that waits longer in one raises); ``run_timeout_s``, when
    given, bounds the whole run, which is otherwise as long as it takes.
    A rank that fails, or a run past its deadline, fails the launch, and
    every process it started is stopped. ``fn`` must be importable by
    name (spawned processes unpickle it)."""
    backend = resolve_backend(device, nprocs, backend)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else f"tcp://127.0.0.1:{free_port()}")
    world = num_processes * nprocs
    mp = torch.multiprocessing
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_entry, nprocs=nprocs, start_method="spawn", join=False,
            args=(fn, tuple(args), init, world, process_id * nprocs, device, backend, timeout_s,
                  num_threads, out_dir))
        deadline = None if run_timeout_s is None else time.monotonic() + run_timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {nprocs} ranks did not finish in {run_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        values = []
        for r in range(nprocs):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                values.append(pickle.load(f))
    return values


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def enable_timing(on: bool = True) -> None:
    global _TIMING
    _TIMING = {} if on else None


def timing_ms() -> Dict[str, float]:
    """Milliseconds spent in each kind of collective since the last call
    (waits for the card), and clears the sums."""
    if _TIMING is None:
        return {}
    out = {}
    for name, spans in _TIMING.items():
        total = 0.0
        for a, b in spans:
            if isinstance(a, float):
                total += (b - a) * 1e3
            else:
                b.synchronize()
                total += a.elapsed_time(b)
        out[name] = total
        spans.clear()
    return out


@contextmanager
def _timed(name: str, device: torch.device):
    if _TIMING is None:
        yield
        return
    if device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
    else:
        a = time.perf_counter()
        yield
        b = time.perf_counter()
    _TIMING.setdefault(name, []).append((a, b))


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks (in place; ``op`` sum, max or min)."""
    if not mesh.distributed:
        return t
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    with _timed("all_reduce", t.device):
        dist.all_reduce(t, op=ops[op])
    return t


def all_reduce_grads(mesh: Mesh, params) -> None:
    """Sum the gradients over the ranks, in one flat all-reduce."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(mesh, flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset: offset + n].view_as(g))
        offset += n


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (a max-reduce)."""
    if not mesh.distributed:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=mesh.comm_device)
    return bool(all_reduce(mesh, t, "max").item())


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank; raises when the broadcast fails."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.comm_device)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank; raises when a rank does not arrive in the
    group's timeout."""
    if not mesh.distributed:
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0."""
    if mesh.distributed:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def gather_to_host(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-sized ``local`` blocks concatenated along axis 0,
    on every rank (an all-gather)."""
    if not mesh.distributed:
        return local
    src = local.cpu() if mesh.stages(local) else local.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(local.device)


def gather_chunks(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's share of each evaluation chunk, ``local`` [C, c, ...]
    (the rank's contiguous c rows of each chunk), gathered back in chunk
    order → [C · world · c, ...] on every rank."""
    if not mesh.distributed:
        return local.reshape((-1,) + tuple(local.shape[2:]))
    full = gather_to_host(mesh, local)  # [world * C, c, ...]
    full = full.reshape((mesh.size,) + tuple(local.shape)).transpose(0, 1)
    return full.reshape((-1,) + tuple(local.shape[2:]))


def _all_to_all(mesh: Mesh, x: torch.Tensor, send: List[int], recv: List[int]) -> torch.Tensor:
    src = x.cpu() if mesh.stages(x) else x.contiguous()
    out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype, device=src.device)
    dist.all_to_all_single(out, src, recv, send)
    return out.to(x.device)


# ----------------------------------------------------------------------
# batches and draws
# ----------------------------------------------------------------------

def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_slice(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous share of ``n`` rows (``n`` a multiple of the
    world size)."""
    if n % mesh.size:
        raise ValueError(f"global batch dim {n} not divisible by {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def chunk_eval_inputs(chunk: int, arrays, pad_values=None) -> List[np.ndarray]:
    """Pad host arrays [n, ...] to whole chunks of ``chunk`` rows →
    [C, chunk, ...] numpy arrays. ``pad_values`` gives one fill value per
    array (default 0); node-id arrays pad with a real row's id so that
    padding reads a real row and is masked later."""
    n = len(arrays[0])
    c = max((n + chunk - 1) // chunk, 1)
    if pad_values is None:
        pad_values = (0,) * len(arrays)
    out = []
    for a, fill in zip(arrays, pad_values):
        a = np.asarray(a)
        pad = c * chunk - n
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        out.append(a.reshape((c, chunk) + a.shape[1:]))
    return out


def rank_chunks(mesh: Mesh, chunk: int, arrays, pad_values=None) -> List[np.ndarray]:
    """The rank's share of every evaluation chunk: ``chunk_eval_inputs``
    with ``chunk`` rounded up to a multiple of the world size, then the
    rank's contiguous rows of each chunk → [C, chunk / world, ...].
    ``gather_chunks(mesh, stacked outputs)[:n]`` puts the outputs of all
    ranks back in row order."""
    chunk = pad_to_multiple(chunk, mesh.size)
    share = local_slice(mesh, chunk)
    return [a[:, share] for a in chunk_eval_inputs(chunk, arrays, pad_values)]


class ShardedDraws:
    """A generator whose draws are made in the global batch's shape, of
    which the rank keeps its lanes: ``index`` [n] are the rank's lanes
    among the ``total`` lanes of the global draw. One rank's draws are
    then the same numbers as a single process's at the global batch."""

    def __init__(self, generator: torch.Generator, index: torch.Tensor, total: int):
        self.generator = generator
        self.index = index
        self.total = int(total)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def restored(self, state: torch.Tensor) -> "ShardedDraws":
        """A copy whose generator starts from ``state``."""
        g = torch.Generator(device=self.device)
        g.set_state(state)
        return ShardedDraws(g, self.index, self.total)

    def take(self, draw: Callable[[Tuple[int, ...]], torch.Tensor], shape, axis: int = 0,
             group: int = 1) -> torch.Tensor:
        """``draw(global shape)`` restricted to the rank's lanes on
        ``axis``, where each lane spans ``group`` consecutive entries."""
        shape = list(shape)
        if shape[axis] != self.index.numel() * group:
            raise ValueError(f"axis {axis} of {shape} is not {self.index.numel()} lanes of "
                             f"{group}")
        shape[axis] = self.total * group
        idx = self.index.to(self.device)
        if group > 1:
            idx = (idx[:, None] * group + torch.arange(group, device=self.device)).reshape(-1)
        return draw(tuple(shape)).index_select(axis, idx)


def rand(shape, generator, device=None, *, axis: int = 0, group: int = 1,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.rand(shape, generator=generator)``; from a ``ShardedDraws``
    the rank's lanes (``axis``, ``group``) of the global draw."""
    if isinstance(generator, ShardedDraws):
        g = generator.generator
        return generator.take(lambda s: torch.rand(s, generator=g, device=g.device, dtype=dtype),
                              shape, axis, group)
    dev = device if device is not None else generator.device
    return torch.rand(shape, generator=generator, device=dev, dtype=dtype)


def randint(low: int, high: int, shape, generator, device=None, *, axis: int = 0) -> torch.Tensor:
    """``torch.randint`` as ``rand`` draws uniforms."""
    if isinstance(generator, ShardedDraws):
        g = generator.generator
        return generator.take(
            lambda s: torch.randint(low, high, s, generator=g, device=g.device), shape, axis)
    dev = device if device is not None else generator.device
    return torch.randint(low, high, shape, generator=generator, device=dev)


def lane_draws(mesh: Optional[Mesh], generator, segments: Sequence[Tuple[int, int]]):
    """``generator`` wrapped so that it draws the global lanes and keeps
    this rank's: ``segments`` lists (global lanes, lanes per rank) of the
    lane layout's consecutive parts, each split contiguously over the
    ranks. ``generator`` itself with one rank (or none)."""
    if mesh is None or mesh.size == 1 or generator is None:
        return generator
    parts, base = [], 0
    for total, per in segments:
        parts.append(base + mesh.rank * per + torch.arange(per))
        base += total
    return ShardedDraws(generator, torch.cat(parts), base)


# ----------------------------------------------------------------------
# row-sharded tables
# ----------------------------------------------------------------------

def shard_rows(mesh: Mesh, array, multiple: int = 1):
    """The rank's block of ``array``'s rows (numpy array or tensor), the
    rows zero-padded to a multiple of ``world · multiple`` (padding rows
    are never read)."""
    block = pad_to_multiple(array.shape[0], mesh.size * multiple) // mesh.size
    part = array[mesh.rank * block: (mesh.rank + 1) * block]
    pad = (block - part.shape[0],) + tuple(array.shape[1:])
    if isinstance(part, torch.Tensor):
        return torch.cat([part, torch.zeros(pad, dtype=part.dtype, device=part.device)])
    return np.concatenate([part, np.zeros(pad, part.dtype)])


def place_graph(mesh: Mesh, graph, shard: bool = False, device=None):
    """The device view of a ``PaddedGraph`` for this rank: whole
    (``shard=False``), or with every per-node table row-sharded: 2-D
    ``[N+2, ...]`` tables and flat ``[(N+2)·max_deg]`` tables (padded to a
    multiple of ``world · max_deg``, so a node's slots stay on one rank).
    ``degrees`` stays whole, decided by name (at max_deg 1 it has a flat
    table's shape)."""
    device = mesh.device if device is None else device
    if not shard:
        return graph.to(device)
    whole = graph.to("cpu")
    n_total, max_deg = int(whole.nbr_ids.shape[0]), int(whole.nbr_ids.shape[1])

    def place(name, a):
        if name == "degrees":
            return a.to(device)
        if a.ndim >= 2 and a.shape[0] == n_total:
            return shard_rows(mesh, a).to(device)
        if a.ndim == 1 and a.shape[0] == n_total * max_deg:
            return shard_rows(mesh, a, multiple=max_deg).to(device)
        return a.to(device)

    fields = [place(name, getattr(whole, name)) for name in whole.tensor_fields]
    return type(whole)(*fields, mesh=mesh, rows_total=n_total)


def _plan(mesh: Mesh, ids: torch.Tensor, block: int):
    """Who asks whom for which rows. ``ids`` ascend, so they come grouped
    by owner: (send counts, receive counts, the local row ids this rank
    must answer)."""
    owner = torch.div(ids, block, rounding_mode="floor")
    send_counts = torch.bincount(owner, minlength=mesh.size)
    recv_counts = torch.empty_like(send_counts, device=mesh.comm_device)
    dist.all_to_all_single(recv_counts, send_counts.to(mesh.comm_device))
    send, recv = send_counts.tolist(), recv_counts.tolist()
    return send, recv, _all_to_all(mesh, ids - owner * block, send, recv)


def _answer(mesh: Mesh, local: torch.Tensor, plan) -> torch.Tensor:
    send, recv, asked = plan
    return _all_to_all(mesh, local[asked], recv, send)


class _GatherRows(torch.autograd.Function):
    """Rows of a row-sharded table, with the gradient sent back to each
    row's owner, which scatter-adds it."""

    @staticmethod
    def forward(ctx, local, mesh, plan):
        ctx.mesh, ctx.plan, ctx.shape = mesh, plan, local.shape
        return _answer(mesh, local, plan)

    @staticmethod
    def backward(ctx, grad):
        send, recv, asked = ctx.plan
        with _timed("gather_rows", grad.device):
            back = _all_to_all(ctx.mesh, grad, send, recv)
            out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
            # an accumulating index_put_ sums a row's occurrences in a fixed
            # order, as the backward of one process's gather does; a card's
            # index_add_ adds them with atomics in whatever order they land,
            # and Adam can amplify the difference from run to run
            out.index_put_((asked,), back, accumulate=True)
        return out, None, None


def gather_rows(mesh: Optional[Mesh], local, ids: torch.Tensor):
    """``table[ids]`` of a table row-sharded over ``mesh``, from this
    rank's block ``local`` (every rank's block has the same rows). Pass a
    tuple of blocks sharing one row layout to gather them with one
    exchange of ids; a tuple comes back. A block that requires a gradient
    gets one (each row's gradient returns to its owner). Without a group,
    a plain gather."""
    tables = tuple(local) if isinstance(local, (tuple, list)) else (local,)
    if mesh is None or not mesh.distributed:
        outs = tuple(t[ids] for t in tables)
    else:
        block = int(tables[0].shape[0])
        flat = ids.reshape(-1).to(torch.int64)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
        with _timed("gather_rows", ids.device):
            if grad:
                # every occurrence crosses, so the owner sums each row's
                # gradient over all of them in one pass, as one process's
                # gather does (summed in two stages it rounds otherwise,
                # and Adam amplifies the difference over the steps)
                order = torch.argsort(flat, stable=True)
                keys, take = flat[order], torch.argsort(order)
            else:  # each distinct row crosses once (ids repeat a lot)
                keys, take = torch.unique(flat, return_inverse=True)
            plan = _plan(mesh, keys, block)
            outs = tuple(
                (_GatherRows.apply(t, mesh, plan) if grad and t.requires_grad
                 else _answer(mesh, t, plan))[take].reshape(tuple(ids.shape) + tuple(t.shape[1:]))
                for t in tables)
    return outs if isinstance(local, (tuple, list)) else outs[0]
