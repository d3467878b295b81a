"""Meshes over ``torch.distributed`` ranks (the port of
``src/repro/launch/mesh.py``).

The reference is one controller over a ``jax`` Mesh of devices.  The port
runs one process per device (SPMD): every rank holds its own shard and
drives the same engine, and the ranks meet only in collectives.  A mesh is
then a process group plus its axis sizes; ``shape`` is a dict of axis
sizes, as the reference's ``Mesh.shape`` is, so the spec functions of
``repro_torch.distributed.sharding`` take either.  A serve mesh
(``ServeMesh``) is one "model" axis; a training mesh (``TrainMesh``) is
``data x model`` with a process group for each data column and model row.

``DryTrainMesh`` is a training mesh with no process behind it: a rank of a
virtual ``data x model`` mesh of any size, on ``meta`` tensors, whose
collectives return their results' shapes and are only recorded (the dry
run, ``launch.dryrun``).  The prefill and decode steps on a mesh need no
collective of their own: a sequence-parallel cache's kv heads are an
``all_gather`` over "model" and a slice (``part``), and its decode
partials an ``all_gather`` over the sequence's axis.

``spawn_ranks`` starts N ranks (the CPU tests' ``gloo`` ranks, the serve
launcher's ranks on one or several cards) and replaces the reference's
``ensure_fake_pod``.  Everything here is a function: importing the module
touches no process group and no device.

The collectives are the list forms ``all_gather``, ``all_reduce`` and
``broadcast_object_list``: ``gloo``, which serves two ranks on one card
(NCCL refuses two ranks on one GPU), lacks the rest for CUDA tensors.  The
engine's control traffic (a step's broadcast and its closing gather) runs
on a gloo group of its own beside the model's collectives: a rank that
crashed and went on to its step's closing gather then waits there, to the
collective timeout at worst, while the others wait in the model's
collective, where on one group the two would be paired and gloo would
abort on their sizes.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis sizes only (``shape``: axis name -> size, in mesh order): what
    the spec functions read, with no process behind it."""
    shape: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The serve engine's mesh: this rank of an initialized process group
    whose ranks form the "model" axis (``shape`` is ``{"data": 1,
    "model": world}``).  The model's collectives (``gather``, ``reduce``)
    run on the default group, and ``issued`` counts them; the engine's
    control collectives (``broadcast``, ``gather_ints``) run on
    ``control``, a gloo group of the same ranks, staged on the CPU."""
    rank: int
    world: int
    shape: Dict[str, int]
    control: object = None
    _issued: list = dataclasses.field(default_factory=lambda: [0],
                                      compare=False, repr=False)

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def issued(self) -> int:
        """Model collectives this rank has entered on this mesh."""
        return self._issued[0]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._issued[0] += 1
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in f32 and returned in
        ``x``'s dtype (a bf16 partial sum is not rounded twice)."""
        y = x.float().contiguous()
        self._issued[0] += 1
        dist.all_reduce(y)
        return y.to(x.dtype)

    def broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank (picklable), on ``control``."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.control,
                                   device=torch.device("cpu"))
        return box[0]

    def gather_ints(self, values: List[int]) -> List[List[int]]:
        """Every rank's int64 ``values`` (one length on every rank), on
        ``control``."""
        t = torch.tensor(values, dtype=torch.int64)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.control)
        return [p.tolist() for p in parts]


# the control group of the initialized process group (made once: every rank
# must make a group together; dropped when ``process_group`` leaves it)
_CONTROL: Dict[str, object] = {}


def _control_group():
    if "group" not in _CONTROL:
        _CONTROL["group"] = dist.new_group(backend="gloo")
    return _CONTROL["group"]


def make_serve_mesh(n_model: Optional[int] = None) -> ServeMesh:
    """The serve mesh of this rank: tensor-parallel only, ``{"data": 1,
    "model": n}`` over the initialized process group, which must hold
    exactly ``n_model`` ranks (default: all of them).  Raises without an
    initialized group of that size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a serve mesh of {n_model or 'all'} rank(s) needs an "
            "initialized torch.distributed process group (spawn_ranks, or "
            "init_process_group with its world size and rank)")
    world = dist.get_world_size()
    n = n_model or world
    if n != world:
        raise ValueError(f"serve mesh wants {n} ranks, the process group "
                         f"holds {world}")
    return ServeMesh(rank=dist.get_rank(), world=world,
                     shape={"data": 1, "model": n},
                     control=_control_group())


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A training mesh: this rank of an initialized group of ``data *
    model`` ranks laid out row-major as ``jax.make_mesh((D, M), ("data",
    "model"))`` lays its devices out, so the rank's coordinates are
    ``divmod(rank, M)``.  ``groups`` holds the process group of the rank's
    data column ("data": the ranks that share its model coordinate), of its
    model row ("model") and of every rank ("world"; None is the default
    group).

    The collectives are list-form ``all_gather`` and ``all_reduce``, which
    gloo serves for CUDA tensors; a reduce-scatter is an ``all_reduce`` and
    a slice (``reduce`` then ``part``).  A "data" or "model" axis of one
    rank moves nothing, so ``gather`` and ``reduce`` over it start no
    collective and return a copy (the values a one-rank collective gives);
    the "world" group's collectives run whatever its size, so a one-rank
    mesh still drives the backend.  ``issued`` counts the collectives
    by kind, with the bytes this rank sent and the host seconds spent in the
    calls (gloo's calls return when done; NCCL's when enqueued)."""
    rank: int
    world: int
    shape: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    _issued: dict = dataclasses.field(
        default_factory=lambda: {"all_gather": [0, 0, 0.0],
                                 "all_reduce": [0, 0, 0.0]},
        compare=False, repr=False)

    @property
    def coords(self) -> Dict[str, int]:
        d, m = divmod(self.rank, self.shape["model"])
        return {"data": d, "model": m}

    @property
    def issued(self) -> Dict[str, list]:
        """{kind: [collectives entered, bytes this rank sent, seconds]}."""
        return {k: list(v) for k, v in self._issued.items()}

    def reset_issued(self) -> None:
        for v in self._issued.values():
            v[:] = [0, 0, 0.0]

    def size(self, axis: str) -> int:
        return self.world if axis == "world" else self.shape[axis]

    def index(self, axis: str) -> int:
        return self.rank if axis == "world" else self.coords[axis]

    def _count(self, kind: str, x: torch.Tensor, t0: float) -> None:
        v = self._issued[kind]
        v[0] += 1
        v[1] += x.numel() * x.element_size()
        v[2] += time.perf_counter() - t0

    def _alone(self, axis: str) -> bool:
        return axis != "world" and self.shape[axis] == 1

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """Every ``axis`` rank's ``x`` concatenated along ``dim`` in
        coordinate order."""
        if self._alone(axis):
            return x.clone(memory_format=torch.contiguous_format)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size(axis))]
        t0 = time.perf_counter()
        dist.all_gather(parts, x, group=self.groups[axis])
        self._count("all_gather", x, t0)
        return torch.cat(parts, dim=dim)

    def reduce(self, x: torch.Tensor, axis: str, op: str = "sum"
               ) -> torch.Tensor:
        """The sum of every ``axis`` rank's ``x`` (their elementwise max
        when ``op`` is "max"), taken in f32 and returned in ``x``'s dtype (a
        bf16 partial is not rounded twice).  Always in a buffer of its own:
        ``x`` may be an output that a selective rematerialisation keeps,
        which an in-place sum would corrupt."""
        if self._alone(axis):
            return x.clone(memory_format=torch.contiguous_format)
        y = x.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        t0 = time.perf_counter()
        dist.all_reduce(y, op=_REDUCE_OPS[op], group=self.groups[axis])
        self._count("all_reduce", y, t0)
        return y.to(x.dtype)

    def part(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's contiguous 1/n of ``x`` along ``dim`` (n the size of
        ``axis``): the inverse of ``gather``."""
        n = self.size(axis)
        k = x.shape[dim] // n
        return x.narrow(dim, self.index(axis) * k, k).contiguous()

    def barrier(self) -> None:
        """Every rank has reached this point (an ``all_reduce`` of one value
        on the world group)."""
        self.reduce(torch.zeros((), device=self.device), "world")


@dataclasses.dataclass(frozen=True)
class DryTrainMesh(TrainMesh):
    """A rank (the dry run's: 0) of a virtual ``data x model`` training
    mesh: the interface
    ``TrainMesh`` offers the train step and ``distributed.collectives``,
    with ``meta`` tensors and no process group.  ``gather`` and ``reduce``
    start no collective: they return a tensor of the result's shape and
    dtype and record the collective in ``TrainMesh``'s units (``issued``:
    kind, calls, the bytes this rank sends; the host seconds stay 0) and in
    ``log`` (kind, bytes, axis, the ranks of the group).  A one-rank
    "data" or "model" axis moves nothing, as on ``TrainMesh``.

    The reference's production meshes (``production_mesh_shape``) are
    16 x 16 over ("data", "model") and 2 x 16 x 16 over ("pod", "data",
    "model"); its FSDP and batch axes are ("pod", "data") jointly, so the
    pod mesh is 32 x 16 here (``dry_train_mesh``): "data" holds both.
    Ranks are laid out row-major, ``rank = d * model + m``, as on
    ``TrainMesh``."""
    log: list = dataclasses.field(default_factory=list, compare=False,
                                  repr=False)

    def group_ranks(self, axis: str) -> List[int]:
        """The ranks of this rank's ``axis`` group, in coordinate order."""
        n_model = self.shape["model"]
        d, m = self.coords["data"], self.coords["model"]
        if axis == "world":
            return list(range(self.world))
        if axis == "data":
            return [i * n_model + m for i in range(self.shape["data"])]
        return [d * n_model + j for j in range(n_model)]

    def _record(self, kind: str, nbytes: int, axis: str) -> None:
        v = self._issued[kind]
        v[0] += 1
        v[1] += nbytes
        self.log.append((kind, nbytes, axis, self.group_ranks(axis)))

    def reset_issued(self) -> None:
        super().reset_issued()
        self.log.clear()

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        if self._alone(axis):
            return x.clone(memory_format=torch.contiguous_format)
        self._record("all_gather", x.numel() * x.element_size(), axis)
        shape = list(x.shape)
        shape[dim] *= self.size(axis)
        return x.new_empty(shape)

    def reduce(self, x: torch.Tensor, axis: str, op: str = "sum"
               ) -> torch.Tensor:
        if self._alone(axis):
            return x.clone(memory_format=torch.contiguous_format)
        # sent in f32, as TrainMesh.reduce adds
        self._record("all_reduce", x.numel() * 4, axis)
        return x.new_empty(x.shape)


def dry_train_mesh(shape: Dict[str, int], rank: int = 0) -> DryTrainMesh:
    """Rank ``rank`` of a virtual training mesh of axis sizes ``shape``:
    ("data", "model"), or the pod mesh's ("pod", "data", "model") with
    "pod" folded into "data" (see ``DryTrainMesh``)."""
    data = shape.get("pod", 1) * shape["data"]
    model = shape["model"]
    return DryTrainMesh(rank=rank, world=data * model,
                        shape={"data": data, "model": model},
                        groups={}, device=torch.device("meta"))


# the subgroups of the initialized process group, by their ranks (made
# once, by every rank in the same order; dropped when ``process_group``
# leaves the group)
_GROUPS: Dict[tuple, object] = {}


def _group(ranks: List[int]):
    if len(ranks) == dist.get_world_size():
        return None
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(ranks=list(ranks))
    return _GROUPS[key]


def make_train_mesh(data: int, model: int) -> TrainMesh:
    """This rank's ``TrainMesh`` of ``data x model`` over the initialized
    process group, which must hold exactly ``data * model`` ranks.  Every
    rank creates every data column's and model row's group in the same
    order, as ``dist.new_group`` requires; a later mesh of other axis sizes
    over the same group reuses them where they coincide.  Raises without an
    initialized group of that size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {data}x{model} training mesh needs an initialized "
            "torch.distributed process group (spawn_ranks, or "
            "init_process_group with its world size and rank)")
    world = dist.get_world_size()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a {data}x{model} training mesh wants "
                         f"{data * model} ranks, the process group holds "
                         f"{world}")
    columns = [_group([d * model + m for d in range(data)])
               for m in range(model)]
    rows = [_group([d * model + m for m in range(model)])
            for d in range(data)]
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    return TrainMesh(rank=rank, world=world,
                     shape={"data": data, "model": model},
                     groups={"data": columns[m], "model": rows[d],
                             "world": None},
                     device=device)


def make_local_mesh() -> MeshShape:
    """Degenerate ``{"data": n, "model": 1}`` over the initialized group's
    ranks (one without a group)."""
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return MeshShape({"data": n, "model": 1})


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes as axis sizes: 16x16 over
    ("data", "model"), or 2x16x16 over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def mesh_device_count(mesh) -> int:
    n = 1
    for size in mesh.shape.values():
        n *= int(size)
    return n


def serve_backend(n: int, device: str) -> str:
    """The backend of an ``n``-rank serve mesh on ``device``: NCCL with one
    rank a card when ``n`` cards are visible, else gloo (on the CPU, or
    every rank on ``cuda:0``)."""
    if device == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    """The card (or CPU) rank ``rank`` serves on: ``cuda:rank`` under NCCL,
    ``cuda:0`` for every gloo rank on a card."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


@contextlib.contextmanager
def process_group(rank: int, world: int, backend: str, store_path: str,
                  device: str = "cpu",
                  timeout_s: float = COLLECTIVE_TIMEOUT_S):
    """Join (and on exit leave) the ``world``-rank group that meets in the
    ``FileStore`` at ``store_path``; a collective that waits longer than
    ``timeout_s`` raises."""
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield dev
    finally:
        _CONTROL.clear()
        _GROUPS.clear()
        dist.destroy_process_group()


def _rank_main(fn, rank, world, backend, device, store_path, args, conn,
               collective_timeout_s):
    try:
        # one CPU thread a rank: several ranks' OpenMP pools on one host
        # stall every collective (a CPU step took 2.4x as long at 4 threads)
        torch.set_num_threads(1)
        with process_group(rank, world, backend, store_path, device,
                           collective_timeout_s) as dev:
            out = fn(make_serve_mesh(world), dev, *args)
        # by value: torch's pickler would hand tensors over as shared
        # memory that dies with this process
        conn.send((True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


_stop_at_exit = False


def stop_rank_server() -> None:
    """Stop the ``forkserver`` that ``spawn_ranks`` forks its ranks from,
    and multiprocessing's resource tracker beside it, and wait until both
    have exited.  Left alone, both outlive the process that spawned ranks
    until they notice it is gone.  ``spawn_ranks`` registers this to run
    at exit; a later ``spawn_ranks`` starts both again."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def spawn_ranks(fn: Callable, world: int, backend: str = "gloo",
                device: str = "cpu", args: tuple = (),
                timeout_s: float = 900.0,
                collective_timeout_s: float = COLLECTIVE_TIMEOUT_S,
                started: Optional[Callable[[List], None]] = None) -> List:
    """Run ``fn(mesh, device, *args)`` in ``world`` new processes, one a
    rank, forked from a ``forkserver`` that has imported torch and the
    engine (it touches no device), and return the ranks' results in rank
    order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable.  The ranks meet in a ``FileStore`` in
    a fresh temporary directory (never a fixed port: several groups may run
    at once), and a collective that waits longer than
    ``collective_timeout_s`` raises.  ``started``, if given, is called with
    the rank processes once they run (the gateway launcher forwards its
    signals to rank 0's).  Each rank runs one CPU thread and
    sends its result back over a pipe of its own.  If any rank raises or
    ends without a result, or the ranks outlast ``timeout_s``, the other
    ranks are killed and this raises with the failing rank's traceback.
    The fork server is stopped when this process exits
    (``stop_rank_server``)."""
    import multiprocessing as mp
    from multiprocessing.connection import wait
    ctx = mp.get_context("forkserver")
    # a fresh server process (nothing of the caller's state, JAX's threads
    # included) imports these once, and every rank of every later group
    # forks from it, where a spawned rank spent seconds importing torch
    ctx.set_forkserver_preload(["torch", "repro_torch.launch.mesh",
                                "repro_torch.serve.engine",
                                "repro_torch.models",
                                "repro_torch.train.trainer"])
    global _stop_at_exit
    if not _stop_at_exit:
        atexit.register(stop_rank_server)
        _stop_at_exit = True
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, r, world, backend, device, os.path.join(tmp, "store"),
              args, pipes[r][1], collective_timeout_s), daemon=True)
        for r in range(world)]
    out: Dict[int, object] = {}
    try:
        for p, (_, w) in zip(procs, pipes):
            p.start()
            # the rank holds the only write end now: its pipe reads EOF
            # if it dies without a result
            w.close()
        if started is not None:
            started(procs)
        pending = {r_conn: r for r, (r_conn, _) in enumerate(pipes)}
        deadline = time.monotonic() + timeout_s
        while pending:
            ready = wait(list(pending), timeout=1.0)
            if not ready and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks outlasted "
                                   f"{timeout_s:.0f} s")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    ok, val = conn.recv()
                except EOFError:
                    procs[rank].join(timeout=5)
                    raise RuntimeError(
                        f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} and no result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{val}")
                out[rank] = pickle.loads(val)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for r_conn, _ in pipes:
            r_conn.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
