"""Ranks in spawned processes: a process group, a mesh, and calls on them.

``RankPool(world, backend, device)`` spawns ``world`` worker processes (the
``spawn`` start method), each of which joins one process group at
``tcp://localhost:<free port>`` with its rank and the world size given
explicitly, and then serves calls: ``pool.run(fn, *args, **kwargs)`` runs
``fn`` on every rank and returns the ranks' results in rank order. An
argument ``MeshArg(dp, tp)`` is replaced on each rank by its
``parallel/mesh.make_mesh(dp=dp, tp=tp)`` (made once per shape). Tensors
go to each rank's device before the call and come back on the CPU.

Every wait is bounded: the group's rendezvous and collectives by
``timeout`` (``init_process_group(timeout=...)``), each result by the same
timeout, and ``close`` joins with one too, so a hung group raises instead
of hanging its caller. A worker's exception comes back with its traceback
and is raised by ``run``.

Over gloo the ranks are CPU processes (``device="cpu"``) or share one card
(``device="cuda"``: gloo stages CUDA tensors through the host; NCCL
refuses two ranks on one device); over NCCL rank r takes ``cuda:r``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshArg:
    """Stands for the rank's (dp, tp) mesh in ``RankPool.run``'s
    arguments; None takes ``mesh_shape``'s default."""
    dp: Optional[int] = None
    tp: Optional[int] = None


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _moved(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, torch.nn.Module):
        return x.to(device)
    return x


def _worker(rank: int, world: int, backend: str, device: str, port: int,
            timeout_s: float, threads: int, tasks, results) -> None:
    import torch.distributed as dist

    from transformer_mm_explainability_tpu_torch.parallel import mesh as pmesh

    if device == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    meshes: Dict[Tuple, Any] = {}

    def mesh_of(arg: MeshArg):
        key = (arg.dp, arg.tp)
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(dp=arg.dp, tp=arg.tp)
        return meshes[key]

    def bind(x):
        return mesh_of(x) if isinstance(x, MeshArg) else _moved(x, dev)

    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                out = fn(*map(bind, args),
                         **{k: bind(v) for k, v in kwargs.items()})
                results.put((rank, True, _moved(out, "cpu")))
            except Exception:   # reported to the caller, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks of one process group, serving calls."""

    def __init__(self, world: int, backend: str = "gloo",
                 device: str = "cpu", timeout_s: float = 120.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._closed = False
        threads = max(1, (os.cpu_count() or 1) // world)
        port = free_port()
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(rank, world, backend, device, port, timeout_s,
                              threads, self._tasks[rank], self._results))
            for rank in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank → the results in rank
        order. ``fn`` must be importable (a module-level function). After
        a timeout the ranks are stopped, and every later call raises at
        once."""
        if self._closed:
            raise RuntimeError("the ranks were stopped (an earlier call "
                               "timed out, or close was called)")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        got: Dict[int, Any] = {}
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, out = self._results.get(timeout=self.timeout_s)
            except queue.Empty:
                self.close()
                raise TimeoutError(
                    f"no result from {self.world - len(got) - len(errors)} "
                    f"rank(s) within {self.timeout_s:.0f} s") from None
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop the workers (joined within the timeout, else terminated)."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=self.timeout_s)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
