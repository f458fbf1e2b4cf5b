"""Ranks, collectives and the rank launcher over `torch.distributed`.

The port's counterpart of the JAX package's `shard_map` axis and its
`jax.lax` collectives (ppermute, psum, pmax, pmin, all_gather). Each rank is
one process that owns one partition, as an MPI rank owns one processor
directory of the reference's decomposed case (decomposePar).

  * `Comm` wraps one initialised process group: `rank`, `n_parts`,
    `ppermute(x, perm)` (point-to-point pairs over the JAX perm list, built
    from `batch_isend_irecv`), `psum`, `pmax`, `pmin` and `all_gather`.
  * Every call is counted per kind, with the payload bytes this rank sends.
    The JAX package counts the collective equations of its traced step
    program (spmd_step._collective_report); these are EXECUTED calls, so a
    Krylov loop counts once per iteration it ran: the two counts are not
    the same quantity.
  * The backend is the caller's: `gloo` (CPU tensors, or CUDA tensors
    copied through host buffers, counted as `staged`) or `nccl` (one rank
    per card). Nothing picks a backend silently.
  * Each call also folds (kind, dtype, shape) into a running signature;
    `verify_lockstep()` all-gathers it and raises when two ranks have made
    different collective sequences — the eager counterpart of the JAX
    package's check that every partition traced the same program.
  * `launch(fn, n_parts, backend, device, deadline_s, args)` starts the
    ranks as fresh interpreters (`python -c` of `_rank_process`),
    so a rank imports only torch and the port whatever the caller has
    loaded. The rendezvous is a `file://` store in a temporary directory
    (no TCP port to race for), `init_process_group` gets a timeout, and a
    rank that fails, or a run that outlives the deadline, kills every rank
    and raises in the caller.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Comm", "launch", "check_backend", "rank_calls", "rank_probe", "BACKENDS"]

BACKENDS = ("gloo", "nccl")
_KINDS = ("ppermute", "psum", "pmax", "pmin", "all_gather")


class Comm:
    """One rank's view of the process group (the mesh axis of shard_map)."""

    def __init__(self, rank: int, n_parts: int, backend: str, device):
        self.rank = int(rank)
        self.n_parts = int(n_parts)
        self.backend = backend
        self.device = torch.device(device)
        # gloo moves CUDA payloads only for a few collectives and never for
        # send/recv, so every CUDA payload goes through a host buffer
        self.stage = backend == "gloo" and self.device.type == "cuda"
        self.reset_counts()
        self._sig = hashlib.sha1()

    # ---------------------------------------------------------- counters
    def reset_counts(self):
        self.counts: Dict[str, Dict[str, int]] = {
            k: {"calls": 0, "bytes": 0} for k in _KINDS}
        self.staged = {"copies": 0, "bytes": 0}

    def report(self) -> Dict:
        return {"counts": {k: dict(v) for k, v in self.counts.items()},
                "staged": dict(self.staged)}

    def _note(self, kind: str, x: torch.Tensor):
        c = self.counts[kind]
        c["calls"] += 1
        c["bytes"] += x.numel() * x.element_size()
        self._sig.update(f"{kind}:{x.dtype}:{tuple(x.shape)};".encode())

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """The wire copy of x: contiguous, on the host when staged."""
        if self.stage:
            self.staged["copies"] += 1
            self.staged["bytes"] += x.numel() * x.element_size()
            return x.detach().to("cpu").contiguous()
        return x.detach().contiguous().clone()

    def _back(self, h: torch.Tensor) -> torch.Tensor:
        if self.stage:
            self.staged["copies"] += 1
            self.staged["bytes"] += h.numel() * h.element_size()
            return h.to(self.device)
        return h

    # ------------------------------------------------------- collectives
    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """jax.lax.ppermute: each (src, dst) pair sends src's x to dst; a
        rank that no pair sends to receives zeros."""
        self._note("ppermute", x)
        if (self.rank, self.rank) in perm:  # a pair onto itself: a local copy
            return x.clone()
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        buf = self._out(x)
        recv = torch.zeros_like(buf)
        ops = [dist.P2POp(dist.isend, buf, d) for d in dst]
        ops += [dist.P2POp(dist.irecv, recv, s) for s in src]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return self._back(recv)

    def _reduce(self, kind: str, x: torch.Tensor, op) -> torch.Tensor:
        self._note(kind, x)
        shape = x.shape
        buf = self._out(x).reshape(-1)
        dist.all_reduce(buf, op=op)
        return self._back(buf.reshape(shape))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce("psum", x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce("pmax", x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce("pmin", x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[P, *x.shape], rank-major (jax.lax.all_gather)."""
        self._note("all_gather", x)
        buf = self._out(x)
        parts = [torch.zeros_like(buf) for _ in range(self.n_parts)]
        dist.all_gather(parts, buf)
        return self._back(torch.stack(parts))

    # ---------------------------------------------------------- lockstep
    def signature(self) -> int:
        return int.from_bytes(self._sig.digest()[:7], "little")

    def verify_lockstep(self):
        """Raise unless every rank has made the same collective sequence
        (kinds, dtypes and shapes) so far. Not counted."""
        dev = self.device if self.backend == "nccl" else "cpu"
        mine = torch.tensor([self.signature()], dtype=torch.int64, device=dev)
        parts = [torch.zeros_like(mine) for _ in range(self.n_parts)]
        dist.all_gather(parts, mine)
        sigs = [int(p) for p in parts]
        if len(set(sigs)) != 1:
            raise RuntimeError(f"ranks made different collective sequences: {sigs}")


def rank_calls(comm, calls) -> List:
    """Run several rank functions in one launch: [fn(comm, *args) for
    (fn, args) in calls], in order, on every rank."""
    return [fn(comm, *args) for fn, args in calls]


def rank_probe(comm, fail=None, hang=None) -> int:
    """A rank function that checks the launcher: rank `fail` raises, rank
    `hang` never returns, every other rank returns the psum of the ranks."""
    if comm.rank == fail:
        raise RuntimeError(f"rank {fail} fails on purpose")
    if comm.rank == hang:
        while True:
            time.sleep(1.0)
    return int(comm.psum(torch.tensor([comm.rank]))[0])


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def check_backend(backend: str, device: torch.device, n_parts: int):
    """Raise unless `backend` can run n_parts ranks on `device`: nccl needs
    CUDA and a card per rank; nothing switches backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA devices")
        n_cards = torch.cuda.device_count()
        if n_parts > n_cards:
            raise ValueError(
                f"backend 'nccl' needs one card per rank: {n_parts} ranks, {n_cards} "
                "card(s) (NCCL refuses two ranks on one card as a duplicate GPU); "
                "use backend='gloo' to run several ranks on one card")


def launch(fn, n_parts: int, backend: str, device, deadline_s: float = 120.0,
           args: tuple = ()) -> List:
    """Run fn(comm, *args) on n_parts ranks; returns each rank's result.

    fn must be a module-level function of the port (the ranks import it by
    name). device: the ranks' device ("cpu", or "cuda"/"cuda:k" — with nccl
    rank r takes cuda:r). A rank that raises, or a run that outlives
    deadline_s, kills every rank and raises here."""
    device = torch.device(device)
    check_backend(backend, device, n_parts)
    tmp = tempfile.mkdtemp(prefix="ff_ranks_")
    procs = []
    try:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"fn": fn, "args": args, "n_parts": n_parts, "backend": backend,
                         "device": str(device), "store": os.path.join(tmp, "store"),
                         "timeout": float(deadline_s)}, f, protocol=pickle.HIGHEST_PROTOCOL)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env["OMP_NUM_THREADS"] = "1"
        for r in range(n_parts):
            log = open(os.path.join(tmp, f"rank{r}.log"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _RANK_ENTRY, spec, str(r)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=root), log))
        t_end = time.monotonic() + deadline_s
        while True:
            codes = [p.poll() for p, _ in procs]
            if any(c not in (None, 0) for c in codes):
                # the others may fail on the broken connection: give them a
                # moment, then report every failed rank's log
                time.sleep(0.5)
                codes = [p.poll() for p, _ in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                raise RuntimeError(f"ranks {bad} failed (exits {[codes[r] for r in bad]}):\n"
                                   + "\n".join(f"--- rank {r}:\n" + _tail(tmp, r) for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                late = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {late} still running after {deadline_s} s "
                                   "(a hang or a rank divergence):\n" + _tail(tmp, late[0]))
            time.sleep(0.02)
        out = []
        for r in range(n_parts):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _tail(tmp: str, r: int, n: int = 4000) -> str:
    try:
        with open(os.path.join(tmp, f"rank{r}.log"), "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def _rank_main(spec_path: str, rank: int):
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    n, backend = spec["n_parts"], spec["backend"]
    device = torch.device(spec["device"])
    if backend == "nccl":
        device = torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + spec["store"], rank=rank,
                            world_size=n, timeout=timedelta(seconds=spec["timeout"]))
    try:
        comm = Comm(rank, n, backend, device)
        res = spec["fn"](comm, *spec["args"])
        with open(os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl.part"), "wb") as f:
            pickle.dump(res, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl.part"),
                   os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_process():
    """The body of one rank's interpreter (`_RANK_ENTRY`)."""
    try:
        _rank_main(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


_RANK_ENTRY = "from firefoam_torch.parallel.comm import _rank_process; _rank_process()"
