"""``evaluate_exact(pos, edges, config=EvalConfig(...), mesh=mesh)`` on a
fresh layout per call over ``ranks`` ranks of one host, from a pool of
``pool`` layouts drawn from the seed.

Rank 0 is the process that runs the window (the harness's, whose
profiler traces only itself), on ``cuda:0``; ranks 1 .. ``ranks - 1``
are processes started first thing in set-up, one per card (NCCL), or on
the CPU over gloo where the device is the CPU (tests), so that they make
their inputs while rank 0 builds the kernels and makes its own.  Every
rank makes the same inputs from the seed (those of
:mod:`bench.calls.evaluate_exact`), joins the group, and calls
``evaluate_exact`` on ``layouts[i % pool]`` for ``i = 0, 1, 2, ...``:
the program's own collectives keep the ranks in step, and no message of
the benchmark passes between them while the window runs.  The ranks
join only once rank 0 has built the kernels, so none of them races
``nvcc``.

To stop, rank 0 tells each rank the index of a last call, waits until
each has read it, and makes that call itself; every rank stops after
it.  A rank is at most one call ahead of rank 0 (it cannot finish a call
without rank 0's part of its collectives), so none has passed that
index.  A rank whose rank 0 is gone (its standard input closed) exits at
once; every process group waits at most :data:`TIMEOUT_S` on a
collective; a failed set-up on any rank ends the run with an error and
stops every rank process.
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import torch

from bench.calls.evaluate_exact import Call as ExactCall

ROOT = Path(__file__).resolve().parents[2]
# seconds a rank waits on a collective, or rank 0 on a rank, before the
# run fails
TIMEOUT_S = 60
# the kernels the exact path launches: built once, before the ranks join
SOURCES = ("occlusion_pairs", "crossing_angle_sum")
RANK_MAIN = ("import sys; from bench.calls import evaluate_exact_mesh as m; "
             "sys.exit(m.rank_main(sys.argv[1]))")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(spec, rank):
    """This rank's device: its own card (made current), or the CPU."""
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    return dev


def _join(spec, rank):
    """This rank's :class:`~repro_torch.distributed.compat.Mesh` over a
    new default process group of every rank: NCCL with one card a rank,
    gloo on the CPU."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import make_mesh

    dev = _device(spec, rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=spec["ranks"],
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return make_mesh((spec["ranks"],), ("rows",), device=dev)


def _leave():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_pairs():
    """The pair slots (a tile's ``TILE ** 2``) that this process's
    row-range launches of kernels 4 and 2 have swept so far, from their
    ``TILES`` counters; ``None`` where the program counts no tiles."""
    from repro_torch.kernels import crossing_angle_sum as k4
    from repro_torch.kernels import occlusion_pairs as k2
    rows4 = getattr(k4, "crossing_angle_stats_rows", None)
    if not (hasattr(rows4, "TILES")
            and hasattr(k2.occlusion_pairs_rows, "TILES")):
        return None
    return (rows4.TILES * k4.TILE ** 2,
            k2.occlusion_pairs_rows.TILES * k2.TILE ** 2)


class Call(ExactCall):
    """Rank 0 of the cell; inputs, check and control as
    :class:`bench.calls.evaluate_exact.Call`.  ``check`` adds to the
    work rank 0's own pair slots of one call (``rank_edge_pairs``,
    ``rank_vertex_pairs``), which ``exact4_pairs_roofline`` reads."""

    def __init__(self, config, traffic, seed, device):
        self.mesh = None
        self.ranks = []         # the rank processes, rank 1 first
        self.replies = []       # a queue of each one's lines
        self.calls = 0          # calls made in the window
        self.rank_pairs = None  # rank 0's pair slots of the warm-up call
        self.spec = dict(config=config, traffic=traffic, seed=seed,
                         device=str(device), port=_free_port(),
                         ranks=int(traffic["ranks"]))
        try:
            t = time.perf_counter()
            self._spawn()
            spawn_s = time.perf_counter() - t
            if torch.device(device).type == "cuda":
                from repro_torch.kernels import _build
                _build.build_all(SOURCES)
            build_s = time.perf_counter() - t - spawn_s
            super().__init__(config, traffic, seed, device)
        except BaseException:
            self._stop_ranks()
            raise
        self.phases.update(spawn=spawn_s, build=build_s)

    def _spawn(self):
        """Start ranks 1 .. ``ranks - 1``, each reading rank 0's lines on
        its standard input."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT)]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        for rank in range(1, self.spec["ranks"]):
            proc = subprocess.Popen(
                [sys.executable, "-c", RANK_MAIN,
                 json.dumps(dict(self.spec, rank=rank))],
                cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
            replies = queue.Queue()
            threading.Thread(target=_read_lines, args=(proc.stdout, replies),
                             daemon=True).start()
            self.ranks.append(proc)
            self.replies.append(replies)

    def warm(self):
        """Join the other ranks and make the warm-up call on every rank;
        on a failure stop every rank and raise."""
        if self.mesh is not None:
            return
        try:
            self.mesh = _join(self.spec, 0)
            self.phases.mark("ranks")
            before = _rank_pairs()
            self.metrics.evaluate_exact(self.layouts[-1], self.edges,
                                        mesh=self.mesh, **self.kw)
            after = _rank_pairs()
            if before is not None and after[0] > before[0]:
                self.rank_pairs = tuple(a - b for a, b in zip(after, before))
        except BaseException:
            self._stop_ranks()
            raise

    def __call__(self, i):
        self.warm()
        self.calls = i + 1
        pos = self.layouts[i % self.traffic["pool"]]
        return self.metrics.evaluate_exact(pos, self.edges, mesh=self.mesh,
                                           **self.kw)

    def check(self, outputs, pick):
        gaps, work = super().check(outputs, pick)
        if work is not None and self.rank_pairs is not None:
            work = dict(work, rank_edge_pairs=self.rank_pairs[0],
                        rank_vertex_pairs=self.rank_pairs[1])
        return gaps, work

    def release(self, outputs):
        """Stop the ranks after one last call and leave the group; ranks
        that never joined (no call was made) are stopped at once."""
        if self.mesh is not None:
            last = self.calls
            try:
                for proc in self.ranks:
                    proc.stdin.write(f"last {last}\n")
                    proc.stdin.flush()
                for rank, replies in enumerate(self.replies, 1):
                    reply = replies.get(timeout=TIMEOUT_S)
                    if reply != "ack":
                        raise RuntimeError(f"rank {rank} did not take the "
                                           f"last call: {reply!r}")
                self.metrics.evaluate_exact(
                    self.layouts[last % self.traffic["pool"]], self.edges,
                    mesh=self.mesh, **self.kw)
                _leave()
                codes = [proc.wait(timeout=TIMEOUT_S) for proc in self.ranks]
            except BaseException:
                self._stop_ranks()
                raise
            self._stop_ranks()
            if any(codes):
                raise RuntimeError(f"rank processes exited with {codes}")
        else:
            self._stop_ranks()
        self.metrics = None
        self.mesh = None

    def _stop_ranks(self):
        """Kill what is left of the rank processes and leave the group."""
        for proc in self.ranks:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdin.close()
        self.ranks, self.replies = [], []
        try:
            _leave()
        except Exception:  # a group that failed: nothing left to free
            traceback.print_exc()


def _read_lines(stream, replies):
    """Each line a rank prints, then ``None`` when it has closed its
    output."""
    for line in stream:
        if line.strip() == "ack":
            replies.put("ack")
    replies.put(None)


class _Last:
    """The last call's index, once rank 0 has posted it."""
    index = None
    done = False


def _listen(last):
    """Take rank 0's last index and acknowledge it; exit at once where
    rank 0 is gone before this rank has finished."""
    for line in sys.stdin:
        word, _, arg = line.partition(" ")
        if word == "last":
            last.index = int(arg)
            print("ack", flush=True)
    if not last.done:
        os._exit(1)


def rank_main(arg):
    """One rank other than 0: make the same inputs, join, then the
    warm-up call and the window's calls in step with rank 0, until its
    last call."""
    spec = json.loads(arg)
    torch.set_num_threads(1)
    last = _Last()
    threading.Thread(target=_listen, args=(last,), daemon=True).start()
    try:
        call = ExactCall(spec["config"], spec["traffic"], spec["seed"],
                         _device(spec, spec["rank"]))
        mesh = _join(spec, spec["rank"])
        evaluate, kw = call.metrics.evaluate_exact, call.kw
        evaluate(call.layouts[-1], call.edges, mesh=mesh, **kw)
        i = 0
        while True:
            evaluate(call.layouts[i % spec["traffic"]["pool"]], call.edges,
                     mesh=mesh, **kw)
            if last.index is not None and i >= last.index:
                break
            i += 1
        _leave()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    last.done = True
    return 0
