"""Run a function on several ranks of one gloo group, each rank a process
of its own: the stand-in for torchrun of the CPU tests, the tools and
`chip_smoke.py` (which also runs it with every rank on one card).

    results = spawn("package.module:function", world=2, payload=path)
    ranks = Ranks("package.module:function", 2, path)   # started; ...
    results = ranks.results()                            # ... collected later

Rank r runs `function(r, world, payload)` once the group has formed, in a
child `python -m miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch`
with one intra-op thread; the group's store is a FileStore in a temporary
directory (no TCP port, so concurrent runs do not collide). What each rank
returns comes back through `torch.save`, in rank order. A rank that fails
or a run that outlasts `timeout` stops every rank and raises with the
end of each rank's output.
"""
from __future__ import annotations

import importlib
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[2]


class Ranks:
    """`world` ranks running `target` ("module:function"), started at
    construction; `results()` waits for them, `close()` stops them. `paths`
    go before the repository on the ranks' module path (a test's helper
    module, say)."""

    def __init__(self, target: str, world: int, payload=None, *, paths=(),
                 threads: int = 1):
        self.target, self.world = target, world
        self._tmp = tempfile.TemporaryDirectory(prefix="cadis_ranks_")
        self.dir = pathlib.Path(self._tmp.name)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads), PYTHONPATH=os.pathsep.join(
            [str(p) for p in paths] + [str(ROOT)]
            + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(var, None)
        self.procs, self._logs = [], []
        try:
            for rank in range(world):
                log = open(self.dir / f"rank{rank}.log", "w")
                self._logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, target, str(rank), str(world),
                     str(self.dir / "store"), str(payload),
                     str(self.dir / f"rank{rank}.pt"), str(threads)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop every rank still running and remove the ranks' files."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self._logs:
            log.close()
        self._tmp.cleanup()

    def results(self, timeout: float = 120.0) -> list:
        """What each rank returned, in rank order. A rank that fails, or
        ranks that outlast `timeout`, stop every rank and raise with the
        end of each rank's output."""
        try:
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            codes = [p.returncode for p in self.procs]
            if any(codes):
                tails = "\n".join(f"--- rank {r} (exit {c}):\n"
                                  + (self.dir / f"rank{r}.log").read_text()[-4000:]
                                  for r, c in enumerate(codes))
                raise RuntimeError(f"{self.target} on {self.world} ranks failed or "
                                   f"timed out ({timeout} s):\n{tails}")
            return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                    for r in range(self.world)]
        finally:
            self.close()


def spawn(target: str, world: int, payload=None, *, timeout: float = 120.0,
          paths=(), threads: int = 1) -> list:
    """Run `target` ("module:function") on `world` ranks and wait: what
    each rank returned (`Ranks`)."""
    return Ranks(target, world, payload, paths=paths, threads=threads).results(timeout)


def _rank_main(argv) -> None:
    target, rank, world, store, payload, out, threads = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(int(threads))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(
            rank, world, None if payload == "None" else payload)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
