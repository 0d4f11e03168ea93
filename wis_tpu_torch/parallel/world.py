"""A ``torch.distributed`` world of local processes, one per rank.

``run_world(fn, devices, args)`` starts ``len(devices)`` ranks with the
``spawn`` start method (CUDA cannot follow a ``fork``), joins them over a
``file://`` rendezvous in a fresh temporary directory (no fixed port, so
several worlds can run at once), calls ``fn(rank, devices, *args)`` in
each and returns the ranks' results in rank order. The backend follows
``mesh.choose_backend`` and is printed. A rank that raises makes
``run_world`` raise with that rank's traceback, after the other ranks are
stopped; a world that has not finished within ``timeout`` seconds is
stopped and raises ``TimeoutError``. CPU ranks run one torch thread each.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Sequence

from wis_tpu_torch.parallel.mesh import choose_backend


def _rank_main(fn, rank, devices, backend, init_file, args, results, timeout):
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device(devices[rank])
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            from wis_tpu_torch.device import resolve_device

            torch.cuda.set_device(resolve_device(dev))
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=len(devices), rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            try:
                out = (True, fn(rank, list(devices), *args))
            except BaseException:  # reported to the parent, which raises it
                out = (False, traceback.format_exc())
            # reported before the group is destroyed: with nccl that waits
            # for the peers, which a failed rank may have left in a collective
            results.put((rank, *out))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, devices: Sequence, args: tuple = (),
              timeout: float = 900.0) -> List:
    """Run ``fn(rank, devices, *args)`` on one spawned process per entry of
    ``devices`` (``"cpu"``, ``"cuda:N"``) and return each rank's result (a
    picklable value), rank 0 first. ``fn`` must be importable by name."""
    devices = [str(d) for d in devices]
    n = len(devices)
    backend = choose_backend(devices)
    why = ("each rank has a card of its own" if backend == "nccl"
           else "ranks share a card or run on the CPU")
    print(f"world: {n} ranks on {devices}, backend {backend} ({why})", flush=True)
    tmp = tempfile.mkdtemp(prefix="wis_world_")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, r, devices, backend, f"{tmp}/rendezvous", tuple(args),
                          results, timeout))
        for r in range(n)
    ]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        # a last result may still be in flight from a
                        # rank that just exited
                        try:
                            rank, ok, value = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"rank {r} exited with code {p.exitcode} without a result"
                            ) from None
                        break
                else:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"world of {n} ranks still running after "
                                           f"{timeout:.0f} s")
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
