#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, on one card.

    python3 scripts/gloo_cuda_collectives.py

Four ranks (spawned processes, one gloo group over a TCPStore on
127.0.0.1), every tensor on cuda:0.  Each collective is called two ways:
through ``torch.distributed`` (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast``) and
through the functional collectives DTensor uses
(``torch.distributed._functional_collectives``: ``all_reduce``,
``all_gather_tensor``, ``reduce_scatter_tensor``, each waited on), each
call in a fresh group of ranks so that one that kills its ranks does not
hide the others.  Prints one line per call: ok, the error, or the ranks'
exit codes; then the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import subprocess
import sys
import time
from pathlib import Path

WORLD = 4
CALLS = ("dist.all_reduce", "dist.all_gather_into_tensor",
         "dist.reduce_scatter_tensor", "dist.all_to_all_single",
         "dist.broadcast", "funcol.all_reduce", "funcol.all_gather_tensor",
         "funcol.reduce_scatter_tensor")


def rank_main(rank: int, port: int, call: str, out) -> None:
    import traceback
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed import _functional_collectives as funcol
        torch.cuda.set_device(0)
        store = dist.TCPStore("127.0.0.1", port, WORLD, is_master=False)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        d = torch.device("cuda", 0)
        x = torch.arange(8, dtype=torch.float32, device=d) + rank
        group = dist.group.WORLD
        fns = {
            "dist.all_reduce": lambda: dist.all_reduce(x.clone()),
            "dist.all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8 * WORLD, device=d), x),
            "dist.reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // WORLD, device=d), x),
            "dist.all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty(8, device=d), x),
            "dist.broadcast": lambda: dist.broadcast(x.clone(), 0),
            "funcol.all_reduce": lambda: funcol.wait_tensor(
                funcol.all_reduce(x, "sum", group)),
            "funcol.all_gather_tensor": lambda: funcol.wait_tensor(
                funcol.all_gather_tensor(x, 0, group)),
            "funcol.reduce_scatter_tensor": lambda: funcol.wait_tensor(
                funcol.reduce_scatter_tensor(x, "sum", 0, group)),
        }
        try:
            fns[call]()
            torch.cuda.synchronize()
            res = "ok"
        except Exception as e:  # noqa: BLE001 — the finding is the error
            res = f"{type(e).__name__}: {str(e)[:200]}"
        out.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "set-up failed: " + traceback.format_exc()[-500:]))


def run(call: str, limit_s: float = 60.0) -> str:
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, None, True, wait_for_workers=False)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, store.port, call, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got, t0 = {}, time.time()
    try:
        while len(got) < WORLD and time.time() - t0 < limit_s:
            try:
                r, res = out.get(timeout=1)
                got[r] = res
            except queue.Empty:
                if all(p.exitcode is not None for p in procs):
                    break
        for p in procs:
            p.join(timeout=10)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    if len(got) < WORLD:
        return ("ranks died or hung: exit codes "
                f"{[p.exitcode for p in procs]}")
    return "; ".join(sorted({res for res in got.values()}))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for call in CALLS:
        print(f"{call}: {run(call)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, cwd=str(Path(__file__).parent))
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
