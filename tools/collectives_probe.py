#!/usr/bin/env python3
"""Which collectives a backend takes on CUDA tensors, for several
processes sharing the cards of one host: the question behind
``graphnet_tpu_torch.parallel.dryrun.backend_for``.

    python3 tools/collectives_probe.py [--nproc 2] [--backend gloo]

Spawns ``--nproc`` processes (process r on card r modulo the card
count), each calling every collective the port's layouts use on CUDA
tensors (all-reduce, broadcast, all-gather, all-gather into one tensor,
reduce-scatter, reduce-scatter of one tensor), a DDP step, an FSDP2
step and the gather of its sharded gradient (``DTensor.full_tensor``),
and checks each result's values.  Prints one JSON line: per
process, each collective's ``"ok"``, ``"wrong values"``, the error the
backend raised, or that the process ended in it (a signal), and the
torch version.  Needs a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile


def probe(rank: int, world: int, init: str, backend: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    res = {"torch": torch.__version__}
    total = float(sum(range(1, world + 1)))

    def check(name, fn):
        try:  # a probe: record what the backend refuses, and go on
            ok = fn()
            torch.cuda.synchronize(dev)
            res[name] = "ok" if ok else "wrong values"
        except Exception as e:
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"

    def mine():
        return torch.full((8,), float(rank + 1), device=dev)

    def all_reduce():
        x = mine()
        dist.all_reduce(x)
        return bool((x == total).all())

    def broadcast():
        x = mine()
        dist.broadcast(x, 0)
        return bool((x == 1.0).all())

    def all_gather():
        parts = [torch.empty(8, device=dev) for _ in range(world)]
        dist.all_gather(parts, mine())
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def all_gather_into_tensor():
        out = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(out, mine())
        return bool((out.view(world, 8)[:, 0].cpu()
                     == torch.arange(1, world + 1)).all())

    def reduce_scatter():
        out = torch.empty(8, device=dev)
        dist.reduce_scatter(out, [mine() for _ in range(world)])
        return bool((out == total).all())

    def reduce_scatter_tensor():
        out = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(out, torch.cat([mine()] * world))
        return bool((out == total).all())

    def ddp():
        m = torch.nn.Linear(4, 1, bias=False).to(dev)
        torch.nn.init.ones_(m.weight)
        d = torch.nn.parallel.DistributedDataParallel(m, device_ids=[dev.index])
        d(torch.full((1, 4), float(rank + 1), device=dev)).sum().backward()
        return bool((m.weight.grad == total / world).all())

    fsdp = {}

    def fsdp2_step():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        m = torch.nn.Linear(64, 1, bias=False).to(dev)
        torch.nn.init.ones_(m.weight)
        fully_shard(m, mesh=init_device_mesh("cuda", (world,)))
        m(torch.full((1, 64), float(rank + 1), device=dev)).sum().backward()
        fsdp["grad"] = m.weight.grad
        return bool((m.weight.grad.to_local() == total / world).all())

    def fsdp2_full_tensor():
        return bool((fsdp["grad"].full_tensor() == total / world).all())

    for fn in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
               reduce_scatter, reduce_scatter_tensor, ddp, fsdp2_step,
               fsdp2_full_tensor):
        # written before each check, so a check that ends the process
        # (a signal) is reported as the one running
        res[fn.__name__] = "running"
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
        check(fn.__name__, fn)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--init", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.rank is not None:
        probe(args.rank, args.nproc, args.init, args.backend, args.out)
        return 0
    tmp = tempfile.mkdtemp(prefix="collectives_")
    init, out = f"file://{tmp}/store", os.path.join(tmp, "result")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--nproc", str(args.nproc), "--backend",
         args.backend, "--rank", str(r), "--init", init, "--out", out])
        for r in range(args.nproc)]
    for p in procs:
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
    result = {"backend": args.backend, "nproc": args.nproc,
              "rcs": [p.returncode for p in procs]}
    for r, p in enumerate(procs):
        with open(f"{out}.{r}") as f:
            res = json.load(f)
        for name, v in res.items():
            if v == "running":
                res[name] = f"process ended (exit code {p.returncode})"
        result[f"rank{r}"] = res
    print(json.dumps(result))
    return 0 if all(rc == 0 for rc in result["rcs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
