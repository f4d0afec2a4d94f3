"""A sharded random-policy rollout over several processes joined by torch.distributed.

Counterpart of the JAX package's ``scripts/multihost_rollout.py``.  Usage
(from the repo root):

    python3 highwayenv_tpu_torch/tools/multiproc_rollout.py \\
        --processes 2 --shards 2 --device cpu \\
        --env highway-fast-v0 --config '{"vehicles_count": 5, "lanes_count": 2}' \\
        --batch 8 --horizon 4

It starts ``--processes`` W worker processes that join one process group
(gloo for ``--device cpu``; NCCL for ``--device cuda``, one card each:
process r on card r) through ``--init`` (default ``tcp://127.0.0.1`` on a
free port; a ``file://`` path works too).  Each holds ``--shards`` shards
(on the CPU, or all on its card), so the mesh has S = W x shards; it resets
its own shards from their generators (``sharding.shard_generators``: global
shard s from the seed and s) and runs ``sharding.sharded_rollout_fn``.  Each
rank prints one line:

    rank=R world=W shards=S mean_reward=... done_rate=... obs_checksum=... statehash=...

with the metrics (float64, printed exactly) and a sha256 over every field
of the final state gathered from every rank in global row order.  The same
seed, batch and S under another split (2 x 2 against 1 x 4) gives the same
line but for the rank and world: the layout-invariance check
(``tests/test_torch_sharding.py``).  The launcher exits non-zero when a
worker fails or the ranks disagree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import re
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
LINE = re.compile(r"^rank=(\d+) world=\d+ (shards=.*)$")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--shards", type=int, default=1, help="shards a process")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--env", default="highway-fast-v0")
    p.add_argument("--config", default=None, help="env config overrides, as JSON")
    p.add_argument("--batch", type=int, default=8, help="envs over the whole mesh")
    p.add_argument("--horizon", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fresh-pool", type=int, default=None)
    p.add_argument("--compact-reset", type=int, default=None)
    p.add_argument("--graph", action="store_true")
    p.add_argument("--init", default=None, help="the process group's init method")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the workers")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def state_hash(states) -> str:
    """sha256 over every field of an EnvState, in field order, names
    included."""
    from highwayenv_tpu_torch.bridge import to_numpy_state

    d = to_numpy_state(states)
    h = hashlib.sha256()
    for name, value in list(d["vehicles"].items()) + [(k, v) for k, v in d.items()
                                                      if k != "vehicles"]:
        h.update(name.encode())
        h.update(value.tobytes())
    return h.hexdigest()


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.parallel import sharding

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
        dev = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=args.init,
                            world_size=args.processes, rank=args.rank)
    try:
        mesh = sharding.make_mesh([dev] * args.shards)
        if args.batch % mesh.num_shards:
            raise ValueError(f"--batch {args.batch} does not split over {mesh.num_shards} "
                             "shards")
        env = ht.make(args.env, json.loads(args.config) if args.config else None, device=dev)
        gens = sharding.shard_generators(args.seed, mesh)
        b = args.batch // mesh.num_shards
        shards = [e.reset(b, g)[1]
                  for e, g in zip(sharding.shard_envs(env, mesh), gens)]
        rollout = sharding.sharded_rollout_fn(
            env, mesh, args.horizon, fresh_pool=args.fresh_pool,
            compact_reset=args.compact_reset, graph=args.graph)
        shards, metrics = rollout(shards, gens)
        digest = state_hash(sharding.gather_batch(shards, mesh, device="cpu"))
        print(f"rank={mesh.rank} world={mesh.world_size} shards={mesh.num_shards} "
              + " ".join(f"{k}={float(v)!r}" for k, v in metrics.items())
              + f" statehash={digest}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv: list[str]) -> int:
    """Start the workers (the launcher's arguments, then the init method
    and the rank, which argparse takes last), relay their output, and check
    that every rank printed the same line (but for its rank)."""
    init = args.init or f"tcp://127.0.0.1:{free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "highwayenv_tpu_torch.tools.multiproc_rollout",
             *argv, f"--init={init}", f"--rank={rank}"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(args.processes)
    ]
    lines, ok = {}, True
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=args.timeout)
            sys.stdout.write(out)
            ok &= proc.returncode == 0
            for line in out.splitlines():
                m = LINE.match(line)
                if m:
                    lines[int(m.group(1))] = m.group(2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    agree = len(lines) == args.processes and len(set(lines.values())) == 1
    print(f"multiproc_rollout: {args.processes} processes x {args.shards} shards, "
          f"{'ranks agree' if agree else 'RANKS DISAGREE OR FAILED'}", flush=True)
    return 0 if ok and agree else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.rank is not None:
        worker(args)
        return 0
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())
