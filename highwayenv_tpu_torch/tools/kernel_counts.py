"""Device kernels, device busy time and wall time per rollout step of highway-v0 (sorted and dense) and intersection-v0 on a CUDA card.

Usage (from the repo root, on a machine with a CUDA card):

    python3 highwayenv_tpu_torch/tools/kernel_counts.py [TREE ...]

Each TREE (default ``.``) is the root of a checkout of this repo, for
example an older commit unpacked with ``git archive`` into ``build/``; each
is run in a process of its own, so their packages do not mix; name the
trees in turns (parent, change, change, parent) to compare two commits on
one card.  Per tree, env variant and repetition the script prints the
device kernels and the device busy time per step that torch.profiler
records over a 4-step random-policy rollout of 4096 envs, and the wall
time per step and env-steps/s of a 32-step rollout timed on the host
clock to a synchronize, without the profiler.  Two repetitions per
variant show when the profiler dropped events, which it sometimes does:
a dropped event lowers one reading, never raises it.  A tree whose
package has no intersection-v0 skips that variant.
"""

from __future__ import annotations

import subprocess
import sys
import time

STEPS = 4
TIMED_STEPS = 32
BATCH = 4096
#: (label, env id, make keyword arguments)
VARIANTS = (
    ("highway-v0 sorted", "highway-v0", {"sorted_frames": True}),
    ("highway-v0 dense", "highway-v0", {"sorted_frames": False}),
    ("intersection-v0", "intersection-v0", {}),
)


def count(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.parallel.rollout import rollout

    print(f"tree {tree}: {ht.__file__}")
    for which, env_id, kwargs in VARIANTS:
        if env_id not in ht.registered_ids():
            continue
        env = ht.make(env_id, **kwargs)
        gen = env.generator(0)
        _, states = env.reset(BATCH, gen)
        states, _ = rollout(env, states, 2, gen)  # builds and warms the kernels
        torch.cuda.synchronize()
        for rep in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                rollout(env, states, STEPS, gen)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            n = sum(e.count for e in kernels)
            busy_us = sum(e.self_device_time_total for e in kernels) / STEPS
            t0 = time.perf_counter()
            rollout(env, states, TIMED_STEPS, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / TIMED_STEPS
            print(f"  {which} step, repetition {rep}: {n / STEPS} device kernels per step, "
                  f"device busy {busy_us:.1f} us per step; {TIMED_STEPS} steps at "
                  f"{wall * 1e3:.4f} ms per step, {BATCH / wall:.1f} env-steps/s "
                  f"(busy share {busy_us / (wall * 1e6):.3f})")


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--tree":
        count(argv[1])
        return 0
    for tree in argv or ["."]:
        subprocess.run([sys.executable, __file__, "--tree", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
