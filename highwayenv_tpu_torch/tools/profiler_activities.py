"""torch.profiler recording the host's and the device's activity against the device's alone, on a CUDA card.

Usage (from the repo root, on a machine with a CUDA card):

    python3 highwayenv_tpu_torch/tools/profiler_activities.py

For the plain versions of K3 and K1 (highway-v0), of K5's step and of its
reset warm-up (intersection-v0), B=4096, on the scenes of
``chip_smoke.py``, and for an eager and a captured intersection-v0
autoreset step, the script profiles one call (two steps) once with
``ProfilerActivity.CPU`` and ``ProfilerActivity.CUDA`` and once with
``ProfilerActivity.CUDA`` alone, in both orders, after one warm-up, and
prints the summed self device time of the kernels, the kernels counted and
the wall time of the profiled run with the profiler's processing.  It shows
whether ``chip_smoke.device_ms`` may record the device's activity alone.
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
import highwayenv_tpu_torch as ht  # noqa: E402
from highwayenv_tpu_torch.ops import _build  # noqa: E402
from highwayenv_tpu_torch.ops import general_frames as gf  # noqa: E402
from highwayenv_tpu_torch.ops import straight_frames as sf  # noqa: E402
from highwayenv_tpu_torch.ops import straight_sorted as ss  # noqa: E402
from highwayenv_tpu_torch.parallel.rollout import random_actions  # noqa: E402

B = 4096
BOTH = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
DEVICE = (ProfilerActivity.CUDA,)


def profiled(fn, reps: int, activities) -> tuple[float, float, float]:
    """(device ms, kernels) per call of ``fn`` over ``reps`` profiled calls
    after one warm-up, and the seconds the profiled calls and the
    profiler's processing took."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=list(activities)) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
            sum(e.count for e in kernels) / reps, time.perf_counter() - t0)


def cases() -> dict:
    """{label: (function, calls profiled)}."""
    henv = ht.make("highway-v0")
    gen = henv.generator(0)
    _, hs = henv.reset(B, gen)
    fs, p, dt, frames = henv._straight, henv.idm_params, henv.dt, henv.frames_per_step
    sa = henv._action_to_slots(random_actions(henv, B, gen))
    veh = henv.action_type.apply(henv.geo, hs.vehicles, hs.vehicles.kind == 1, sa)
    srt, idx = ss.sort_plain(veh, fs)
    ienv = ht.make("intersection-v0")
    _, i0 = ienv.reset(B, ienv.generator(1))
    scene = cs.regulated_scenes(ienv, i0, ienv.generator(2), steps_in=False)

    def regulated(name):
        rveh, steps0, rsa, rframes = scene[name]
        return lambda: gf.frames_general_plain(rveh, ienv._general, rsa, rframes, steps0)

    return {
        "K3 plain": (lambda: ss.frames_sorted_plain(srt, idx, fs, p, dt, frames), 1),
        "K1 plain": (lambda: sf.frames_plain(veh, fs, p, dt, frames), 1),
        "K5 step plain": (regulated("reset"), 1),
        "K5 warm-up plain": (regulated("warm-up"), 1),
        "intersection-v0 eager step": (cs.stepper(ienv, i0, ienv.generator(3), None, False), 2),
        "intersection-v0 graph step": (cs.stepper(ienv, i0, ienv.generator(4), None, True), 2),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_activities: no CUDA card", file=sys.stderr)
        return 1
    _build.build(["straight_frames", "straight_sort", "straight_frames_sorted",
                  "general_frames"])
    print(cs.card_line(), flush=True)
    for label, (fn, reps) in cases().items():
        out = []
        for order in ((BOTH, DEVICE), (DEVICE, BOTH)):
            for activities in order:
                ms, n, wall = profiled(fn, reps, activities)
                name = "host and device" if activities is BOTH else "device alone"
                out.append(f"{name}: {ms:.4f} ms, {n:.1f} kernels, recorded in {wall:.2f} s")
        print(f"{label}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
