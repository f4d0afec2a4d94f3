"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain versions.

Run from the repo root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain torch version at highway-fast-v0
     (V=21, 5 frames) and highway-v0 full width (V=51, 15 frames), B=4096,
     on three scenes: discrete fields exactly equal, continuous fields
     within the stated tolerance; then the kernel path of the highway-v0
     autoreset step against the plain reference path;
  4. the main path: make("highway-v0") on CUDA, reset B=4096 and a random
     policy rollout with autoreset, launch counts checked;
  5. times on the card: kernel, plain version, bound, whole rollout, and a
     profile of rollout steps (device kernels by name, device busy share).

Exits non-zero on any failed check, and without CUDA.  The last lines are
the kernels JSON, the card line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 4096  # envs, the batch the JAX package's bench drives
HORIZON = 32  # policy steps of the main-path rollout
CRASH_HORIZON = 4  # policy steps of the extra rollout from a compressed scene
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_OPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# Tolerances of kernel against plain, the same as the CPU tests hold the
# plain version to the JAX package: pos absolute 2e-4 m; other continuous
# fields 1e-4 times the field's magnitude.  The kernel is built without FMA
# contraction, so it is expected to agree far inside them.
POS_ATOL = 2e-4
REL_TOL = 1e-4
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending")
CONTINUOUS = ("pos", "heading", "speed", "timer", "impact", "steering", "accel")

# float32 operations per unit of frame work, counted from the frame's
# arithmetic (ops/straight_frames.py, csrc/straight_frames.cu); a libm call
# counts as one operation.  Used for the bound only.
OPS_SLOT = 160  # per live slot: projection, own IDM, steering, integration
OPS_NEIGH_PAIR = 9  # per (slot, occupiable other): 3 lanes x (sub, abs, cmp)
OPS_DECIDING = 274  # per MOBIL-deciding slot: 8 more IDM + incentive tests
OPS_ABORT_PAIR = 13  # per (lane-changing IDM slot, other slot)
OPS_SPHERE = 11  # per collision-eligible unordered pair
OPS_SAT = 210  # per pair within reach: the folded swept SAT


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scenes(veh):
    """normal / compressed (x * 0.2: immediate collisions) / pile-up (20
    vehicles in 6 m), as tests/test_batched_step.py builds them."""
    compressed = veh.pos.clone()
    compressed[..., 0] *= 0.2
    pileup = veh.pos.clone()
    pileup[:, :20, 0] = 100.0 + torch.linspace(0, 6, 20, device=pileup.device)
    return {
        "normal": veh,
        "compressed": veh.replace(pos=compressed),
        "pileup": veh.replace(pos=pileup),
    }


def compare(a, b, where: str) -> float:
    """Discrete fields equal, continuous within tolerance; returns the max
    absolute error over the continuous fields."""
    for name in DISCRETE:
        x, y = getattr(a, name), getattr(b, name)
        n_bad = int((x != y).sum())
        if n_bad:
            raise AssertionError(f"{where}: {name} differs in {n_bad} entries")
    worst = 0.0
    for name in CONTINUOUS:
        x, y = getattr(a, name), getattr(b, name)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{where}: {name} has non-finite values")
        err = float((x.double() - y.double()).abs().max())
        tol = POS_ATOL if name == "pos" else REL_TOL * max(
            1.0, float(y.abs().max())
        )
        print(f"  {where} {name}: max |kernel - plain| = {err:.3e} (tol {tol:.1e})")
        if err > tol:
            raise AssertionError(f"{where}: {name} error {err} > {tol}")
        worst = max(worst, err)
    return worst


def frame_ops(veh, out, fs, p, dt) -> float:
    """float32 operations one frame from ``veh`` to ``out`` needs."""
    from highwayenv_tpu_torch.vehicle.state import KIND_IDM

    live = veh.kind != 0
    px, py = veh.pos[..., 0], veh.pos[..., 1]
    s = (px - float(fs.origin[0])) * float(fs.u[0]) + (
        py - float(fs.origin[1])
    ) * float(fs.u[1])
    occ = live & (s >= -5.0) & (s < fs.length + 5.0)
    n_live = live.sum(-1).double()
    n_occ = occ.sum(-1).double()
    neigh = (n_live * n_occ - (live & occ).sum(-1)).sum()
    idm = (veh.kind == KIND_IDM) & ~veh.crashed
    mid = veh.lane != veh.target_lane
    deciding = (
        idm & ~mid & (veh.timer > p.lane_change_delay) & veh.enable_lane_change
    ).sum()
    aborting = (idm & mid).sum() * veh.kind.shape[1]
    V = veh.kind.shape[1]
    upper = torch.triu(torch.ones(V, V, dtype=torch.bool, device=s.device), 1)
    chk, coll = veh.check_collisions, veh.collidable
    elig = (
        upper & live[:, :, None] & live[:, None, :]
        & (chk[:, :, None] | chk[:, None, :])
        & coll[:, :, None] & coll[:, None, :]
    )
    d = out.pos[:, :, None, :] - out.pos[:, None, :, :]
    diag = torch.sqrt(out.length**2 + out.width**2)
    reach = (diag[:, :, None] + diag[:, None, :]) / 2 + out.speed[:, :, None] * dt
    near = elig & ((d * d).sum(-1) <= reach * reach)
    return float(
        OPS_SLOT * n_live.sum() + OPS_NEIGH_PAIR * neigh
        + OPS_DECIDING * deciding + OPS_ABORT_PAIR * aborting
        + OPS_SPHERE * elig.sum() + OPS_SAT * near.sum()
    )


def profile_rollout(env, states, gen, steps: int = 4) -> None:
    """Where a rollout step's time goes: device kernels by name and the
    device's busy share of the wall time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from highwayenv_tpu_torch.parallel.rollout import rollout

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(env, states, steps, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"  profile of {steps} rollout steps: wall {wall_us / steps:.1f} us per "
          f"step, device busy {busy_us / steps:.1f} us per step "
          f"({100 * busy_us / wall_us:.1f}%), {launches / steps:.1f} device "
          "kernels per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / steps:10.1f} us/step "
              f"{e.count / steps:6.1f}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import _build, straight_frames
    from highwayenv_tpu_torch.parallel.rollout import rollout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("== 1. device")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    print("== 2. build")
    t0 = time.time()
    paths = _build.build(["straight_frames"])
    print(f"built {[p.name for p in paths.values()]} in {time.time() - t0:.1f} s")
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    kernel = straight_frames.frames_kernel
    max_err = 0.0
    # highway-fast-v0 (V=21, 5 frames) runs the same kernel; the main path
    # is highway-v0, checked last so its env and states carry on below
    for env_id in ("highway-fast-v0", "highway-v0"):
        env = ht.make(env_id)
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        print(f"== 3. kernel vs plain: {env_id} V={env.num_slots}, {frames} frames, B={B}")
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        actions = torch.randint(0, env.action_type.n, (B,), generator=gen,
                                device=env.device, dtype=torch.int32)
        for name, veh in scenes(states.vehicles).items():
            veh = env.action_type.apply(
                env.geo, veh, veh.kind == 1, env._action_to_slots(actions)
            )
            out_k = kernel(veh, fs, p, dt, frames)
            out_p = straight_frames.frames_plain(veh, fs, p, dt, frames)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(out_k, out_p, f"{env_id} {name}"))
            print(f"  {env_id} {name}: crashed slots {int(out_k.crashed.sum())}, "
                  f"pending impacts {int(out_k.impact_pending.sum())}")
    # the whole autoreset step: kernel path against the plain reference path
    st_k = st_p = states
    for t in range(3):
        acts = torch.randint(0, env.action_type.n, (B,), generator=gen,
                             device=env.device, dtype=torch.int32)
        g_k, g_p = env.generator(100 + t), env.generator(100 + t)
        obs_k, st_k, r_k, te_k, tr_k, _ = env.step_autoreset_batched(st_k, acts, g_k)
        obs_p, st_p, r_p, te_p, tr_p, _ = env.step_autoreset(st_p, acts, g_p)
        compare(st_k.vehicles, st_p.vehicles, f"step {t}")
        if not (torch.equal(te_k, te_p) and torch.equal(tr_k, tr_p)):
            raise AssertionError(f"step {t}: terminated / truncated differ")
        obs_err = float((obs_k - obs_p).abs().max())
        rew_err = float((r_k - r_p).abs().max())
        print(f"  step {t}: obs err {obs_err:.3e}, reward err {rew_err:.3e}")
        if obs_err > 1e-4 or rew_err > 1e-4:
            raise AssertionError(f"step {t}: obs / reward disagree")

    print(f"== 4. main path: make('highway-v0') on CUDA, B={B}, "
          f"{HORIZON} + {CRASH_HORIZON} autoreset steps")
    gen = env.generator(SEED + 1)
    _, states = env.reset(B, gen)
    _, crash_states = env.reset(B, gen)
    crash_states = crash_states.replace(
        vehicles=scenes(crash_states.vehicles)["compressed"]
    )
    kernel.launches = 0
    states, metrics = rollout(env, states, HORIZON, gen)
    _, crash_metrics = rollout(env, crash_states, CRASH_HORIZON, gen)
    torch.cuda.synchronize()
    launches = kernel.launches
    if launches != HORIZON + CRASH_HORIZON:
        raise AssertionError(
            f"straight_frames launched {launches} times, expected "
            f"{HORIZON + CRASH_HORIZON} (one per policy step)"
        )
    m = {k: float(v) for k, v in metrics.items()}
    mc = {k: float(v) for k, v in crash_metrics.items()}
    print(f"  rollout: {m}")
    print(f"  compressed-scene rollout: {mc}")
    for name, t in [("pos", states.vehicles.pos), ("speed", states.vehicles.speed)]:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path: non-finite {name}")
    if not all(np.isfinite(list(m.values()) + list(mc.values()))):
        raise AssertionError("main path: non-finite metrics")
    if not (m["done_rate"] > 0 or mc["done_rate"] > 0):
        raise AssertionError("main path: no episode ended")
    if not 0.0 <= m["mean_reward"] <= 1.0:
        raise AssertionError("main path: normalized reward out of [0, 1]")

    print(f"== 5. times on {card}")
    gen = env.generator(SEED + 2)
    _, states = env.reset(B, gen)
    veh = env.action_type.apply(
        env.geo, states.vehicles, states.vehicles.kind == 1,
        env._action_to_slots(torch.ones(B, dtype=torch.int32, device=env.device)),
    )
    ms = cuda_ms(lambda: kernel(veh, fs, p, dt, frames), 20)
    plain_ms = cuda_ms(lambda: straight_frames.frames_plain(veh, fs, p, dt, frames), 3)
    # bound: this input's work, frame by frame through the plain version
    ops, v = 0.0, veh
    for _ in range(frames):
        out = straight_frames.frames_plain(v, fs, p, dt, 1)
        ops += frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = sum(
        getattr(veh, name).numel() * getattr(veh, name).element_size()
        for name, _, _ in straight_frames._IN_FIELDS + straight_frames._OUT_FIELDS
    )
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"  straight_frames: {ms:.4f} ms per policy step; plain {plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.4f} ms)")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(env, states, HORIZON, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for wall in walls:
        print(f"  rollout: {HORIZON} steps x {B} envs in {wall:.4f} s = "
              f"{HORIZON * B / wall:.1f} env-steps/s ({wall / HORIZON * 1e3:.4f} ms "
              f"per step, of which the kernel ~{ms:.4f} ms)")
    profile_rollout(env, states, gen)

    print(json.dumps({"kernels": [{
        "name": "straight_frames",
        "route": "cuda",
        "source": "highwayenv_tpu_torch/csrc/straight_frames.cu",
        "replaces": "highwayenv_tpu/ops/straight_pallas_bm.py:1190",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
