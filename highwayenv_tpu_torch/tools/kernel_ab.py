"""A/B of the frame kernels: two ``csrc/`` trees on one card.

Usage (from the repo root, on a machine with a CUDA card):

    mkdir -p build/baseline
    git archive HEAD highwayenv_tpu_torch/csrc | tar -x -C build/baseline
    python3 highwayenv_tpu_torch/tools/kernel_ab.py [--baseline DIR] [--clocks]
        [--kernels straight straight_global objects general wide cluster global]
        [--vehicles N ...]

``--baseline`` (default ``build/baseline/highwayenv_tpu_torch/csrc``) is a
second ``csrc/`` directory, for example a commit's unpacked as above; when it
is missing only the current kernels run.  ``--kernels`` picks the families
(default all; ``--clocks`` stamps the straight, general and global ones):

  straight: K1 (``straight_frames``) and K3 (``straight_frames_sorted``) at
    highway-v0 (V=51, 15 frames), highway-fast-v0 (V=21, 5 frames) and
    highway-v0 with each ``--vehicles`` N (V = N + 1), B=4096, and at
    highway-v0 under the LinearVehicle preset (the Linear rows' branch).
    Scenes: the reset scene, the compressed scene and a pile-up in every
    env; K1 on every env and masked to every third env, K3 with its flags.
    Timed: K1 on every env, K3, K1 masked with no env firing, on the reset
    scene.
  straight_global: K1 and K3 in each layout (``straight_frames`` and
    ``straight_frames_global``, ``straight_frames_sorted`` and
    ``straight_frames_sorted_global``: one env a cluster of blocks with its
    rows in global memory), each with its tree's K2a and K2b
    (``straight_sort``), of every tree, at the straight family's scenes,
    held bit for bit to each other and timed in turns: what the rows in
    global memory and the cluster's barriers cost where one block holds
    the scene, and each tree's permutations against the other's; then the
    global layouts alone at highway-v0 with 2047 vehicles (V=2048, 4 blocks
    of 512 threads) at GLOBAL_STRAIGHT_ROWS rows.  No ``--clocks`` stamps.
  objects: K1's objects instantiations (``objects=True``: obstacle and
    landmark rows, an env made with ``lean=False``) of the current tree,
    in each layout, against its lean ones on the same vehicles-only scenes
    (the straight family's, at highway-v0 under the IDM and the
    LinearVehicle configs, B=4096, and with 2047 vehicles at
    GLOBAL_STRAIGHT_ROWS rows): equal bit for bit (with no object row the
    objects rule is the lean one, and ``hit`` stays), timed in turns (lean,
    objects, objects, lean); then each alone on the obstacle scene of
    ``tools/object_scenes.py``.  A baseline tree has no objects
    instantiation; the straight and straight_global families time its lean
    ones against the current tree's.  No ``--clocks`` stamps.
  general: K4 (``general_frames``) at roundabout-v0 (V=5, L=32, R=11),
    merge-v0 (V=6, L=9, an obstacle) and exit-v0 (V=21, L=20, 7 lanes on
    one edge, the 32-thread group) on the reset scene, 8 steps in, an
    all-env pile-up and (merge) the obstacle hit; K5
    (``general_frames_regulated``) at intersection-v0 (V=25, L=20, R=3,
    tick period 7) on the reset scene, 8 steps in with the tick phases
    spread over all 7 values, a conflict scene with yields and the reset's
    warm-up launch (V=16, 45 frames), B=4096, the scenes of chip_smoke.py.
    Timed: K4 at roundabout-v0, merge-v0 and exit-v0 on the reset scene, K5's
    step on the reset scene with spread tick phases, K5's warm-up.  Then
    the Linear rows' branch: K4 at roundabout-v0 under AggressiveVehicle
    and K5's step at intersection-v0 under DefensiveVehicle, and K5's
    raw-control branch at intersection-v0 under a ContinuousAction, each on
    the reset scene (spread tick phases on K5).  Then the ``kDynamical``
    instantiations, on the trees that have them: K5's at intersection-v1
    (reset scene, spread tick phases, a fifth of the egos crashed, a fifth
    below 1 m/s) and K4's at lane-keeping-v0 (V=1, L=3, 1 frame), each
    timed beside the v0 instantiation's raw branch on the same scene (its
    spec without the flag), which both trees run and compare.  Then the
    ``kConnected`` instantiations: K4's at roundabout-v1 and K5's at
    intersection-v2 (spread tick phases), each on the reset scene.
  wide: the wide K4 / K5 (``general_frames_wide``, one env a block) at
    exit-v0 with 50 vehicles (V=51, K4) on the reset scene, 8 steps in and
    the all-env pile-up, and at intersection-v0 with duration 30 (V=42,
    K5) on the reset scene, 8 steps in and the conflict scene, and their
    connected twins at exit-v1 and intersection-v2 alike, and the
    dynamical K5 at intersection-v1 with duration 30 on its dynamical
    scene (``dynamical_scene``), B=4096.  Timed: each on its reset scene
    (K5 with spread tick phases).
  cluster: the cluster K4 / K5 (``general_frames_cluster``, one env a
    cluster of blocks) alike at exit-v0 and exit-v1 with 150 vehicles
    (V=151, 2 blocks), intersection-v0, -v2 and -v1 at policy_frequency 15
    (V=207, 2 blocks) and racetrack-v0 with 150 NPCs under a dynamical
    ContinuousAction (V=151, K4 dynamical), B=512 (the 8-steps-in scenes
    step the plain frames, whose (B, 207, 207, 11) right-of-way tensors run
    out of the card's memory at 4096 rows).
  global: the global K4 / K5 (``general_frames_global``, one env a cluster
    of blocks with its arrays in global memory) at the cluster family's
    scenes, held bit for bit to the cluster K4 / K5 of the current tree
    (and to the baseline's global library where it has one) and timed in
    turns against it (what the arrays in global memory cost where shared
    memory holds them), then alone (or against the baseline's) at the
    scenes only it takes: exit-v0 with 100 lanes and 100 vehicles (L=302,
    V=101), exit-v0 with 2100 vehicles (V=2101, blocks of 256 threads) and
    intersection-v0 at policy_frequency 15 with duration 140 (V=2112),
    B=512 (8 at V > 2048).  With ``--clocks`` its stamps are those of
    ``general_frames.cu``'s frame loop, which the global source includes,
    thread 0 of every block.

Each scene runs the instantiation its env path launches: ``linear`` on
for the Linear scenes, off (the IDM code alone) for the others.  A tree
whose kernels read no Linear parameters (a baseline from before them, told
by its sources) is bound with its own field list and runs the scenes
without Linear rows alone.  Both trees must take the current tree's
parameter blocks and tables (those of the tables sized by the scene).

For each family the script

  1. builds both trees' sources into ``build/kernel_ab/`` with the flags of
     ``ops/_build.py`` and prints ptxas's register, stack and spill report;
  2. runs both builds on the same inputs of every scene and checks that
     every output field (and K3's flags, K5's yielding state) is equal bit
     for bit;
  3. times each kernel in turns (baseline, current, current, baseline,
     ``--rounds`` times); a turn is the mean device time of REPS launches
     queued behind a device-side wait, between CUDA events; it prints each
     build's mean and the spread (min to max) of its turns;
  4. with ``--clocks``, builds a copy of each tree with a ``clock64()``
     stamp before every phase marker of the frame loop (a ``// ---``
     comment line, the ``drive`` call, the ``stage_post(`` call) and
     prints thread 0's mean cycles per frame in each phase, over all
     blocks.  The stamps add a few instructions and registers: the split,
     not the total, is what to read.

Exits non-zero without CUDA or when the two builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

FAMILIES = {
    "straight": ("straight_frames", "straight_frames_sorted"),
    "straight_global": ("straight_frames_global", "straight_frames_sorted_global",
                        "straight_frames", "straight_frames_sorted", "straight_sort"),
    "objects": ("straight_frames", "straight_frames_global"),
    "general": ("general_frames",),
    "wide": ("general_frames_wide",),
    "cluster": ("general_frames_cluster",),
    "global": ("general_frames_global", "general_frames_cluster"),
}
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}
#: the wide and cluster families' scenes, each (env id, config, kernel)
LAYOUT_SCENES = {
    "wide": (("exit-v0", {"vehicles_count": 50}, "K4"),
             ("intersection-v0", {"duration": 30}, "K5"),
             ("exit-v1", {"vehicles_count": 50}, "K4 connected"),
             ("intersection-v2", {"duration": 30}, "K5 connected"),
             ("intersection-v1", {"duration": 30}, "K5 dynamical")),
    "cluster": (("exit-v0", {"vehicles_count": 150}, "K4"),
                ("intersection-v0", {"policy_frequency": 15}, "K5"),
                ("exit-v1", {"vehicles_count": 150}, "K4 connected"),
                ("intersection-v2", {"policy_frequency": 15}, "K5 connected"),
                ("intersection-v1", {"policy_frequency": 15}, "K5 dynamical"),
                ("racetrack-v0", {"other_vehicles": 150, **DYNAMICAL}, "K4 dynamical")),
}
#: the global family: the cluster family's scenes, then those only it takes
GLOBAL_ONLY = (("exit-v0", {"lanes_count": 100, "vehicles_count": 100}, "K4"),
               ("exit-v0", {"vehicles_count": 2100}, "K4"),
               ("intersection-v0", {"policy_frequency": 15, "duration": 140}, "K5"))
LAYOUT_SCENES["global"] = LAYOUT_SCENES["cluster"] + GLOBAL_ONLY
#: the rows of each family's scenes (the global family's past 2048 slots:
#: GLOBAL_WIDE_ROWS)
LAYOUT_ROWS = {"wide": 4096, "cluster": 512, "global": 512}
GLOBAL_WIDE_ROWS = 8
CONFIGS = (("highway-v0", None), ("highway-fast-v0", None))
NPC = "highway_env.vehicle.behavior."
LINEAR_CONFIGS = (("highway-v0", {"other_vehicles_type": NPC + "LinearVehicle"}),)
#: the general path's Linear and raw scenes, each (env id, config, kernel)
GENERAL_LINEAR = (
    ("roundabout-v0", {"other_vehicles_type": NPC + "AggressiveVehicle"}, "K4"),
    ("intersection-v0", {"other_vehicles_type": NPC + "DefensiveVehicle"}, "K5"),
    ("intersection-v0", {"action": {"type": "ContinuousAction"}}, "K5"),
)
#: the dynamical scenes, each (env id, kernel)
GENERAL_DYNAMICAL = (("intersection-v1", "K5"), ("lane-keeping-v0", "K4"))
#: the connected-lane search's scenes, each (env id, kernel)
GENERAL_CONNECTED = (("roundabout-v1", "K4 connected"), ("intersection-v2", "K5 connected"))
#: the fields only the kernels of the Linear rows' branch read
PARAM_FIELDS = ("accel_params", "steer_params")
B = 4096
SEED = 2
REPS = 20  # launches a turn
OUT_DIR = REPO / "build" / "kernel_ab"

_FRAME_LOOP = re.compile(
    r"^\s*for \(int frame = 0; frame < (p\.)?frames; \+\+frame\) \{\s*$")
_MARKERS = ("// ---", "drive(", "drive<", "stage_post(")
# slot 31 of the sums counts the (block, frame) samples
_PRELUDE = r"""
// kernel_ab --clocks: thread 0's clock64() cycles per frame phase, summed over blocks
__device__ unsigned long long frame_clocks_sum[32];
#define FRAME_CLOCK(k)                                                      \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      const long long t_ = clock64();                                       \
      atomicAdd(&frame_clocks_sum[k], (unsigned long long)(t_ - clk_last_)); \
      clk_last_ = t_;                                                       \
    }                                                                       \
  } while (0)
#define FRAME_COUNT()                                                       \
  do {                                                                      \
    if (threadIdx.x == 0) atomicAdd(&frame_clocks_sum[31], 1ull);           \
  } while (0)
extern "C" int frame_clocks_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, frame_clocks_sum, sizeof(frame_clocks_sum));
}
extern "C" int frame_clocks_reset() {
  static const unsigned long long zero[32] = {0};
  return (int)cudaMemcpyToSymbol(frame_clocks_sum, zero, sizeof(zero));
}
"""


def _phase_name(line: str) -> str:
    if line.startswith(("drive(", "drive<")):
        return "drive()"
    if line.startswith("stage_post("):
        return "stage_post() and what follows it"
    return line.removeprefix("// ---").strip(" -")[:60]


def instrument(src: str) -> tuple[str, list[str]]:
    """The kernel source with a stamp before every phase marker of its
    frame loop, and the phases' names."""
    lines = src.splitlines()
    start = next(i for i, line in enumerate(lines) if _FRAME_LOOP.match(line))
    depth = 0
    for end in range(start, len(lines)):
        code = lines[end].split("//")[0]
        depth += code.count("{") - code.count("}")
        if depth == 0:
            break
    names = ["frame start and staging"]
    out = lines[: start + 1] + ["    long long clk_last_ = clock64();"]
    for line in lines[start + 1 : end]:
        if line.strip().startswith(_MARKERS):
            out.append(f"FRAME_CLOCK({len(names) - 1});")
            names.append(_phase_name(line.strip()))
        out.append(line)
    out.append(f"FRAME_CLOCK({len(names) - 1});")
    out.append("FRAME_COUNT();")
    out += lines[end:]
    inc = next(i for i, line in enumerate(out) if line.startswith('#include "straight_common.cuh"'))
    out[inc + 1 : inc + 1] = _PRELUDE.splitlines()
    return "\n".join(out) + "\n", names


def instrumented_tree(csrc: pathlib.Path, dest: pathlib.Path, kernels) -> dict[str, list[str]]:
    """Copy of ``csrc`` in ``dest`` with the named frame kernels stamped;
    returns each kernel's phase names."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(csrc, dest)
    names = {}
    for k in kernels:
        text, names[k] = instrument((csrc / f"{k}.cu").read_text())
        (dest / f"{k}.cu").write_text(text)
    return names


def reads_params(csrc: pathlib.Path) -> bool:
    """Whether the kernels of the tree ``csrc`` read the Linear rows'
    parameter fields (the current field lists) or predate them."""
    return all(PARAM_FIELDS[0] in (csrc / name).read_text()
               for name in ("straight_common.cuh", "general_frames.cu"))


def has_dynamical(csrc: pathlib.Path) -> bool:
    """Whether the general kernels of the tree ``csrc`` have the
    ``kDynamical`` entries."""
    return "general_frames_dynamical" in (csrc / "general_frames.cu").read_text()


def load(path: pathlib.Path, wrapper_cls, params: bool = True):
    """A wrapper instance (``wrapper_cls()``) bound to the library at
    ``path``; ``params=False``: a library whose kernels take no parameter
    fields, bound with its field list."""
    lib = ctypes.CDLL(str(path))
    wrapper = wrapper_cls()
    if not params:
        wrapper.in_fields = [f for f in wrapper.in_fields if f[0] not in PARAM_FIELDS]
    wrapper._bind(lib)
    wrapper._lib = lib
    return wrapper, lib


def ptxas_report(path: pathlib.Path) -> list[str]:
    log = path.with_suffix(".log")
    if not log.exists():
        return []
    keep = ("registers", "spill", "stack frame", "entry function")
    return [line.strip() for line in log.read_text().splitlines() if any(k in line for k in keep)]


def queued_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls queued
    behind a device-side wait, so the launches run back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, rounds: int) -> str:
    """Times each build's ``fns[label]`` in turns (baseline, current, current,
    baseline, ``rounds`` times); the line of means, spreads and ratio."""
    labels = list(fns)
    times = {label: [] for label in labels}
    for label in (labels + labels[::-1]) * rounds:
        times[label].append(queued_ms(fns[label], REPS))
    line = [f"{label} {sum(t) / len(t):.4f} ms ({min(t):.4f}-{max(t):.4f}, "
            f"{len(t)} turns)" for label, t in times.items()]
    a = labels[0]
    for b in labels[1:]:  # each over the first (e.g. current / baseline)
        ratio = (sum(times[b]) / len(times[b])) / (sum(times[a]) / len(times[a]))
        line.append(f"{b} / {a} {ratio:.3f}")
    return "; ".join(line)


def print_clocks(label: str, kname: str, lib, names, run) -> None:
    """Runs ``run()`` on a stamped build and prints thread 0's mean cycles
    per frame in each phase."""
    import torch

    run()
    torch.cuda.synchronize()
    if lib.frame_clocks_reset() != 0:
        raise RuntimeError("frame_clocks_reset failed")
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    if lib.frame_clocks_read(buf) != 0:
        raise RuntimeError("frame_clocks_read failed")
    samples = buf[31]
    cyc = [buf[k] / samples for k in range(len(names))]
    total = sum(cyc)
    print(f"  {label} {kname} cycles per frame (thread 0, mean over {samples} block-frames): "
          f"{total:.0f}")
    for n, c in zip(names, cyc):
        print(f"    {c:9.0f} {100 * c / total:5.1f}%  {n}")


def equal_fields(a, b, names, where: str) -> None:
    import torch

    bad = [n for n in names if not torch.equal(getattr(a, n), getattr(b, n))]
    if bad:
        raise AssertionError(f"{where}: the builds differ in {bad}")


# --------------------------------------------------------------------------- #
# straight kernels (K1, K3)
# --------------------------------------------------------------------------- #


def straight_scenes(veh):
    """The reset scene, compressed (x * 0.2) and a 20-vehicle pile-up in
    6 m in every env, as chip_smoke.py builds them."""
    import torch

    compressed = veh.pos.clone()
    compressed[..., 0] *= 0.2
    pileup = veh.pos.clone()
    pileup[:, :20, 0] = 100.0 + torch.linspace(0, 6, 20, device=veh.pos.device)
    return {"reset": veh, "compressed": veh.replace(pos=compressed),
            "pile-up": veh.replace(pos=pileup)}


def run_straight(args, paths, clock_paths, phases, params) -> None:
    import torch

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import straight_frames as sf
    from highwayenv_tpu_torch.ops import straight_sorted as ss
    from highwayenv_tpu_torch.vehicle.state import KIND_EGO

    all_wrappers = {
        label: (load(p["straight_frames"], sf.StraightFramesKernel, params[label])[0],
                load(p["straight_frames_sorted"], ss.FramesSortedKernel, params[label])[0])
        for label, p in paths.items()}
    all_clock_libs = {
        label: {"K1": load(p["straight_frames"], sf.StraightFramesKernel, params[label]),
                "K3": load(p["straight_frames_sorted"], ss.FramesSortedKernel, params[label])}
        for label, p in clock_paths.items()}
    configs = (CONFIGS + tuple(("highway-v0", {"vehicles_count": n}) for n in args.vehicles)
               + LINEAR_CONFIGS)
    for env_id, config in configs:
        linear = (env_id, config) in LINEAR_CONFIGS
        wrappers = {k: w for k, w in all_wrappers.items() if params[k] or not linear}
        clock_libs = {k: w for k, w in all_clock_libs.items() if params[k] or not linear}
        env = ht.make(env_id, config)
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        sa = env._action_to_slots(torch.ones(B, dtype=torch.int32, device=env.device))
        v0 = states.vehicles
        v0 = env.action_type.apply(env.geo, v0, v0.kind == KIND_EGO, sa)
        mask = torch.arange(B, device=env.device) % 3 == 0
        out_names = [n for n, _, _ in sf._OUT_FIELDS]
        print(f"== {env_id}{' LinearVehicle' if linear else ''}: V={env.num_slots}, "
              f"{frames} frames, B={B}")

        # 2. the builds agree on every field and flag
        for name, veh in straight_scenes(v0).items():
            srt, idx = ss.sort_plain(veh, fs)
            res = {}
            for label, (k1, k3) in wrappers.items():
                dense = k1(veh, fs, p, dt, frames, linear=linear)
                band, flags = k3(srt, idx, fs, p, dt, frames, linear=linear)
                base = ss.unsort_plain(band, idx, veh)
                out = base.replace(**{n: getattr(base, n).clone() for n in out_names})
                masked = k1(veh, fs, p, dt, frames, mask=mask, out=out, linear=linear)
                res[label] = (dense, band, flags, masked)
            torch.cuda.synchronize()
            first = res[next(iter(res))]
            for label, (dense, band, flags, masked) in res.items():
                equal_fields(dense, first[0], out_names, f"{env_id} {name} K1")
                equal_fields(band, first[1], out_names, f"{env_id} {name} K3")
                equal_fields(masked, first[3], out_names, f"{env_id} {name} K1 masked")
                if not torch.equal(flags, first[2]):
                    raise AssertionError(f"{env_id} {name} K3: the builds' flags differ")
            fired = first[2].sum(dim=0).tolist()
            print(f"  {name}: {' and '.join(res)} equal on every field (K1, K1 masked, "
                  f"K3); K3 flags fired collision {fired[0]}, neighbour {fired[1]}")

        # 3. device times in turns
        veh = v0
        srt, idx = ss.sort_plain(veh, fs)
        none = torch.zeros(B, dtype=torch.bool, device=env.device)
        back = ss.unsort_plain(ss.frames_sorted_plain(srt, idx, fs, p, dt, frames)[0], idx, veh)
        for kname, make_fn in (
            ("K1 every env", lambda k1, k3: lambda: k1(veh, fs, p, dt, frames, linear=linear)),
            ("K3", lambda k1, k3: lambda: k3(srt, idx, fs, p, dt, frames, linear=linear)),
            ("K1 masked, no env firing",
             lambda k1, k3: lambda: k1(veh, fs, p, dt, frames, mask=none, out=back,
                                       linear=linear)),
        ):
            fns = {label: make_fn(*w) for label, w in wrappers.items()}
            print(f"  {kname}: " + in_turns(fns, args.rounds))

        # 4. cycles per frame phase
        for label, libs in clock_libs.items():
            for kname, kernel in (("K1", "straight_frames"), ("K3", "straight_frames_sorted")):
                wrapper, lib = libs[kname]
                run = (lambda w=wrapper: w(veh, fs, p, dt, frames, linear=linear)) if (
                    kname == "K1") else (
                    lambda w=wrapper: w(srt, idx, fs, p, dt, frames, linear=linear))
                print_clocks(label, kname, lib, phases[label][kernel], run)


#: rows of the straight global family's scene past one block
GLOBAL_STRAIGHT_ROWS = 256


def run_straight_global(args, paths, params) -> None:
    """The straight_global family: every tree's K1 and K3 in each layout it
    has, each with the tree's K2a and K2b, at the straight family's scenes
    (B=4096), equal bit for bit and timed in turns; then the global layouts
    alone at highway-v0 with 2047 vehicles, GLOBAL_STRAIGHT_ROWS rows."""
    import torch

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import straight_frames as sf
    from highwayenv_tpu_torch.ops import straight_sorted as ss
    from highwayenv_tpu_torch.vehicle.state import KIND_EGO

    def bound(p, glob: bool, label: str):
        sfx = "_global" if glob else ""
        ctor = functools.partial
        return {"K1": load(p[f"straight_frames{sfx}"], ctor(sf.StraightFramesKernel, glob=glob),
                           params[label])[0],
                "K3": load(p[f"straight_frames_sorted{sfx}"],
                           ctor(ss.FramesSortedKernel, glob=glob), params[label])[0],
                "K2a": load(p["straight_sort"], ss.SortKernel)[0],
                "K2b": load(p["straight_sort"], ss.UnsortKernel)[0]}

    wrappers = {}
    for label, p in paths.items():
        wrappers[f"{label} block"] = bound(p, False, label)
        if "straight_frames_global" in p:
            wrappers[f"{label} global"] = bound(p, True, label)
    configs = (CONFIGS + tuple(("highway-v0", {"vehicles_count": n}) for n in args.vehicles)
               + (("highway-v0", {"vehicles_count": 2047}),))
    out_names = [n for n, _, _ in sf._OUT_FIELDS]
    sort_names = [n for n, _, _ in ss.SORT_FIELDS]
    for env_id, config in configs:
        env = ht.make(env_id, config)
        V, L = env.num_slots, len(env._straight.offsets)
        labels = [k for k in wrappers
                  if k.endswith("global") or sf.straight_layout_for(V, L) == "block"]
        rows = B if sf.straight_layout_for(V, L) == "block" else GLOBAL_STRAIGHT_ROWS
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(rows, gen)
        sa = env._action_to_slots(torch.ones(rows, dtype=torch.int32, device=env.device))
        v0 = env.action_type.apply(env.geo, states.vehicles, states.vehicles.kind == KIND_EGO,
                                   sa)
        mask = torch.arange(rows, device=env.device) % 3 == 0
        print(f"== straight global {env_id} {config}: V={V}, L={L}, {frames} frames, B={rows}, "
              f"{' / '.join(labels)}")
        for name, veh in straight_scenes(v0).items():
            srt, idx = ss.sort_plain(veh, fs)
            res = {}
            for label in labels:
                w = wrappers[label]
                srt_k, idx_k = w["K2a"](veh, fs)
                band, flags = w["K3"](srt, idx, fs, p, dt, frames, linear=False)
                back = w["K2b"](band, idx, veh)
                dense = w["K1"](veh, fs, p, dt, frames, linear=False)
                out = back.replace(**{n: getattr(back, n).clone() for n in out_names})
                masked = w["K1"](veh, fs, p, dt, frames, mask=mask, out=out, linear=False)
                res[label] = (srt_k, idx_k, band, flags, back, dense, masked)
            torch.cuda.synchronize()
            first = res[labels[0]]
            for label, r in res.items():
                equal_fields(r[0], first[0], sort_names, f"{env_id} {name} K2a")
                if not (torch.equal(r[1], first[1]) and torch.equal(r[3], first[3])):
                    raise AssertionError(f"{env_id} {name}: idx or flags differ ({label})")
                equal_fields(r[2], first[2], out_names, f"{env_id} {name} K3")
                equal_fields(r[4], first[4], out_names, f"{env_id} {name} K2b")
                equal_fields(r[5], first[5], out_names, f"{env_id} {name} K1")
                equal_fields(r[6], first[6], out_names, f"{env_id} {name} K1 masked")
            fired = first[3].sum(dim=0).tolist()
            print(f"  {name}: {' and '.join(res)} equal on every field (K2a, K3 and its flags, "
                  f"K2b, K1, K1 masked); flags fired collision {fired[0]}, neighbour {fired[1]}")
        veh = v0
        srt, idx = ss.sort_plain(veh, fs)
        # the banded rows from a kernel: the plain frames' (rows, V, V) pair
        # tensors do not fit the card at V = 2048
        band, _ = wrappers[labels[0]]["K3"](srt, idx, fs, p, dt, frames, linear=False)
        for kname, make_fn in (
            ("K1 every env", lambda w: lambda: w["K1"](veh, fs, p, dt, frames, linear=False)),
            ("K3", lambda w: lambda: w["K3"](srt, idx, fs, p, dt, frames, linear=False)),
            ("K2a", lambda w: lambda: w["K2a"](veh, fs)),
            ("K2b", lambda w: lambda: w["K2b"](band, idx, veh)),
        ):
            fns = {label: make_fn(wrappers[label]) for label in labels}
            print(f"  {kname}: " + in_turns(fns, args.rounds))


def run_objects(args, paths) -> None:
    """The objects family: the current tree's K1 objects instantiations
    against its lean ones on vehicles-only scenes, equal and timed in
    turns, then alone on the obstacle scene."""
    import torch

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import straight_frames as sf
    from highwayenv_tpu_torch.tools import object_scenes
    from highwayenv_tpu_torch.vehicle.state import KIND_EGO

    out_names = [n for n, _, _ in sf._OUT_FIELDS] + ["hit"]
    for env_id, config in (("highway-v0", None), LINEAR_CONFIGS[0],
                           ("highway-v0", {"vehicles_count": 2047})):
        env = ht.make(env_id, config)
        V, L = env.num_slots, len(env._straight.offsets)
        glob = sf.straight_layout_for(V, L) == "global"
        rows = GLOBAL_STRAIGHT_ROWS if glob else B
        k1 = load(paths["current"]["straight_frames_global" if glob else "straight_frames"],
                  functools.partial(sf.StraightFramesKernel, glob=glob))[0]
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        linear = env.linear_rows
        _, states = env.reset(rows, env.generator(SEED))
        sa = env._action_to_slots(torch.ones(rows, dtype=torch.int32, device=env.device))
        v0 = env.action_type.apply(env.geo, states.vehicles, states.vehicles.kind == KIND_EGO,
                                   sa)
        print(f"== objects {env_id} {config}: V={V}, L={L}, {frames} frames, B={rows}, "
              f"{k1.entry}, linear={linear}")
        for name, veh in straight_scenes(v0).items():
            lean = k1(veh, fs, p, dt, frames, linear=linear)
            objs = k1(veh, fs, p, dt, frames, linear=linear, objects=True)
            torch.cuda.synchronize()
            equal_fields(objs, lean, out_names, f"{env_id} {name} objects")
            print(f"  {name}: the objects instantiation equals the lean one on every field, "
                  f"hit unchanged")
        fns = {"lean": lambda: k1(v0, fs, p, dt, frames, linear=linear),
               "objects": lambda: k1(v0, fs, p, dt, frames, linear=linear, objects=True)}
        print("  K1 every env, vehicles only: " + in_turns(fns, args.rounds))
        scene = object_scenes.object_state(v0, "obstacle")
        ms = queued_ms(lambda: k1(scene, fs, p, dt, frames, linear=linear, objects=True), REPS)
        print(f"  K1 objects on the obstacle scene: {ms:.4f} ms")


# --------------------------------------------------------------------------- #
# general kernels (K4, K5)
# --------------------------------------------------------------------------- #


def general_scenes(env, states, gen):
    """K4's scenes, as chip_smoke.py builds them: reset; 8 policy steps in
    (the plain autoreset path); every env's vehicles in a row 1.5 m apart
    along the ego's heading (an all-env pile-up); and on merge-v0 the ramp
    vehicle closing on the end-of-ramp obstacle at 15 m/s and slot 1 on the
    ego at 40 m/s (the obstacle hit)."""
    import torch

    from highwayenv_tpu_torch.vehicle.state import KIND_OBSTACLE

    veh = states.vehicles
    Bn, V = veh.kind.shape
    dev = veh.pos.device
    st = states
    for _ in range(8):
        acts = torch.randint(0, env.action_type.n, (Bn,), generator=gen,
                             device=dev, dtype=torch.int32)
        st = env.step_autoreset(st, acts, gen)[1]
    out = {"reset": veh, "8 steps in": st.vehicles}
    h = veh.heading[:, 0]
    u = torch.stack([torch.cos(h), torch.sin(h)], dim=-1)
    k = torch.arange(V, device=dev, dtype=torch.float32)
    row = veh.pos[:, :1] + 1.5 * k[None, :, None] * u[:, None, :]
    is_veh = veh.is_vehicle
    out["pile-up"] = veh.replace(
        pos=torch.where(is_veh[..., None], row, veh.pos),
        heading=torch.where(is_veh, h[:, None], veh.heading),
        lane=torch.where(is_veh, veh.lane[:, :1], veh.lane),
        target_lane=torch.where(is_veh, veh.lane[:, :1], veh.target_lane),
    )
    if bool((veh.kind == KIND_OBSTACLE).any()):  # merge-v0: slot 5
        pos, heading, speed = veh.pos.clone(), veh.heading.clone(), veh.speed.clone()
        lane, tlane = veh.lane.clone(), veh.target_lane.clone()
        off = 0.5 * (torch.arange(Bn, device=dev) % 8).float()
        pos[:, 4, 0] = pos[:, 5, 0] - 7.0 - off
        pos[:, 4, 1] = pos[:, 5, 1]
        heading[:, 4], speed[:, 4] = 0.0, 15.0
        lane[:, 4] = tlane[:, 4] = env.net.global_lane_index(("b", "c", 2))
        pos[:, 1, 0] = pos[:, 0, 0] - 6.0
        pos[:, 1, 1] = pos[:, 0, 1]
        heading[:, 1], speed[:, 1] = 0.0, 40.0
        lane[:, 1] = tlane[:, 1] = lane[:, 0]
        out["obstacle hit"] = veh.replace(pos=pos, heading=heading, speed=speed,
                                          lane=lane, target_lane=tlane)
    return out


def regulated_scenes(env, states, gen):
    """K5's scenes at intersection-v0, as chip_smoke.py builds them, each
    (vehicles, steps0, slot actions, frames): the reset scene; 8 plain
    autoreset steps in, with row b's frame counter advanced by 15 b so the
    tick phases cover all 7 values; a conflict scene (slots 0 and 1 at the
    same priority from corners 0 and 2, slot 2 at a higher one from corner
    1, at distances that vary by env); and the reset's warm-up launch (the
    first 16 slots of fresh spawns, 45 frames, frame counter 0)."""
    import dataclasses

    import torch

    from highwayenv_tpu_torch.road import lane as lane_ops
    from highwayenv_tpu_torch.vehicle.state import KIND_IDM, VehicleState

    veh = states.vehicles
    Bn, V = veh.kind.shape
    dev = veh.pos.device
    spread = torch.arange(Bn, device=dev, dtype=torch.int32) * env.frames_per_step

    def actions():
        acts = torch.randint(0, env.action_type.n, (Bn,), generator=gen, device=dev,
                             dtype=torch.int32)
        return env._action_to_slots(acts)

    out = {"reset": (veh, states.steps, actions(), env.frames_per_step)}
    st = states
    for _ in range(8):
        acts = torch.randint(0, env.action_type.n, (Bn,), generator=gen, device=dev,
                             dtype=torch.int32)
        st = env.step_autoreset(st, acts, gen)[1]
    out["8 steps in"] = (st.vehicles, st.steps + spread, actions(), env.frames_per_step)

    rb, rn, rid, rlen = env._routes
    fields = {f.name: getattr(veh, f.name).clone() for f in dataclasses.fields(VehicleState)}
    off = (torch.arange(Bn, device=dev) % 16).float()
    for slot, corner, dest, s0, speed in ((0, 0, 2, 96.0, 8.0), (1, 2, 3, 95.0, 7.0),
                                          (2, 1, 3, 93.0, 9.0)):
        lane = env._spawn_lane[corner].expand(Bn)
        s = s0 - (0.5 + 0.25 * slot) * off
        fields["pos"][:, slot] = lane_ops.position(env.geo, lane, s, torch.zeros_like(s))
        fields["heading"][:, slot] = lane_ops.heading_at(env.geo, lane, s)
        for name, value in (("lane", lane), ("target_lane", lane), ("speed", speed),
                            ("target_speed", speed), ("kind", KIND_IDM), ("crashed", False),
                            ("is_yielding", False), ("yield_timer", 0), ("route_ptr", 0),
                            ("route_len", rlen[corner, dest])):
            fields[name][:, slot] = value
        for name, table in (("route_base", rb), ("route_n", rn), ("route_id", rid)):
            fields[name][:, slot] = table[corner, dest]
    out["conflict"] = (VehicleState(**fields), states.steps + spread, actions(),
                       env.frames_per_step)

    spawned, _ = env._spawn_initial(Bn, gen)
    W = env._warmup_slots
    sub = VehicleState(**{f.name: getattr(spawned, f.name)[:, :W].contiguous()
                          for f in dataclasses.fields(VehicleState)})
    out["warm-up"] = (sub, torch.zeros(Bn, dtype=torch.int32, device=dev),
                      torch.zeros((Bn, W), dtype=torch.int32, device=dev),
                      env._warmup_frames)
    return out


def dynamical_scene(env, states, gen):
    """The dynamical instantiations' scene of ``env`` (intersection-v1 or
    lane-keeping-v0): the reset scene with the actions stored, a fifth of the
    egos crashed and a fifth below 1 m/s (the low-speed damping branch), and
    on a regulated road the tick phases spread over all 7 values; (vehicles,
    slot actions, the K5 frame counters or nothing)."""
    import torch

    from highwayenv_tpu_torch.ops import general_frames as gf
    from highwayenv_tpu_torch.vehicle.state import KIND_EGO

    veh = states.vehicles
    dev = veh.pos.device
    Bn = veh.kind.shape[0]
    ego = veh.kind == KIND_EGO
    row = (torch.arange(Bn, device=dev) % 5)[:, None]
    veh = veh.replace(
        crashed=veh.crashed | (ego & (row == 0)),
        speed=torch.where(ego & (row == 1), 0.8, veh.speed),
        yaw_rate=torch.where(ego, 0.3, veh.yaw_rate),
        lateral_speed=torch.where(ego, -0.2, veh.lateral_speed),
    )
    acts = torch.rand((Bn,) + tuple(env.action_type.action_shape), generator=gen,
                      device=dev) * 2 - 1
    veh, sa, raw = gf.store_raw_controls(env, veh, env._action_to_slots(acts))
    assert raw
    extra = ()
    if env.regulated:
        extra = (states.steps + torch.arange(Bn, device=dev, dtype=torch.int32) * 15,)
    return veh, sa, extra


def run_general(args, paths, clock_paths, phases, params, dynamical) -> None:
    import torch

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import general_frames as gf

    kinds = {
        "K4": gf.GeneralFramesKernel,
        "K5": functools.partial(gf.GeneralFramesKernel, regulated=True),
        "K4 dynamical": functools.partial(gf.GeneralFramesKernel, dynamical=True),
        "K5 dynamical": functools.partial(gf.GeneralFramesKernel, regulated=True,
                                          dynamical=True),
        "K4 connected": functools.partial(gf.GeneralFramesKernel, connected=True),
        "K5 connected": functools.partial(gf.GeneralFramesKernel, regulated=True,
                                          connected=True),
    }

    def bound(p, label):
        return {k: load(p["general_frames"], cls, params[label])
                for k, cls in kinds.items() if dynamical[label] or "dynamical" not in k}

    wrappers = {label: {k: w for k, (w, _) in bound(p, label).items()}
                for label, p in paths.items()}
    clock_libs = {label: bound(p, label) for label, p in clock_paths.items()}
    names = [n for n, _, _ in gf.OUT_FIELDS]
    reg_names = names + [n for n, _, _ in gf.REG_FIELDS]
    timed = {}  # label -> (kernel, call args, the tree labels that run it)

    for env_id in ("roundabout-v0", "merge-v0", "exit-v0"):
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        print(f"== {env_id}: K4, V={env.num_slots}, L={env.geo.num_lanes}, "
              f"R={states.vehicles.route_base.shape[-1]}, {frames} frames, B={B}")
        for name, veh in general_scenes(env, states, gen).items():
            acts = torch.randint(0, env.action_type.n, (B,), generator=gen,
                                 device=env.device, dtype=torch.int32)
            sa = env._action_to_slots(acts)
            res = {label: w["K4"](veh, spec, sa, frames, linear=False)
                   for label, w in wrappers.items()}
            torch.cuda.synchronize()
            first = res[next(iter(res))]
            for label, out in res.items():
                equal_fields(out, first, names, f"{env_id} {name} K4")
            print(f"  {name}: {' and '.join(res)} equal on every field; crashed slots "
                  f"{int(first.crashed.sum())}")
            if name == "reset":
                timed[f"K4 {env_id}"] = ("K4", (veh, spec, sa, frames), list(wrappers),
                                         {"linear": False})

    env = ht.make("intersection-v0")
    spec = env._general
    gen = env.generator(SEED)
    _, states = env.reset(B, gen)
    print(f"== intersection-v0: K5, V={env.num_slots}, L={env.geo.num_lanes}, "
          f"R={states.vehicles.route_base.shape[-1]}, {env.frames_per_step} frames, tick "
          f"period {spec.period}, B={B}")
    for name, (veh, steps0, sa, frames) in regulated_scenes(env, states, gen).items():
        if name == "reset":  # the tick phases spread over all 7 values
            steps0 = steps0 + torch.arange(B, device=env.device, dtype=torch.int32) * 15
        res = {label: w["K5"](veh, spec, sa, frames, steps0, linear=False)
               for label, w in wrappers.items()}
        torch.cuda.synchronize()
        first = res[next(iter(res))]
        for label, out in res.items():
            equal_fields(out, first, reg_names, f"intersection-v0 {name} K5")
        print(f"  {name} (V={veh.kind.shape[1]}, {frames} frames): {' and '.join(res)} equal "
              f"on every field and the yielding state; yielding {int(first.is_yielding.sum())}, "
              f"crashed slots {int(first.crashed.sum())}")
        if name in ("reset", "warm-up"):
            key = "K5 step (reset, spread phases)" if name == "reset" else "K5 warm-up"
            timed[key] = ("K5", (veh, spec, sa, frames, steps0), list(wrappers),
                          {"linear": False})

    # the Linear rows' branch of K4 and K5 (on the trees that take the
    # parameter fields) and K5's raw-control branch, on the reset scene
    for env_id, config, k in GENERAL_LINEAR:
        env = ht.make(env_id, config)
        spec, frames = env._general, env.frames_per_step
        _, states = env.reset(B, env.generator(SEED))
        veh = states.vehicles
        acts = (torch.rand((B,) + tuple(env.action_type.action_shape), generator=gen,
                           device=env.device) * 2 - 1
                if env.action_type.stores_raw_controls else
                torch.randint(0, env.action_type.n, (B,), generator=gen, device=env.device,
                              dtype=torch.int32))
        veh, sa, raw = gf.store_raw_controls(env, veh, env._action_to_slots(acts))
        linear = env.linear_rows
        extra = ()
        if env.regulated:  # the tick phases spread over all 7 values
            extra = (states.steps + torch.arange(B, device=env.device, dtype=torch.int32) * 15,)
        labels = [label for label in wrappers if params[label] or not linear]
        res = {label: wrappers[label][k](veh, spec, sa, frames, *extra, raw=raw, linear=linear)
               for label in labels}
        torch.cuda.synchronize()
        what = config.get("other_vehicles_type", "ContinuousAction").rsplit(".", 1)[-1]
        key = f"{k} {env_id} {what}"
        print(f"== {key}: V={env.num_slots}, {frames} frames, B={B}, raw controls {raw}: "
              f"{' and '.join(res)} ran; crashed slots "
              f"{int(res[labels[0]].crashed.sum())}")
        if len(res) > 1:
            first = res[labels[0]]
            for label, out in res.items():
                equal_fields(out, first, reg_names if env.regulated else names, key)
        timed[key] = (k, (veh, spec, sa, frames, *extra), labels, {"raw": raw, "linear": linear})

    # the kDynamical instantiations on the trees that have them, each beside
    # the v0 instantiation's raw branch on the same scene
    for env_id, k in GENERAL_DYNAMICAL:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        _, states = env.reset(B, env.generator(SEED))
        veh, sa, extra = dynamical_scene(env, states, gen)
        labels = [label for label in wrappers if dynamical[label]]
        kd = f"{k} dynamical"
        res = {label: wrappers[label][kd](veh, spec, sa, frames, *extra, raw=True, linear=False)
               for label in labels}
        torch.cuda.synchronize()
        first = res[labels[0]]
        fields = (reg_names if env.regulated else names) + [n for n, _, _ in gf.DYN_FIELDS]
        for label, out in res.items():
            equal_fields(out, first, fields, f"{kd} {env_id}")
        print(f"== {kd} {env_id}: V={env.num_slots}, L={env.geo.num_lanes}, {frames} frames, "
              f"B={B}: {' and '.join(res)} ran; crashed slots {int(first.crashed.sum())}")
        timed[f"{kd} {env_id}"] = (kd, (veh, spec, sa, frames, *extra), labels,
                                   {"raw": True, "linear": False})
        v0 = spec._replace(dynamical=False)
        res = {label: w[k](veh, v0, sa, frames, *extra, raw=True, linear=False)
               for label, w in wrappers.items()}
        torch.cuda.synchronize()
        first = res[next(iter(res))]
        for label, out in res.items():
            equal_fields(out, first, reg_names if env.regulated else names,
                         f"{k} {env_id} without the flag")
        print(f"  {k} (v0 raw) on the same scene: {' and '.join(res)} equal on every field")
        timed[f"{k} {env_id} v0 raw, same scene"] = (
            k, (veh, v0, sa, frames, *extra), list(wrappers), {"raw": True, "linear": False})

    # the kConnected instantiations, on the reset scene
    for env_id, k in GENERAL_CONNECTED:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        _, states = env.reset(B, env.generator(SEED))
        acts = torch.randint(0, env.action_type.n, (B,), generator=gen, device=env.device,
                             dtype=torch.int32)
        call = (states.vehicles, spec, env._action_to_slots(acts), frames)
        if env.regulated:  # the tick phases spread over all 7 values
            call += (states.steps + torch.arange(B, device=env.device, dtype=torch.int32) * 15,)
        res = {label: w[k](*call, linear=False) for label, w in wrappers.items()}
        torch.cuda.synchronize()
        first = res[next(iter(res))]
        for out in res.values():
            equal_fields(out, first, reg_names if env.regulated else names, f"{k} {env_id}")
        print(f"== {k} {env_id}: V={env.num_slots}, {frames} frames, B={B}: "
              f"{' and '.join(res)} equal on every field; crashed slots "
              f"{int(first.crashed.sum())}")
        timed[f"{k} {env_id}"] = (k, call, list(wrappers), {"linear": False})

    # 3. device times in turns
    for key, (k, call, labels, kw) in timed.items():
        fns = {label: (lambda w=wrappers[label][k]: w(*call, **kw)) for label in labels}
        print(f"  {key}: " + in_turns(fns, args.rounds))

    # 4. cycles per frame phase
    for label, libs in clock_libs.items():
        for key, (k, call, labels, kw) in timed.items():
            if label not in labels:
                continue
            wrapper, lib = libs[k]
            print_clocks(label, key, lib, phases[label]["general_frames"],
                         lambda w=wrapper: w(*call, **kw))


def layout_wrappers(path, params: bool, layout: str) -> dict:
    """The six wrappers (K4 / K5, v0, connected, dynamical) of the
    ``layout`` library at ``path`` ("wide", "cluster" or "global"), keyed
    "K4", "K5 connected", ..."""
    from highwayenv_tpu_torch.ops import general_frames as gf

    flag = {"global": "glob"}.get(layout, layout)
    return {f"{road}{law}": load(path, functools.partial(
        gf.GeneralFramesKernel, regulated=road == "K5", connected=law == " connected",
        dynamical=law == " dynamical", **{flag: True}), params)
        for road in ("K4", "K5") for law in ("", " connected", " dynamical")}


def run_layout(args, paths, params, layout: str, clock_paths=None, phases=None) -> None:
    """The ``layout`` family ("wide", "cluster" or "global"): its K4 / K5
    at LAYOUT_SCENES on both trees (the global family: the trees' global
    libraries and the current cluster library, where the scene fits it),
    equal bit for bit, then timed in turns; the global family's cycles per
    frame phase with ``--clocks``."""
    import torch

    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import general_frames as gf

    library = f"general_frames_{layout}"
    bound = {label: layout_wrappers(p[library], params[label], layout)
             for label, p in paths.items() if library in p}
    if layout == "global":  # the current tree's cluster library, the yardstick
        bound = {"cluster": layout_wrappers(paths["current"]["general_frames_cluster"],
                                            params["current"], "cluster"), **bound}
    wrappers = {label: {k: w for k, (w, _) in ws.items()} for label, ws in bound.items()}
    names = [n for n, _, _ in gf.OUT_FIELDS]
    reg_names = names + [n for n, _, _ in gf.REG_FIELDS]
    dyn_names = [n for n, _, _ in gf.DYN_FIELDS]
    timed = {}
    for env_id, config, k in LAYOUT_SCENES[layout]:
        env = ht.make(env_id, config)
        spec, frames = env._general, env.frames_per_step
        rows = GLOBAL_WIDE_ROWS if env.num_slots > gf.MAX_SLOTS else LAYOUT_ROWS[layout]
        gen = env.generator(SEED)
        _, states = env.reset(rows, gen)
        # the cluster yardstick only where a cluster's blocks hold the scene
        labels = [label for label in wrappers
                  if label != "cluster"
                  or gf.scene_layout(spec, env.regulated, env.num_slots) == "cluster"]
        print(f"== {env_id} {config}: {layout} {k}, V={env.num_slots}, L={env.geo.num_lanes}, "
              f"{frames} frames, B={rows}")
        kw = {"linear": False}
        if spec.dynamical:  # raw controls stored on the egos: the reset scene alone
            veh, sa, extra = dynamical_scene(env, states, gen)
            scenes = {"reset": (veh, extra[0] if extra else None, sa, frames)}
            kw["raw"] = True
        elif env.regulated:
            scenes = {n: call for n, call in regulated_scenes(env, states, gen).items()
                      if n != "warm-up"}
            scenes["reset"] = (scenes["reset"][0], scenes["reset"][1] + torch.arange(
                rows, device=env.device, dtype=torch.int32) * 15, *scenes["reset"][2:])
        else:
            scenes = {}
            for n, veh in general_scenes(env, states, gen).items():
                acts = torch.randint(0, env.action_type.n, (rows,), generator=gen,
                                     device=env.device, dtype=torch.int32)
                scenes[n] = (veh, None, env._action_to_slots(acts), frames)
        fields = ((reg_names if env.regulated else names)
                  + (dyn_names if spec.dynamical else []))
        for name, (veh, steps0, sa, n_frames) in scenes.items():
            call = (veh, spec, sa, n_frames) + ((steps0,) if env.regulated else ())
            res = {label: wrappers[label][k](*call, **kw) for label in labels}
            torch.cuda.synchronize()
            first = res[next(iter(res))]
            for out in res.values():
                equal_fields(out, first, fields, f"{env_id} {name} {layout} {k}")
            print(f"  {name}: {' and '.join(res)} equal on every field; crashed slots "
                  f"{int(first.crashed.sum())}")
            if name == "reset":
                timed[f"{layout} {k} {env_id} {config}"] = (k, call, kw, labels)
    for key, (k, call, kw, labels) in timed.items():
        fns = {label: (lambda w=wrappers[label][k]: w(*call, **kw)) for label in labels}
        print(f"  {key}: " + in_turns(fns, args.rounds))
    # cycles per frame phase: the stamped global libraries
    for label, p in (clock_paths or {}).items():
        if library not in p:
            continue
        stamped = layout_wrappers(p[library], params[label], layout)
        for key, (k, call, kw, _) in timed.items():
            wrapper, lib = stamped[k]
            print_clocks(label, key, lib, phases[label][library],
                         lambda w=wrapper: w(*call, **kw))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=str(REPO / "build/baseline/highwayenv_tpu_torch/csrc"))
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", nargs="+", choices=list(FAMILIES), default=list(FAMILIES))
    ap.add_argument("--vehicles", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    from highwayenv_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    trees = {"current": _build.SOURCE_DIR}
    if pathlib.Path(args.baseline).is_dir():
        trees = {"baseline": pathlib.Path(args.baseline), **trees}
    else:
        print(f"no baseline tree at {args.baseline}: the current kernels alone")

    # 1. builds (of the sources a tree has: a baseline from before the
    # global layout has no general_frames_global.cu)
    kernels = list(dict.fromkeys(k for fam in args.kernels for k in FAMILIES[fam]))
    paths, clock_paths, phases = {}, {}, {}
    for label, csrc in trees.items():
        names = [k for k in kernels if (pathlib.Path(csrc) / f"{k}.cu").exists()]
        paths[label] = _build.build(names, csrc, OUT_DIR / label)
        for k, path in paths[label].items():
            print(f"{label} {k}: {path.name}")
            for line in ptxas_report(path):
                print(f"    {line}")
        if args.clocks:
            # the wide and cluster sources hold no frame loop of their own;
            # the global one's stamps are general_frames.cu's, which it includes
            stamped = OUT_DIR / f"{label}-clocks" / "csrc"
            # nor do the straight global and permutation sources
            clocked = [k for k in names if k not in FAMILIES["wide"] + FAMILIES["global"]
                       and not k.startswith("straight_sort") and not k.endswith("_global")]
            glob = "general_frames_global" in names
            phases[label] = instrumented_tree(
                csrc, stamped, list(dict.fromkeys(clocked + ["general_frames"] * glob)))
            built = clocked
            if glob:
                phases[label]["general_frames_global"] = phases[label]["general_frames"]
                built = clocked + ["general_frames_global"]
            clock_paths[label] = _build.build(built, stamped, OUT_DIR / f"{label}-clocks")
            for k, path in clock_paths[label].items():
                print(f"{label} {k} with clocks: " + "; ".join(ptxas_report(path)))

    params = {label: reads_params(pathlib.Path(csrc)) for label, csrc in trees.items()}
    print(f"trees that read the Linear parameter fields: {params}")
    if "straight" in args.kernels:
        run_straight(args, paths, clock_paths, phases, params)
    if "straight_global" in args.kernels:
        run_straight_global(args, paths, params)
    if "objects" in args.kernels:
        run_objects(args, paths)
    if "general" in args.kernels:
        dynamical = {label: has_dynamical(pathlib.Path(csrc)) for label, csrc in trees.items()}
        print(f"trees with the kDynamical instantiations: {dynamical}")
        run_general(args, paths, clock_paths, phases, params, dynamical)
    for layout in ("wide", "cluster"):
        if layout in args.kernels:
            run_layout(args, paths, params, layout)
    if "global" in args.kernels:
        run_layout(args, paths, params, "global", clock_paths, phases)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
