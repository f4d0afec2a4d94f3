"""A/B of the straight frame kernels K1 and K3: two ``csrc/`` trees on one card.

Usage (from the repo root, on a machine with a CUDA card):

    mkdir -p build/baseline
    git archive HEAD highwayenv_tpu_torch/csrc | tar -x -C build/baseline
    python3 highwayenv_tpu_torch/tools/kernel_ab.py [--baseline DIR] [--clocks]
        [--vehicles N ...]

``--baseline`` (default ``build/baseline/highwayenv_tpu_torch/csrc``) is a
second ``csrc/`` directory, for example a commit's unpacked as above; when it
is missing only the current kernels run.  For highway-v0 (V=51, 15 frames),
highway-fast-v0 (V=21, 5 frames) and highway-v0 with each ``--vehicles`` N
(V = N + 1), at B=4096, the script

  1. builds ``straight_frames`` (K1) and ``straight_frames_sorted`` (K3) of
     both trees into ``build/kernel_ab/`` with the flags of ``ops/_build.py``
     and prints ptxas's register, stack and spill report;
  2. runs both builds on the same inputs (the reset scene, the compressed
     scene and a pile-up in every env; K1 on every env and masked to every
     third env, K3 with its flags) and checks that every output field and
     flag is equal bit for bit;
  3. times each kernel on the reset scene in turns (baseline, current,
     current, baseline, ``--rounds`` times); a turn is the mean device time
     of REPS launches queued behind a device-side wait, between CUDA
     events; it prints each build's mean and the spread (min to max) of its
     turns;
  4. with ``--clocks``, builds a copy of each tree's two kernels with a
     ``clock64()`` stamp before every phase marker of the frame loop (a
     ``// ---`` comment line, the ``drive(`` call, the ``stage_post(`` call)
     and prints thread 0's mean cycles per frame in each phase over all
     blocks.  The stamps add a few instructions and registers: the split,
     not the total, is what to read.

Exits non-zero without CUDA or when the two builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

KERNELS = ("straight_frames", "straight_frames_sorted")
CONFIGS = (("highway-v0", None), ("highway-fast-v0", None))
B = 4096
SEED = 2
REPS = 20  # launches a turn
OUT_DIR = REPO / "build" / "kernel_ab"

_FRAME_LOOP = re.compile(r"^\s*for \(int frame = 0; frame < frames; \+\+frame\) \{\s*$")
_MARKERS = ("// ---", "drive(", "stage_post(")
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
extern "C" int frame_clocks_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, frame_clocks_sum, sizeof(frame_clocks_sum));
}
extern "C" int frame_clocks_reset() {
  static const unsigned long long zero[32] = {0};
  return (int)cudaMemcpyToSymbol(frame_clocks_sum, zero, sizeof(zero));
}
"""


def _phase_name(line: str) -> str:
    if line.startswith("drive("):
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
    out += lines[end:]
    inc = next(i for i, line in enumerate(out) if line.startswith('#include "straight_common.cuh"'))
    out[inc + 1 : inc + 1] = _PRELUDE.splitlines()
    return "\n".join(out) + "\n", names


def instrumented_tree(csrc: pathlib.Path, dest: pathlib.Path) -> dict[str, list[str]]:
    """Copy of ``csrc`` in ``dest`` with the two frame kernels stamped;
    returns each kernel's phase names."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(csrc, dest)
    names = {}
    for k in KERNELS:
        text, names[k] = instrument((csrc / f"{k}.cu").read_text())
        (dest / f"{k}.cu").write_text(text)
    return names


def load(path: pathlib.Path, wrapper_cls):
    """A wrapper instance bound to the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    wrapper = wrapper_cls()
    wrapper._bind(lib)
    wrapper._lib = lib
    return wrapper, lib


def ptxas_report(path: pathlib.Path) -> list[str]:
    log = path.with_suffix(".log")
    if not log.exists():
        return []
    keep = ("registers", "spill", "stack frame")
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


def scenes(veh):
    """The reset scene, compressed (x * 0.2) and a 20-vehicle pile-up in
    6 m in every env, as chip_smoke.py builds them."""
    import torch

    compressed = veh.pos.clone()
    compressed[..., 0] *= 0.2
    pileup = veh.pos.clone()
    pileup[:, :20, 0] = 100.0 + torch.linspace(0, 6, 20, device=veh.pos.device)
    return {"reset": veh, "compressed": veh.replace(pos=compressed),
            "pile-up": veh.replace(pos=pileup)}


def equal_fields(a, b, names, where: str) -> None:
    import torch

    bad = [n for n in names if not torch.equal(getattr(a, n), getattr(b, n))]
    if bad:
        raise AssertionError(f"{where}: the builds differ in {bad}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=str(REPO / "build/baseline/highwayenv_tpu_torch/csrc"))
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--vehicles", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import _build
    from highwayenv_tpu_torch.ops import straight_frames as sf
    from highwayenv_tpu_torch.ops import straight_sorted as ss
    from highwayenv_tpu_torch.vehicle.state import KIND_EGO

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

    # 1. builds, started together
    wrappers, clock_libs, phases = {}, {}, {}
    for label, csrc in trees.items():
        paths = _build.build(KERNELS, csrc, OUT_DIR / label)
        for k, path in paths.items():
            print(f"{label} {k}: {path.name}")
            for line in ptxas_report(path):
                print(f"    {line}")
        wrappers[label] = (load(paths["straight_frames"], sf.StraightFramesKernel)[0],
                           load(paths["straight_frames_sorted"], ss.FramesSortedKernel)[0])
        if args.clocks:
            stamped = OUT_DIR / f"{label}-clocks" / "csrc"
            phases[label] = instrumented_tree(csrc, stamped)
            cpaths = _build.build(KERNELS, stamped, OUT_DIR / f"{label}-clocks")
            clock_libs[label] = {
                "K1": load(cpaths["straight_frames"], sf.StraightFramesKernel),
                "K3": load(cpaths["straight_frames_sorted"], ss.FramesSortedKernel),
            }
            for k, path in cpaths.items():
                print(f"{label} {k} with clocks: " + "; ".join(ptxas_report(path)))

    configs = CONFIGS + tuple(("highway-v0", {"vehicles_count": n}) for n in args.vehicles)
    for env_id, config in configs:
        env = ht.make(env_id, config)
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        sa = env._action_to_slots(torch.ones(B, dtype=torch.int32, device=env.device))
        v0 = states.vehicles
        v0 = env.action_type.apply(env.geo, v0, v0.kind == KIND_EGO, sa)
        mask = torch.arange(B, device=env.device) % 3 == 0
        out_names = [n for n, _, _ in sf._OUT_FIELDS]
        print(f"== {env_id}: V={env.num_slots}, {frames} frames, B={B}")

        # 2. the builds agree on every field and flag
        for name, veh in scenes(v0).items():
            srt, idx = ss.sort_plain(veh, fs)
            res = {}
            for label, (k1, k3) in wrappers.items():
                dense = k1(veh, fs, p, dt, frames)
                band, flags = k3(srt, idx, fs, p, dt, frames)
                base = ss.unsort_plain(band, idx, veh)
                out = base.replace(**{n: getattr(base, n).clone() for n in out_names})
                masked = k1(veh, fs, p, dt, frames, mask=mask, out=out)
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
        labels = list(wrappers)
        order = (labels + labels[::-1]) * args.rounds
        for kname, make_fn in (
            ("K1 every env", lambda k1, k3: lambda: k1(veh, fs, p, dt, frames)),
            ("K3", lambda k1, k3: lambda: k3(srt, idx, fs, p, dt, frames)),
            ("K1 masked, no env firing",
             lambda k1, k3: lambda: k1(veh, fs, p, dt, frames, mask=none, out=back)),
        ):
            times = {label: [] for label in labels}
            for label in order:
                times[label].append(queued_ms(make_fn(*wrappers[label]), REPS))
            line = [f"{label} {sum(t) / len(t):.4f} ms ({min(t):.4f}-{max(t):.4f}, "
                    f"{len(t)} turns)" for label, t in times.items()]
            if len(labels) == 2:
                ratio = (sum(times["current"]) / len(times["current"])) / (
                    sum(times["baseline"]) / len(times["baseline"]))
                line.append(f"current / baseline {ratio:.3f}")
            print(f"  {kname}: " + "; ".join(line))

        # 4. cycles per frame phase
        for label, libs in clock_libs.items():
            for kname, kernel in (("K1", "straight_frames"), ("K3", "straight_frames_sorted")):
                wrapper, lib = libs[kname]
                run = (lambda: wrapper(veh, fs, p, dt, frames)) if kname == "K1" else (
                    lambda: wrapper(srt, idx, fs, p, dt, frames))
                run()
                torch.cuda.synchronize()
                if lib.frame_clocks_reset() != 0:
                    raise RuntimeError("frame_clocks_reset failed")
                run()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 32)()
                if lib.frame_clocks_read(buf) != 0:
                    raise RuntimeError("frame_clocks_read failed")
                names = phases[label][kernel]
                cyc = [buf[k] / (B * frames) for k in range(len(names))]
                total = sum(cyc)
                print(f"  {label} {kname} cycles per frame (thread 0, mean over {B} blocks): "
                      f"{total:.0f}")
                for n, c in zip(names, cyc):
                    print(f"    {c:9.0f} {100 * c / total:5.1f}%  {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
