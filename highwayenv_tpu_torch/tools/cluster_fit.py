"""Which thread-block clusters of the cluster and global K4 / K5 and the global K1 / K3 a CUDA card holds: the occupancy probe.

Usage (from the repo root, on a machine with a CUDA card):

    python3 highwayenv_tpu_torch/tools/cluster_fit.py

It builds ``csrc/general_frames_cluster.cu`` and asks the card, through the
library's ``general_cluster_fit`` (``cudaOccupancyMaxActiveClusters`` with
the attributes a launch sets first, the non-portable cluster size over 8
blocks among them, at the shared memory a launch asks, which the library
computes as the launch does), how many clusters of 8 to 16 blocks of 128
threads it holds at once:

  - at the lanes, route slots and successor edges of the scenes the
    cluster kernels run over 1024 slots (a block's shared memory is the
    same at any V) and at the largest block ``make`` takes (the most lanes
    whose block stays within ``general_frames.SMEM_LIMIT`` at 16 route
    slots, 4 successor and 4 predecessor edges, regulated and connected),
    for every instantiation (regulated, connected, dynamical, linear);
  - for the largest instantiation at 16 route slots, over a scan of the
    lanes up to that largest block, the most lanes (and the block's bytes)
    at which each cluster size still fits: where it is the largest block's,
    every scene ``make`` takes fits, and ``make`` needs no rule for the
    cluster's size;
  - then, through ``csrc/general_frames_global.cu``'s ``general_cluster_fit``,
    how many clusters of 1, 8 and 16 blocks of 128, 256 and 512 threads each
    of the 8 global instantiations (its kSized ones, at their ptxas
    registers; no shared memory) the card holds, and so the largest slots a
    global launch maps, 16 blocks of the most threads that fit: what
    ``general_frames.GLOBAL_SLOTS`` must not exceed;
  - then, through ``csrc/straight_frames_global.cu``'s and
    ``straight_frames_sorted_global.cu``'s ``*_cluster_fit``, the same for
    the global K1 and K3 (IDM and Linear instantiations, and K1's objects
    instantiations of both): what
    ``straight_frames.STRAIGHT_GLOBAL_SLOTS`` must not exceed.

It prints the card's name and power limit first and last.
"""

from __future__ import annotations

import itertools
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

#: the scenes over 1024 slots, (label, env id, config)
SCENES = (
    ("intersection-v0 pf 15, duration 80", "intersection-v0",
     {"policy_frequency": 15, "duration": 80}),
    ("intersection-v2 dynamical pf 15, duration 80", "intersection-v2",
     {"policy_frequency": 15, "duration": 80,
      "action": {"type": "ContinuousAction", "dynamical": True}}),
    ("exit-v0, 2047 vehicles", "exit-v0", {"vehicles_count": 2047}),
)
RANKS = tuple(range(8, 17))
#: the largest block's route slots and successor (and predecessor) edges
ROUTE, SUCC = 16, 4


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cluster_fit: CUDA is not available")
        return 1
    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.ops import general_frames as gf
    from highwayenv_tpu_torch.ops import straight_frames as sf
    from highwayenv_tpu_torch.ops import straight_sorted as ss

    print(card_line())
    props = torch.cuda.get_device_properties(0)
    print(f"{props.name}, {props.multi_processor_count} SMs")
    kernels = {
        (reg, conn, dyn): getattr(gf, f"frames_{'regulated' if reg else 'general'}"
                                      f"{'_connected' * conn}{'_dynamical' * dyn}_cluster_kernel")
        for reg, conn, dyn in itertools.product((False, True), repeat=3)
    }
    sizes = []
    for label, env_id, config in SCENES:
        env = ht.make(env_id, config, device="cpu")
        spec = env._general
        S = env.geo.succ_edge_base.shape[1]
        sizes.append((f"{label} (V={env.num_slots}, L={env.geo.num_lanes}, "
                      f"R={env.route_slots}, S={S})",
                      (env.regulated, spec.connected, spec.dynamical),
                      env.geo.num_lanes, env.route_slots, S))
    largest = max(L for L in range(1, 4096)
                  if gf.launch_smem(2048, L, ROUTE, SUCC, 1 + 2 * SUCC, True) <= gf.SMEM_LIMIT)
    sizes.append((f"largest block make takes (L={largest}, R={ROUTE}, S={SUCC})", None,
                  largest, ROUTE, SUCC))
    print("clusters a card holds at once, by cluster blocks " + ", ".join(map(str, RANKS)))
    for label, law, L, R, S in sizes:
        for key, kernel in kernels.items():
            if law is not None and key != law:
                continue
            for linear in (False, True):
                fits = [kernel.cluster_fit(r, L, R, S, linear=linear) for r in RANKS]
                print(f"  {label}, {fits[0][1]} bytes a block: {kernel.entry} "
                      f"{'Linear' if linear else 'IDM'}: {[n for n, _ in fits]}")
    # the most lanes at which each cluster size fits, for the largest
    # instantiation (regulated, connected, dynamical, Linear) at 16 route slots
    kernel = kernels[(True, True, True)]
    lanes = sorted({1, 16, 32, 64, largest} | set(range(8, largest + 1, 8)))
    print(f"  scan of {kernel.entry} Linear, R={ROUTE}, S={SUCC}, L from 1 to {largest}:")
    for r in RANKS:
        scan = {L: kernel.cluster_fit(r, L, ROUTE, SUCC, linear=True) for L in lanes}
        fit = [L for L, (n, _) in scan.items() if n > 0]
        most = max(fit) if fit else None
        counts = {f"L={L} ({scan[L][1]} bytes)": scan[L][0] for L in (1, 16, 32, 64, largest)}
        print(f"    {r} blocks: fits up to L={most}"
              + (f" ({scan[most][1]} bytes a block)" if most else "") + f"; clusters at {counts}")
    # the global library: no shared memory, so lanes and route slots change
    # nothing; the threads a block and the registers decide
    print("global K4 / K5: clusters a card holds at once, by cluster blocks 1, 8, 16 and "
          "threads a block")
    most = gf.GLOBAL_THREADS
    for reg, conn, dyn in itertools.product((False, True), repeat=3):
        kernel = getattr(gf, f"frames_{'regulated' if reg else 'general'}"
                             f"{'_connected' * conn}{'_dynamical' * dyn}_global_kernel")
        fits = {t: [kernel.cluster_fit(r, 20, 3, threads=t)[0] for r in (1, 8, 16)]
                for t in (128, 256, gf.GLOBAL_THREADS)}
        print(f"  {kernel.entry}: {fits}")
        fit = max(t for t, n in fits.items() if n[-1] > 0) if any(
            n[-1] > 0 for n in fits.values()) else 0
        most = min(most, fit)
    print(f"  slots a global launch maps on this card: 16 blocks of {most} threads = {16 * most} "
          f"(general_frames.GLOBAL_SLOTS = {gf.GLOBAL_SLOTS})")
    # the straight global K1 / K3: a block's shared memory holds the lane
    # offsets alone (4 lanes here; 17 and 64 lanes change nothing below 12 KB)
    print("straight global K1 / K3: clusters a card holds at once, by cluster blocks 1, 8, 16 and "
          "threads a block")
    smost = sf.GLOBAL_THREADS
    for kernel, objects in ((sf.frames_global_kernel, False), (sf.frames_global_kernel, True),
                            (ss.frames_sorted_global_kernel, False)):
        for linear in (False, True):
            fit_args = {"objects": True} if objects else {}
            fits = {t: [kernel.cluster_fit(r, t, 4, linear, **fit_args) for r in (1, 8, 16)]
                    for t in (128, 256, sf.GLOBAL_THREADS)}
            print(f"  {kernel.entry} {'Linear' if linear else 'IDM'}"
                  f"{' objects' if objects else ''}: {fits}")
            fit = [t for t, n in fits.items() if n[-1] > 0]
            smost = min(smost, max(fit) if fit else 0)
    print(f"  slots a straight global launch maps on this card: 16 blocks of {smost} threads = "
          f"{16 * smost} (straight_frames.STRAIGHT_GLOBAL_SLOTS = {sf.STRAIGHT_GLOBAL_SLOTS})")
    print(card_line())
    return 0 if (16 * most >= gf.GLOBAL_SLOTS
                 and 16 * smost >= sf.STRAIGHT_GLOBAL_SLOTS) else 1


if __name__ == "__main__":
    raise SystemExit(main())
