"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain versions.

Run from the repo root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, sm_90a, one
     process per source): the straight libraries first, then the six
     general ones all started together on a thread while phase 3 holds the
     straight kernels, waited for before K4's checks;
  3. each kernel against its plain torch version at highway-fast-v0
     (V=21, 5 frames) and highway-v0 full width (V=51, 15 frames), B=4096,
     and at highway-v0 with 31, 32, 63 and 100 vehicles (V = 32, 33, 64,
     101: one warp, one warp and a slot, two warps, four warps and five
     slots), B=512, and at highway-v0 under a ContinuousAction (the
     raw-control branch: the egos keep their stored steering and
     acceleration), B=4096, on four scenes each, one of which fires both band
     flags, and the Linear rows' branch at highway-v0 under the LinearVehicle
     preset (four scenes), under AggressiveVehicle and with
     change_vehicles' Linear rows on the IDM-config env (two scenes each),
     B=4096, K1 there also masked to every env: the dense frame kernel K1,
     the sort K2a, the sorted banded frames K3 with its flags, the unsort
     K2b and K1 masked by the flags, every field bit-exact; then the sorted
     step against the dense step, and the highway-v0 autoreset step of the
     main path and of highway-v0 LinearVehicle against the plain reference
     path; then
     the general frame kernel K4 at roundabout-v0 (V=5, L=32, R=11) and
     merge-v0 (V=6, L=9, an obstacle), and its Linear rows' branch at
     roundabout-v0 under AggressiveVehicle, B=4096, on the reset scene, 8
     steps in, an all-env pile-up and (merge) the obstacle hit, every field
     bit-exact, and the roundabout-v0 autoreset step against the plain
     reference path; then K4's raw-control branch at racetrack-large-v0
     (V=2, L=27), racetrack-oval-v0 with block_lane (V=10, 8 roadblocks,
     L=24), racetrack-v0 under a DiscreteAction and racetrack-v0 (V=2,
     L=18), B=4096, on the reset scene, 8 steps in and the pile-up, every
     field bit-exact, and the autoreset step of both racetrack-v0 envs
     against the plain reference path; then the regulated
     frame kernel K5 at intersection-v0
     (V=25, L=20, R=3, tick period 7), B=4096, on the reset scene, 8 steps
     in with the envs' tick phases spread over all 7 values, a conflict
     scene in which vehicles yield, and the reset's warm-up launch (V=16,
     45 frames, frame counter 0), and at the warp's edge (duration 20,
     V=32, B=512) on the reset, spread-phase and conflict scenes, every
     field bit-exact, the yielding state and the impacts included; K5's
     Linear rows' branch (DefensiveVehicle) and its raw-control branch (a
     ContinuousAction) at intersection-v0, B=4096, on the reset scene with
     the tick phases spread over all 7 values, the conflict scene and
     (raw) the warm-up launch, every field bit-exact; and the intersection-v0
     autoreset step against the plain reference path; then K4 at the
     five envs of the time-to-collision, exit and generic slice at B=4096,
     exit-v0 (V=21, L=20, 7 lanes on one edge, 5 frames: the kernel's
     32-thread group), u-turn-v0, two-way-v0, merge-generic-v0 and
     roundabout-generic-v0 (L=32), on the reset scene, 8 steps in and the
     all-env pile-up, every field bit-exact; then K4's raw-control branch
     on 14 lanes an edge at the parking family, parking-v0 (V=6, 3
     frames), parking-ActionRepeat-v0 (15 frames) and parking-parked-v0
     (V=16), B=4096, on the reset scene, 8 steps in, the pile-up and a
     scene in which the egos hit the walls, their goal landmarks and the
     parked cars, every field bit-exact; then (PR 12) the connected-lane
     search: K4's kConnected instantiation at roundabout-v1, merge-v1,
     u-turn-v1, exit-v1 (the 32-thread group) and racetrack-v1 (raw
     controls) on the reset scene, 8 steps in and the pile-up, K5's at
     intersection-v2 and intersection-multi-agent-v2 and K5 with two egos
     at intersection-multi-agent-v0 on the reset scene, 8 steps in with
     the tick phases spread, the conflict scene and the warm-up, B=4096,
     every field bit-exact, and the roundabout-v1 and intersection-v2
     autoreset steps against the plain reference path; then the
     kDynamical instantiations: K5's at intersection-v1 (V=25, the ego on
     the tire-slip model) on the reset scene with the tick phases spread,
     8 steps in, the conflict scene and the warm-up, and K4's at
     lane-keeping-v0 (V=1, L=3, 1 frame) on the reset scene, 8 steps in and
     the pile-up, each also on a scene with crashed egos and pending
     impacts and one with the egos braking across |v| = 1 and steering and
     yaw rates past their clips, B=4096, every field bit-exact (the lateral
     speed and yaw rate included), and both ids' autoreset steps against
     the plain reference path; several ego rows: K2a, K3, K2b,
     masked and dense K1 at highway-v0 with two egos (V=52, slots 0 and
     26) on the four scenes and 8 steps in, and its autoreset step against
     the plain reference path, and K4's raw branch at parking-v0 with two
     and three egos, parking-parked-v0 and racetrack-v0 with two, on the
     reset scene, 8 steps in and the pile-up (every ego crashed), every
     field bit-exact, and the autoreset steps of parking-v0 with three and
     racetrack-v0 with two (one reward an env) against the plain
     reference path; make() on the card
     refusing configs beyond the kernels' arrays (17 target speeds, 17
     straight lanes, 1101 general slots, 12 connected-lane candidates a
     lane, a poly lane, the
     last also under ``sequential_decisions``) and exit-v0 with two
     controlled vehicles, naming the limit; to_finite_mdp of a B=1 and
     a B=8 highway-v0 state on CUDA against the same call on the CPU; then
     on highway-v0, roundabout-v0, intersection-v0, racetrack-v0,
     highway-v0 LinearVehicle, u-turn-v0, exit-v0 (is_success too) and
     parking-v0 (the KinematicsGoal dict observation, field by field, and
     is_success), intersection-multi-agent-v0 (the tuple observation,
     element by element), intersection-v1 and lane-keeping-v0 (the
     AttributesObservation dict key by key; its rows 1 to 8 steps short of
     their 200-step truncation), B=4096, from a batch
     with every 8th ego crashed, the compact autoreset (reset_slots P =
     1024, and 64, which takes further passes) against the full one over 3
     steps, and CapturedStep replays against eager steps over 4 (full, P =
     1024, P = 64, and with final_obs full and at P = 64) from one cloned
     state and generator: obs, every field, reward and flags bit-exact, the
     generators equal at the end;
  4. the main paths: make("highway-v0") on CUDA, reset B=4096 and a random
     policy rollout with autoreset through the sorted step, each kernel's
     launch count checked, and a few steps of the dense path
     (sorted_frames=False); then make("roundabout-v0") on CUDA, B=4096, a
     random-policy rollout through K4 (one launch per policy step); then
     make("intersection-v0") on CUDA, B=4096, reset and a random-policy
     rollout through K5 (two launches per policy step, the step's frames
     and the warm-up of the reset drawn every step, plus one for the first
     reset), with the ended, crashed and arrived episodes counted; then the
     raw-control paths: make() of racetrack-large-v0, racetrack-oval-v0
     (block_lane) and racetrack-v0, B=4096, reset and a rollout under
     U(-1, 1) steering through K4 (one launch per policy step), and
     highway-v0 under a ContinuousAction through the sorted step; then the
     Linear slice's paths, each with the counts set to 0 just before it:
     highway-v0 LinearVehicle through the sorted step (its main path),
     roundabout-v0 AggressiveVehicle through K4, intersection-v0
     DefensiveVehicle and intersection-v0 ContinuousAction through K5
     (reset and rollout); then the slice's five paths, each with the counts set to
     0 just before it: merge-generic-v0, roundabout-generic-v0,
     two-way-v0, u-turn-v0 and exit-v0, B=4096, reset and a rollout
     through K4 (one launch per policy step); then the parking family's
     three paths in the same way, every 8th ego crashed at the start; then
     (PR 12) roundabout-v1, intersection-v2 and intersection-multi-agent-v0
     the same way, eager and through a CapturedStep, and 4 captured steps
     at each other new id, the counts of each instantiation read after
     each (one connected K4 launch a step, or K5's two, and none of the v0
     instantiation at a connected id) and a profile of replays; then
     intersection-v1 and lane-keeping-v0 the same way, eager and
     captured, through K5's and K4's kDynamical instantiations (K5's twice
     a step: the step and the warm-up of the reset batch), none of any
     other instantiation; then
     the sixteen rollouts (the seven, highway-v0 LinearVehicle, the
     slice's five and the parking family) again with each step one replay
     of a CapturedStep (the kernels' counts cover the warm-up step and the
     capture), and a profile of replays for the port's kernels per replay;
     then highway-v0 with two egos through the sorted step and the
     four several-ego K4 configs (every 8th first ego crashed at the
     start), each with the counts set to 0 just before it; (after phase
     5's times and before phase 6) the GrayscaleObservation path:
     highway-v0 (V=51) at 1024 rows with HighwayEnv's documented example
     config, the counts set to 0 just before an 8-step rollout (K1, K2a,
     K3, K2b once a step, nothing else), the CUDA frames of 64 rows against
     the CPU's plain frames of the same states (at least 99.9% of each
     frame's pixels equal, none off by more than a gray level), compact
     (P=256) against full and the captured full step against the eager
     one, the stack included, bit-exact, eager and graph ms per step (three
     runs each, in turns), a profile of replays, the step's peak device
     memory (at most 4 GB: 16 GB at 4,096 rows), K1–K3 against their plain versions on its
     reset scene, and the kernel rows "K1 grayscale" .. "K2b grayscale"
     (its launches beside the main path's times); intersection-v0 (K5)
     and racetrack-v0 (K4 raw) the same way at B=512 and 8 steps, without
     the times; ``render_rgb`` of row 0 of a
     CUDA state against its CPU copy; ``sequential_decisions`` at
     highway-v0, u-turn-v0 and intersection-v0, B=64: the reset's scenes
     (the warm-up included) and 2 steps' frames on CUDA against the CPU,
     discrete fields equal, pos within 2e-4 m, no frame kernel launched,
     ms per step; then the robust-control tools:
     ``observer_step_batch`` at 4,096 observers on intersection-v0's lanes
     and on poly lanes, without and with fronts, CUDA against the CPU
     within 1e-5 of magnitude, its device and back-to-back ms; ``lpv_step``
     at 4,096 systems (the observer's longitudinal LPV, its lateral one
     and the lateral one in its eigenbasis) over 20 steps within 1e-6,
     TF32 off; the poly lane ops on 4,096 points a lane (pose indices
     equal, values within 1e-5); ``set_route_at_intersection`` on a
     B=4096 intersection-v0 batch for every option and ``"random"``, equal
     to its CPU copy's, then 8 steps of the rerouted batch through K5 (K5
     once a step, nothing else; 4 of them bit-exact against the plain
     path) and a ``MultipleModelTracker`` on row 0 over them, equal to one
     over their CPU copies, with its host ms per ``act``; then the
     multi-device layer (``parallel/sharding.py``) on the one card: an
     NCCL group of world size 1 and ``make_mesh()``, (a)
     ``sharded_rollout_fn`` at highway-v0, B=4096, 8 steps, eager, captured
     and compact (P=1024), (b) two 2048-row shards on the card at
     highway-v0 and intersection-v0, eager and captured, (c)
     ``pooled_rollout_fn`` at intersection-v0 (bank 64); every shard's
     state bit-exact against the one-card loop on its rows and generator,
     the metrics bit-exact, the counts set to 0 just before each run (K1,
     K2a, K3, K2b once a step a shard; K5 twice; a capture counts its
     warm-up and itself; the pooled step's K5 and a one-row warm-up a
     step, nothing else), ms per step against one card in turns; the
     eager full runs of (a), (b) and (c) have kernel rows of their own
     ("K1 sharded" .. "K2b sharded", "K1 two shards" .. "K2b two shards",
     "K5 step two shards", "K5 warm-up two shards", "K5 step pooled", "K5
     warm-up pooled"): the launches of their own run, each kernel held
     against its plain version on inputs that run gave it, the times and
     bound of the main path's row of the kernel; then the scenes
     over the narrow kernels' 32 slots and 32 lanes (``check_wide``):
     intersection-v0, -v2 and -v1 with duration 30 (V=42: the wide K5,
     connected and dynamical), exit-v0 with 50 vehicles and exit-v1 (V=51:
     the wide K4 and its connected twin), racetrack-v0 with 40 NPCs (V=41:
     the wide K4 raw, and dynamical), intersection-v0 with duration 116
     (V=128, 61.0 KB of shared memory a block) and racetrack-oval-v0 with 6
     lanes (L=48: the narrow K4 raw), 256 rows, each instantiation against its
     plain version on 8 steps in (K5: the tick phases spread), the
     conflict scene and the warm-up or the all-env pile-up, every field
     bit-exact; the six row scenes driven 8 steps with the counts set to 0
     (the instantiation once a step, the narrow K5 once more for each
     reset's 16-slot warm-up, nothing else), timed from a fresh reset, each
     a kernel row of its own ("K5 wide step", "K5 wide connected", "K5 wide
     dynamical", "K4 wide", "K4 wide raw", "K4 raw 48 lanes"); compact
     against full and captured against eager at intersection-v0 with
     duration 30, and its eager and captured full steps in turns; then the scenes over the wide kernels'
     128 slots (``check_cluster``): intersection-v0, -v2 and -v1 at
     policy_frequency 15 (V=207, two blocks a cluster: the cluster K5,
     connected and dynamical), exit-v0 and exit-v1 with 150 vehicles
     (V=151: the cluster K4 and its connected twin), racetrack-v0 with 150
     NPCs (V=151: the cluster K4 raw, and dynamical) and intersection-v0
     with duration 60 at policy_frequency 15 (V=912, eight blocks), each
     instantiation against its plain version at 64 rows (8 at V=912) on
     the scenes of check_wide, on twins across the first rank boundary
     (``tied``) and, on the regulated road, on the 8-steps-in and conflict
     scenes with the slots rolled across a rank boundary, every field
     bit-exact; the six row scenes driven 8 steps at B=4096 with the counts
     set to 0 (the cluster instantiation once a step, the narrow K5 once
     more for each reset's warm-up, nothing else), each timed at B=4096, a
     kernel row of its own ("K5 cluster step", "K5 cluster connected", "K5
     cluster dynamical", "K4 cluster", "K4 cluster connected", "K4 cluster
     dynamical"), its plain version over the same rows in chunks; compact
     against full and captured against eager at intersection-v1 with
     policy_frequency 15; and the wide K5 at 128 slots timed ("K5 wide 128
     slots", its row at 1024 rows); then a dynamical action under the connected-lane search
     (``check_connected_dynamical``): the connected dynamical K4 / K5 at
     racetrack-v1 (V=2) and exit-v1 (V=21), intersection-v2 (V=25), exit-v1
     with 50 vehicles and intersection-v2 with duration 30 (wide), exit-v1
     with 150 vehicles and intersection-v2 at policy_frequency 15 (cluster),
     each against its plain version on the scenes of check_cluster (256
     rows, 64 on the cluster), every field bit-exact; at the slice's path
     (intersection-v2 and racetrack-v1 with a dynamical ContinuousAction,
     driven in phase 4 with the other paths: reset and 32 autoreset steps
     at B=4096 eager and captured with the counts set to 0, the
     instantiation once a step, the K5 once more a warm-up, nothing else, a
     profile of the replays) the captured step against the eager one
     bit-exact; a kernel row each ("K4
     connected dynamical" .. "K5 cluster connected dynamical"); then the
     scenes over 1024 slots (``check_large_clusters``): intersection-v0
     and -v2 (dynamical) at policy_frequency 15 with duration 80 (V=1212,
     10 blocks a cluster) and exit-v0 with 2047 vehicles (V=2048, 16
     blocks), the clusters of that size the card holds at once, each
     against its plain version at 8 rows (twins across every rank
     boundary), driven 2 steps at B=4096 with the counts set to 0, its
     launch timed at B=4096 and a kernel row at 32 or 16 rows ("K5
     cluster 1212 slots", "K4 cluster 2048 slots", "K5 cluster connected
     dynamical 1212 slots"); then the scenes that no layout of shared
     memory holds (``check_global``): exit-v0 with 100 lanes and 100
     vehicles (L=302, V=101: a block over 227 KB), exit-v0 with 4095 and
     8191 vehicles (V=4096, 8192: 16 blocks of 256 and 512 threads) and
     intersection-v0 at policy_frequency 15 for 140 s (V=2112), on the
     global K4 / K5, the slab's words of every global entry held to the
     library's count, each held to its plain version (16, 2 or 1 rows,
     twins across every chunk boundary), driven 2 steps with the counts
     set to 0 (at 4096, 256, 64 and 512 rows), timed there with the slab's
     bytes and the peak device memory, a kernel row each at 256, 4, 1 and
     8 rows ("K4 global 302 lanes", "K4 global 4096 slots", "K4 global
     8192 slots", "K5 global"), the 302-lane scene's captured step against
     the eager one; every other global entry (connected, dynamical, both),
     the Linear branch and poly lanes held to their plain versions at
     exit-v0 / exit-v1 / PolyExit with 100 lanes and intersection-v0 / -v1
     / -v2 for 140 s; then the straight scenes one block cannot hold
     (``check_straight_global``): highway-v0 with 2047, 4095 and 8191
     vehicles, with 32 lanes and 1023 (a block over 227 KB), with 4 egos
     and 1200, highway-fast-v0 with 1024, LinearVehicle and
     ContinuousAction at 2047, on the global K1 and K3 (picked by
     ``*_kernel_for``) and K2a and K2b, the slab's words held to the
     libraries' counts, every kernel held bit-exact to its plain version (1
     to 4 rows, a pile-up across every block boundary), the 2048- and
     8192-slot highways driven 3 and 2 steps at 4096 and 64 rows with the
     counts set to 0 (the band firing share), the 2048-slot highway's
     captured step against the eager one (2 steps at 256 rows), kernel rows
     at 16 and 1 rows ("K1 global 2048 slots" .. "K2b global 8192 slots");
     then
     the roads the fixed tables once refused
     (``check_custom_roads``: a junction of 5 successor edges with two poly
     lanes and an 18-slot route, 5 and 10 predecessor edges under the
     connected search, roundabout-v0 with 17 and 31 target speeds, the
     72-lane oval, the kSized K5 and K4 of every layout, highway-v0 with 17
     lanes), each held to its plain version at 256, 128 or 64 rows, the
     driven ones 4 steps with the counts set to 0 and 4 captured steps
     against eager at B=4096, with a kernel row at B=4096; then obstacles,
     landmarks and plain Vehicle rows on a straight road
     (``check_objects``, the scenes of ``tools/object_scenes.py``): K1's
     four objects instantiations (IDM and Linear, block and global) held
     bit-exact to the plain frames at B=4096 and at 2047 vehicles (4 rows,
     objects piled across every block boundary), ``make("highway-v0",
     lean=False)`` and its LinearVehicle and 2048-slot twins driven with
     the counts set to 0 (one K1 launch a step, no K2a, K3 or K2b), three
     autoreset steps against the plain reference path and 4 captured steps
     against eager, the lean K3 trapping on an obstacle row in a child
     process (exit 3), and the rows "K1 objects", "K1 objects linear" and
     "K1 objects global 2048 slots", each beside the lean K1 on the same
     vehicles;
  5. times on the card: each kernel's time (CUDA events around launches
     queued behind a device-side wait), its plain version's time (CUDA
     events, the host's gaps between its kernels included), its bound and
     the PyTorch yardstick's device time (torch.profiler) where there is
     one, with the wall time of a call (CUDA events), K4 at racetrack-v0
     and K3 and K1 at highway-v0 ContinuousAction among them, their
     bounds without the egos' P-cascade, and the Linear rows' branches (K3
     and K1 at highway-v0 LinearVehicle, K4 at roundabout-v0
     AggressiveVehicle, K5's step at intersection-v0 DefensiveVehicle) and
     K5's raw-control branch (intersection-v0 ContinuousAction), their
     bounds with the linear laws' operations, and K4 at exit-v0,
     u-turn-v0 and the three parking ids (raw controls; the timed
     launch's output held bit-exact to the plain version's), and (PR 12)
     the connected K4 at roundabout-v1 and K5 at intersection-v2, each
     beside the v0 instantiation's time on the same scene, and the
     dynamical K5 at intersection-v1 and K4 at lane-keeping-v0, each beside
     the v0 instantiation's raw branch on the same scene, and K2a,
     K3, K2b and K1 at highway-v0 with two egos (V=52) and K4's raw branch
     at parking-v0 with three egos and racetrack-v0 with two; the
     simulation of a
     sorted and a dense policy step; the sorted and dense rollouts in
     turns; and ms per step of
     the three envs, eager against graph, full autoreset, three runs each
     in turns, with the device busy time per step, a reset placement's
     device time and the host's time to issue a replay, full and compact
     P=1024; then at highway-v0 with two egos, parking-v0 with two
     and three, parking-parked-v0 and racetrack-v0 with two, highway-v0
     under LidarObservation and under the shuffled Kinematics order, the
     captured full autoreset step against the eager one (obs part by part,
     every field, the generators equal after the replays: the shuffled
     order's permutations are drawn from the registered generator) and
     eager against graph ms per step, three runs each in turns, with the
     device busy time and kernels per step;
  6. the single-env seeded path: every
     registered id (31) on CUDA at its registered config, B=1,
     ``reset_seeded`` (the reference's NumPy draw order on the host, the
     intersection ids' warm-up one K5 launch) and 4 steps of
     ``step_batched``, what the Gymnasium ``GymEnv`` calls, the counts set
     to 0 just before each id: K2a, K3, K2b and masked K1 once a step at
     the straight ids, the id's K4 instantiation once a step, the id's K5
     instantiation once a step and once for the warm-up, none of any
     other; at the first id of each instantiation the same reset and steps
     with every kernel stood in for by its plain version (``PlainKernels``)
     bit-exact (obs, every field, reward, flags, info); the host ms of the
     seeded reset and of a B=1 eager step per id.

Exits non-zero on any failed check, and without CUDA.  The last lines are
the kernels JSON, the card line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout

B = 4096  # envs, the batch the JAX package's bench drives
EDGE_B = 512  # envs of the warp-boundary highway-v0 checks
EDGE_VEHICLES = (31, 32, 63, 100)  # V = 32, 33, 64, 101
EDGE_DURATION = 20  # intersection-v0 with V = 32, a full warp
HORIZON = 32  # policy steps of the main-path rollout
#: highway-v0 under a ContinuousAction: K1's and K3's raw-control branch
CONTINUOUS_CONFIG = {"action": {"type": "ContinuousAction"}}
NPC = "highway_env.vehicle.behavior."
# the Linear-family NPC presets (the kernels' Linear rows' branch)
LINEAR_CONFIG = {"other_vehicles_type": NPC + "LinearVehicle"}
AGGRESSIVE_CONFIG = {"other_vehicles_type": NPC + "AggressiveVehicle"}
DEFENSIVE_CONFIG = {"other_vehicles_type": NPC + "DefensiveVehicle"}
#: racetrack-v0 under a DiscreteAction on both axes: the same raw-control branch
DISCRETE_CONFIG = {"action": {"type": "DiscreteAction"}}
#: the racetrack family (K4's raw-control branch); the oval with roadblocks
RACETRACKS = (("racetrack-large-v0", None), ("racetrack-oval-v0", {"block_lane": True}),
              ("racetrack-v0", None))
CRASH_HORIZON = 4  # policy steps of the extra rollout from a compressed scene
DENSE_HORIZON = 4  # policy steps of the dense path (sorted_frames=False)
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_OPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# Tolerances of kernel against plain, the same as the CPU tests hold the
# plain version to the JAX package: pos absolute 2e-4 m; other continuous
# fields 1e-4 times the field's magnitude.  The kernels are built without
# FMA contraction, so they are expected to agree far inside them.  The
# sorted step against the dense one: a few ulp at the field's magnitude
# (the banded pass puts a pair's lower rank first in the SAT, the dense
# pass its lower slot), the bound tests/test_batched_step.py holds the JAX
# sorted path to.
POS_ATOL = 2e-4
REL_TOL = 1e-4
ULP_BOUND = 32.0 * float(np.finfo(np.float32).eps)
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending")
CONTINUOUS = ("pos", "heading", "speed", "timer", "impact", "steering", "accel")
SCENES = ("normal", "compressed", "pileup", "pileup_all")

# float32 operations per unit of frame work, counted from the frame's
# arithmetic (ops/straight_frames.py, csrc/straight_common.cuh); a libm call
# counts as one operation.  Used for the bounds only.
OPS_SLOT = 160  # per live slot: projection, own IDM, steering, integration
OPS_NEIGH_PAIR = 9  # per (slot, occupiable other): 3 lanes x (sub, abs, cmp)
OPS_DECIDING = 274  # per MOBIL-deciding slot: 8 more IDM + incentive tests
OPS_ABORT_PAIR = 13  # per (lane-changing IDM slot, other slot)
OPS_SPHERE = 11  # per collision-eligible unordered pair
OPS_SAT = 210  # per pair within reach: the folded swept SAT
# the ego's P-cascade within OPS_SLOT (steering law and speed control),
# which a raw-control ego (ContinuousAction) does not run
OPS_EGO_CONTROLS = 28
# a Linear row's laws in place of IDM's: per acceleration of a row pair
# three products and two mins where IDM takes OPS_IDM_PAIR, and for its
# steering two products where the P-cascade's steering takes
# OPS_STEER_PC (OPS_EGO_CONTROLS less the speed control's two)
OPS_IDM_PAIR = 25
OPS_LINEAR_ACCEL = 5
OPS_STEER_PC = OPS_EGO_CONTROLS - 2
OPS_LINEAR_STEER = 2
# the evaluations of a row pair's acceleration per live slot (its own) and
# per MOBIL-deciding slot (OPS_DECIDING's 8)
EVALS_SLOT, EVALS_DECIDING = 1, 8
# the fields only a Linear row's thread reads
PARAM_FIELDS = ("accel_params", "steer_params")
# the sorted frame's extras, per live slot: one step of a far-band scan
# (per lane, direction and round: a compare and a select), one step of the
# collision-band scan (per round: two min / max of s, two max), and the
# far-band queries and the band-violation test
OPS_SCAN_STEP = 2
OPS_COLL_SCAN_STEP = 4
OPS_FAR_QUERY = 16

# The general frame (ops/general_frames.py, csrc/general_frames.cu), in the
# same units.  Per (live slot, lane) and frame: the local coordinates on a
# straight / sine / circular lane (the projection table), and the lane
# heading at s plus the closest-lane distance (re-localization).
GEN_OPS_PROJECT = (8, 13, 16, 4)
GEN_OPS_RELOCATE = (6, 13, 11, 13)
# on a poly lane the projection also scans pose samples back from the last
# until one projects forward: per sample scanned, 2 differences, 2 products,
# a sum and the test (the 4 of GEN_OPS_PROJECT: k + proj and the lateral
# offset)
GEN_OPS_POLY_SAMPLE = 6
GEN_OPS_SLOT = 120  # per live slot: lane-end test, rows, steering, integration
# the ego's P-cascade within GEN_OPS_SLOT (the steering law toward the
# target lane's heading ahead, and the speed control), which a raw-control
# ego (ContinuousAction) does not run
GEN_OPS_EGO_CONTROLS = 32
GEN_OPS_IDM = 25  # per IDM acceleration of a row pair
GEN_OPS_STEER_PC = GEN_OPS_EGO_CONTROLS - 2  # the P-cascade's steering
GEN_OPS_NEIGH_PAIR = 10  # per (neighbour query, other slot): eligibility, min / max
GEN_OPS_ABORT_PAIR = 13  # per (lane-changing IDM slot, other slot)
GEN_OPS_EDGE_LANE = 17  # per lane next_lane measures at a lane end
GEN_HORIZON = 32  # policy steps of the roundabout-v0 main-path rollout
GEN_CONTINUOUS = CONTINUOUS + ("target_speed",)
# The regulated block (road/regulation.py, the kRegulated path of
# csrc/general_frames.cu), in the same units, on a tick frame: per live
# vehicle the route walk (per route segment) and one prediction (per time:
# the segment search, the lane position and heading, cos and sin); per
# unordered pair of vehicles and time the closeness test; per close (pair,
# time) the 18 probe points; per conflicting pair the yield decision.
REG_OPS_SEGMENT = 10
REG_OPS_TIME = 25
REG_OPS_CLOSE = 5
REG_OPS_PROBES = 18 * 20
REG_OPS_YIELD = 10
INT_HORIZON = 32  # policy steps of the intersection-v0 main-path rollout
#: the five envs of the slice of the time-to-collision and exit observations
#: and the generic roads, which the JAX package steps on K4, each checked,
#: driven and timed at B: exit-v0 runs the kernel's 32-thread group (V=21)
SLICE_ENVS = ("exit-v0", "u-turn-v0", "two-way-v0", "merge-generic-v0",
              "roundabout-generic-v0")
#: the slice's envs with a K4 row of their own in the kernels line: the
#: 32-thread group (exit-v0) and the circular U-turn (u-turn-v0)
SLICE_ROWS = ("exit-v0", "u-turn-v0")
#: the parking family: K4's raw-control branch on 14 lanes an edge (V=6, 6
#: and 16; 3, 15 and 3 frames), each checked, driven, timed and with a K4
#: row of its own at B
PARKING_ENVS = ("parking-v0", "parking-ActionRepeat-v0", "parking-parked-v0")
#: configs beyond what the kernels take, each (env id, config, the limit
#: named): the slots of the largest layouts (the global straight kernels'
#: 8192, the global K4 / K5's 8192), one target speed, several egos where
#: the env has one, a dynamical action on a straight road (the scenes past
#: the block or cluster kernels' slots or a block's shared memory take the
#: global layouts: check_global, check_straight_global)
OVER_LIMITS = (
    ("merge-v0", {"action": {"type": "DiscreteMetaAction", "target_speeds": [25.0]}},
     "1 target speeds < 2"),
    ("highway-fast-v0", {"vehicles_count": 8192}, "8193 slots > 8192"),
    ("exit-v0", {"vehicles_count": 8192}, "8193 slots > 8192"),
    ("exit-v0", {"controlled_vehicles": 2}, "several controlled vehicles"),
    ("highway-v0", {"action": {"type": "ContinuousAction", "dynamical": True}},
     "a dynamical action on a straight road"),
)
#: the connected-lane search (PR 12): K4's kConnected instantiation held to
#: its plain version at these ids (exit-v1: the 32-thread group; racetrack-v1:
#: raw controls), K5's at intersection-v2 and, with two egos, at
#: intersection-multi-agent-v0 (K5 as it is) and -v2 (kConnected)
CONNECTED_K4 = ("roundabout-v1", "merge-v1", "u-turn-v1", "exit-v1", "racetrack-v1")
REGULATED_12 = ("intersection-v2", "intersection-multi-agent-v0",
                "intersection-multi-agent-v2")
#: the slice's ids driven HORIZON steps, eager and captured, with a row of
#: eager against captured ms; every other new id takes CONNECTED_SHORT
#: captured steps
CONNECTED_ROLLOUTS = ("roundabout-v1", "intersection-v2", "intersection-multi-agent-v0")
CONNECTED_OTHERS = ("merge-v1", "merge-generic-v1", "u-turn-v1", "exit-v1",
                    "roundabout-generic-v1", "racetrack-v1", "racetrack-large-v1",
                    "racetrack-oval-v1", "intersection-multi-agent-v2")
CONNECTED_SHORT = 4
#: the general path's wrappers in ops/general_frames.py and the demangled
#: names of their IDM instantiations of the fixed layout in a profile
#: (kRegulated, kLinear, kConnected, kDynamical, kSized)
GENERAL_PATHS = {
    "K4": ("frames_general_kernel", "general_frames_kernel<false, false, false, false, false>"),
    "K4 connected": ("frames_general_connected_kernel",
                     "general_frames_kernel<false, false, true, false, false>"),
    "K5": ("frames_regulated_kernel", "general_frames_kernel<true, false, false, false, false>"),
    "K5 connected": ("frames_regulated_connected_kernel",
                     "general_frames_kernel<true, false, true, false, false>"),
    "K4 dynamical": ("frames_general_dynamical_kernel",
                     "general_frames_kernel<false, false, false, true, false, DynFields>"),
    "K5 dynamical": ("frames_regulated_dynamical_kernel",
                     "general_frames_kernel<true, false, false, true, false, DynFields>"),
    "K4 wide": ("frames_general_wide_kernel",
                "general_frames_wide_kernel<false, false, false, false, false>"),
    "K4 wide connected": ("frames_general_connected_wide_kernel",
                          "general_frames_wide_kernel<false, false, true, false, false>"),
    "K5 wide": ("frames_regulated_wide_kernel",
                "general_frames_wide_kernel<true, false, false, false, false>"),
    "K5 wide connected": ("frames_regulated_connected_wide_kernel",
                          "general_frames_wide_kernel<true, false, true, false, false>"),
    "K4 wide dynamical": ("frames_general_dynamical_wide_kernel",
                          "general_frames_wide_kernel<false, false, false, true, false, DynFields>"),
    "K5 wide dynamical": ("frames_regulated_dynamical_wide_kernel",
                          "general_frames_wide_kernel<true, false, false, true, false, DynFields>"),
    "K4 cluster": ("frames_general_cluster_kernel",
                   "general_frames_cluster_kernel<false, false, false, false, false>"),
    "K4 cluster connected": ("frames_general_connected_cluster_kernel",
                             "general_frames_cluster_kernel<false, false, true, false, false>"),
    "K5 cluster": ("frames_regulated_cluster_kernel",
                   "general_frames_cluster_kernel<true, false, false, false, false>"),
    "K5 cluster connected": ("frames_regulated_connected_cluster_kernel",
                             "general_frames_cluster_kernel<true, false, true, false, false>"),
    "K4 cluster dynamical": ("frames_general_dynamical_cluster_kernel",
                             "general_frames_cluster_kernel<false, false, false, true, false, DynFields>"),
    "K5 cluster dynamical": ("frames_regulated_dynamical_cluster_kernel",
                             "general_frames_cluster_kernel<true, false, false, true, false, DynFields>"),
    "K4 connected dynamical": ("frames_general_connected_dynamical_kernel",
                               "general_frames_kernel<false, false, true, true, false, DynFields>"),
    "K5 connected dynamical": ("frames_regulated_connected_dynamical_kernel",
                               "general_frames_kernel<true, false, true, true, false, DynFields>"),
    "K4 wide connected dynamical": (
        "frames_general_connected_dynamical_wide_kernel",
        "general_frames_wide_kernel<false, false, true, true, false, DynFields>"),
    "K5 wide connected dynamical": (
        "frames_regulated_connected_dynamical_wide_kernel",
        "general_frames_wide_kernel<true, false, true, true, false, DynFields>"),
    "K4 cluster connected dynamical": (
        "frames_general_connected_dynamical_cluster_kernel",
        "general_frames_cluster_kernel<false, false, true, true, false, DynFields>"),
    "K5 cluster connected dynamical": (
        "frames_regulated_connected_dynamical_cluster_kernel",
        "general_frames_cluster_kernel<true, false, true, true, false, DynFields>"),
    **{f"{road} global{law}": (
        f"frames_{kind}{sfx}_global_kernel",
        f"general_frames_global_kernel<{reg}, true, {conn}, {dyn}, true"
        + (", DynFields>" if dyn == "true" else ">"))
       for road, kind, reg in (("K4", "general", "false"), ("K5", "regulated", "true"))
       for law, sfx, conn, dyn in (("", "", "false", "false"),
                                   (" connected", "_connected", "true", "false"),
                                   (" dynamical", "_dynamical", "false", "true"),
                                   (" connected dynamical", "_connected_dynamical", "true",
                                    "true"))},
}
#: the ids of the dynamical ContinuousAction: K5's and K4's
#: kDynamical instantiations
DYNAMICAL_IDS = ("intersection-v1", "lane-keeping-v0")
#: per ego row and frame of a dynamical spec: one RK4 step of the tire-slip
#: model, four derivatives of 27 operations (two atan2f, cosf, sinf each
#: counted as one) and the 78 of the stage sums, and the two clips
DYN_OPS_RK4 = 4 * 27 + 78 + 4
#: per query and candidate lane of the connected walk: the candidate and its
#: offset loaded, the seen mask applied and merged
GEN_OPS_CONN_LANE = 4
#: policy steps of each id's single-env drive, from its seeded reset
SINGLE_STEPS = 4
#: GrayscaleObservation, HighwayEnv's documented example config
GRAY_CONFIG = {"observation": {"type": "GrayscaleObservation", "observation_shape": (128, 64),
                               "stack_size": 4, "weights": [0.2989, 0.5870, 0.1140],
                               "scaling": 1.75}}
GRAY_B = 1024  # envs of the highway-v0 Grayscale path (cut from B for the time limit)
GRAY_SMALL_B = 512  # envs of the intersection-v0 and racetrack-v0 Grayscale checks
GRAY_SMALL_STEPS = 8  # policy steps of their rollouts
GRAY_CPU_ROWS = 64  # rows of a CUDA frame batch held to the CPU's frames
GRAY_MIN_EQUAL = 0.999  # share of a frame's pixels equal, CUDA against the CPU
GRAY_MAX_LEVELS = 1  # gray levels a pixel may differ by, CUDA against the CPU
GRAY_MAX_BYTES = 16e9  # the Grayscale step's peak device memory at B=4096, pro rata at GRAY_B
#: the reference's decision order: ids, envs and policy steps of its checks
SEQ_IDS = ("highway-v0", "u-turn-v0", "intersection-v0")
SEQ_B = 64
SEQ_STEPS = 2
COMPACT_SLOTS = (1024, 64)  # reset slots P: one pass a step, and further passes
COMPACT_STEPS = 3  # autoreset steps of compact against full
GRAPH_STEPS = 4  # steps of the captured step against the eager one
CRASH_EVERY = 8  # every 8th ego crashed at the start: 512 done rows at B=4096
PROFILE_REPLAYS = 2  # replays of a captured step under the profiler
TIMED_STEPS = 4  # steps of each timed eager / graph, full / compact run
#: timed runs of a frame kernel's plain version in the kernel table, after
#: one warm-up (a yardstick; each run is tens to hundreds of ms)
PLAIN_REPS = 1


STRAIGHT_LIBRARIES = ["straight_frames", "straight_sort", "straight_frames_sorted",
                      "straight_frames_global", "straight_frames_sorted_global"]
GENERAL_LIBRARIES = ["general_frames", "general_frames_wide", "general_frames_cluster",
                     "general_frames_sized", "general_frames_wide_sized",
                     "general_frames_cluster_sized", "general_frames_global"]


def build_in_background(_build, names):
    """Start ``_build.build(names)`` on a thread (its nvcc processes all
    started together) and return a function that waits for it and returns
    its paths, raising its error."""
    box = {}

    def work():
        try:
            box["paths"] = _build.build(names)
        except BaseException as e:
            box["error"] = e

    thread = threading.Thread(target=work, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["paths"]

    return wait


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean time of ``fn()`` between CUDA events over ``reps`` runs, after
    one warm-up (without ``warmup``: ``fn`` ran just before): the device
    time when the device is the limit, else the host's time to issue the
    calls."""
    if warmup:
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


def queued_ms(fn, reps: int, wait_cycles: int = 200_000_000) -> float:
    """Device time of one ``fn()`` from CUDA events around ``reps`` runs
    queued behind a device-side wait (``torch.cuda._sleep``, ``wait_cycles``:
    ~0.1 s at the H100's clock by default) long enough for the host to issue
    them all, so the events bracket the kernels back to back and no host
    gap.  ``fn`` must not synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(wait_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_events(prof, name: str):
    """The profile's device events of the kernel ``name`` (the demangled
    symbol: "name(" or "void name<...>(", any instantiation; a name that
    ends inside the template arguments, "name<false,", picks those that
    begin so)."""
    pattern = re.compile(r"(^|\s)" + re.escape(name) + r"[<(, ]")
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and pattern.search(e.key)]


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: the self device time of every kernel it
    launches, summed, from torch.profiler over ``reps`` runs after one
    warm-up.  Unlike CUDA events it leaves out the gaps in which the host
    issues the calls, which exceed a small kernel's own time.  The profiler
    drops a share of the launches on the H100 machine (it recorded 2 to 49
    of 20 to 50 launches of one kernel), so a kernel's own time is taken
    with ``queued_ms`` and this serves only sums over many kernels (the
    plain versions, a step's device busy time).  It records the device's
    activity alone: the host's ops add nothing to the sum and, for a plain
    version's tens of thousands of kernels, take two to three times as long
    to record (``tools/profiler_activities.py``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / reps / 1e3


def scenes(veh):
    """normal / compressed (x * 0.2: immediate collisions) / pile-up (20
    vehicles in 6 m) in env 0 / pile-up in every env, as
    tests/test_batched_step.py builds them."""
    compressed = veh.pos.clone()
    compressed[..., 0] *= 0.2
    ramp = 100.0 + torch.linspace(0, 6, 20, device=veh.pos.device)
    pileup = veh.pos.clone()
    pileup[0, :20, 0] = ramp
    pileup_all = veh.pos.clone()
    pileup_all[:, :20, 0] = ramp
    return {
        "normal": veh,
        "compressed": veh.replace(pos=compressed),
        "pileup": veh.replace(pos=pileup),
        "pileup_all": veh.replace(pos=pileup_all),
    }


def compare(a, b, where: str, fields=CONTINUOUS, quiet=False) -> float:
    """Discrete fields equal, continuous within tolerance; returns the max
    absolute error over the continuous fields."""
    for name in DISCRETE:
        x, y = getattr(a, name), getattr(b, name)
        n_bad = int((x != y).sum())
        if n_bad:
            raise AssertionError(f"{where}: {name} differs in {n_bad} entries")
    worst = 0.0
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{where}: {name} has non-finite values")
        err = float((x.double() - y.double()).abs().max())
        tol = POS_ATOL if name == "pos" else REL_TOL * max(
            1.0, float(y.abs().max())
        )
        if not quiet:
            print(f"  {where} {name}: max |kernel - plain| = {err:.3e} (tol {tol:.1e})")
        if err > tol:
            raise AssertionError(f"{where}: {name} error {err} > {tol}")
        worst = max(worst, err)
    return worst


def exact(a, b, fields, where: str) -> None:
    """Bit-exact equality of the named fields."""
    bad = [n for n in fields if not torch.equal(getattr(a, n), getattr(b, n))]
    if bad:
        raise AssertionError(f"{where}: fields differ: {bad}")


def exact_state(a, b, where: str) -> float:
    """Every field of two states bit-exact; returns the max absolute
    difference over the continuous fields (0.0 when they are)."""
    import dataclasses

    exact(a, b, [f.name for f in dataclasses.fields(a)], where)
    return max(float((getattr(a, n).double() - getattr(b, n).double()).abs().max())
               for n in CONTINUOUS)


def compare_steps(a, b, where: str) -> bool:
    """Sorted step against dense step: discrete equal, continuous within a
    few ulp at the field's magnitude; returns whether they agree bitwise."""
    compare(a, b, where, fields=(), quiet=True)
    bitwise = True
    for name in CONTINUOUS:
        x, y = getattr(a, name).double(), getattr(b, name).double()
        err = float((x - y).abs().max())
        tol = ULP_BOUND * max(1.0, float(y.abs().max()))
        if err > tol:
            raise AssertionError(f"{where}: {name} sorted vs dense {err} > {tol}")
        bitwise &= err == 0.0
    return bitwise


def _frame_ops(veh, out, fs, p, dt, searched, collided, raw=False) -> float:
    """float32 operations one frame from ``veh`` to ``out`` needs, whose
    neighbour search tests the (slot, column) pairs of the (V, V) mask
    ``searched`` and whose collision pass the unordered pairs of
    ``collided``; with ``raw`` the egos run no P-cascade.  A Linear row's
    accelerations and steering count the linear laws' operations."""
    from highwayenv_tpu_torch.vehicle.behavior import is_driven
    from highwayenv_tpu_torch.vehicle.state import KIND_LINEAR

    live = veh.kind != 0
    px, py = veh.pos[..., 0], veh.pos[..., 1]
    s = (px - float(fs.origin[0])) * float(fs.u[0]) + (
        py - float(fs.origin[1])
    ) * float(fs.u[1])
    occ = live & (s >= -5.0) & (s < fs.length + 5.0)
    neigh = (searched & live[:, :, None] & occ[:, None, :]).sum()
    idm = is_driven(veh)
    mid = veh.lane != veh.target_lane
    deciding_rows = idm & ~mid & (veh.timer > p.lane_change_delay) & veh.enable_lane_change
    deciding = deciding_rows.sum()
    lin = veh.kind == KIND_LINEAR
    lin_evals = EVALS_SLOT * lin.sum() + EVALS_DECIDING * (lin & deciding_rows).sum()
    lin_steer = (lin & idm).sum()
    aborting = (idm & mid).sum() * veh.kind.shape[1]
    chk, coll = veh.check_collisions, veh.collidable
    elig = (
        collided & live[:, :, None] & live[:, None, :]
        & (chk[:, :, None] | chk[:, None, :])
        & coll[:, :, None] & coll[:, None, :]
    )
    d = out.pos[:, :, None, :] - out.pos[:, None, :, :]
    diag = torch.sqrt(out.length**2 + out.width**2)
    reach = (diag[:, :, None] + diag[:, None, :]) / 2 + out.speed[:, :, None] * dt
    near = elig & ((d * d).sum(-1) <= reach * reach)
    raw_egos = (veh.kind == 1).sum() if raw else 0
    return float(
        OPS_SLOT * live.sum() - OPS_EGO_CONTROLS * raw_egos + OPS_NEIGH_PAIR * neigh
        + OPS_DECIDING * deciding + OPS_ABORT_PAIR * aborting
        + OPS_SPHERE * elig.sum() + OPS_SAT * near.sum()
        - (OPS_IDM_PAIR - OPS_LINEAR_ACCEL) * lin_evals
        - (OPS_STEER_PC - OPS_LINEAR_STEER) * lin_steer
    )


def frame_ops(veh, out, fs, p, dt, raw=False) -> float:
    """float32 operations one dense frame needs: every other slot searched,
    every pair collided."""
    V = veh.kind.shape[1]
    eye = torch.eye(V, dtype=torch.bool, device=veh.kind.device)
    return _frame_ops(veh, out, fs, p, dt, ~eye, torch.triu(~eye), raw)


def sorted_frame_ops(veh, out, fs, p, dt, raw=False) -> float:
    """float32 operations one banded frame on the rank layout needs: the
    in-band ranks searched, the pairs of the rank band collided, plus the
    scans and queries of every live slot."""
    from highwayenv_tpu_torch.ops.straight_sorted import windows

    V = veh.kind.shape[1]
    W, Wn = windows(V)
    ranks = torch.arange(V, device=veh.kind.device)
    gap = ranks[None, :] - ranks[:, None]
    band = (gap.abs() <= Wn) & (gap != 0)
    rounds = math.ceil(math.log2(V))
    per_slot = (
        2 * len(fs.offsets) * rounds * OPS_SCAN_STEP + rounds * OPS_COLL_SCAN_STEP
        + OPS_FAR_QUERY
    )
    return _frame_ops(
        veh, out, fs, p, dt, band, (gap >= 1) & (gap <= W), raw
    ) + per_slot * float((veh.kind != 0).sum())


def gen_frame_ops(veh, out, spec, table, raw=False) -> float:
    """float32 operations one general frame from ``veh`` (and its
    frame-start projection table) to ``out`` needs: per live slot the
    projection and re-localization on every lane by the lane's kind and the
    slot's own work; the lanes follow_road measures at a lane end; the IDM
    accelerations and neighbour scans of the decision pass; the abort scans;
    the collision pairs as in the straight frame.  Under raw controls
    (``raw``) the egos' P-cascade is not counted.  A Linear row's
    accelerations and steering count the linear laws' operations.  Under the
    connected-lane search (``spec.connected``) each query also walks the
    candidate lanes of its lane and adds an offset to the key of each slot
    it visits.  Under a dynamical action (``spec.dynamical``) each ego row
    also takes one RK4 step (DYN_OPS_RK4)."""
    from highwayenv_tpu_torch.road import lane as lane_ops
    from highwayenv_tpu_torch.vehicle.behavior import is_driven
    from highwayenv_tpu_torch.vehicle.controller import table_row
    from highwayenv_tpu_torch.vehicle.state import KIND_LINEAR

    geo, p = spec.geo, spec.p
    V = veh.kind.shape[1]
    L = geo.num_lanes
    dev = veh.kind.device
    kinds = geo.kind.long()
    per_lane = float((torch.tensor(GEN_OPS_PROJECT, device=dev)[kinds]
                      + torch.tensor(GEN_OPS_RELOCATE, device=dev)[kinds]).sum())
    poly_ops = 0
    if geo.poly is not None:  # the samples each (poly lane, live slot) scans
        poly = (geo.kind == lane_ops.POLY).nonzero()[:, 0].to(torch.int32)
        idx = lane_ops.poly_pose_index(geo, poly[:, None, None], out.pos[None])
        n = geo.poly.n[geo.poly.slot[poly.long()].long()]
        poly_ops = GEN_OPS_POLY_SAMPLE * ((n[:, None, None] - idx) * (out.kind != 0)).sum()
    table_s, table_lat = table
    live = veh.kind != 0
    li = veh.lane.clamp(0, L - 1).long()
    tl = veh.target_lane.clamp(0, L - 1).long()
    ended = veh.is_controlled & (
        table_row(table_s, veh.target_lane) > geo.length[tl] - 2.5
    )
    n_succ = (geo.succ_edge_base[tl] >= 0).sum(-1).clamp(min=1)
    edge_lanes = (ended * n_succ).sum() * spec.max_edge_lanes
    idm = is_driven(veh)
    mid = veh.lane != veh.target_lane
    deciding = idm & ~mid & (veh.timer > p.lane_change_delay) & veh.enable_lane_change
    n_cand = (geo.conn_lanes >= 0).sum(-1)  # candidate lanes of each lane
    cands = torch.zeros_like(veh.lane)
    cand_lanes = torch.zeros_like(veh.lane)
    for d in (-1, 1):
        cid = geo.lane_id[li] + d
        cand = (geo.edge_base[li] + cid).clamp(0, L - 1)
        reach = lane_ops.reachable_from_coords(
            geo, cand, table_row(table_s, cand), table_row(table_lat, cand)
        )
        asked = (deciding & (cid >= 0) & (cid < geo.edge_n[li]) & reach
                 & (veh.speed.abs() >= 1.0)).int()
        cands = cands + asked
        cand_lanes = cand_lanes + asked * n_cand[cand]
    dual = idm & (out.target_lane != veh.lane)
    queries = idm.sum() + cands.sum() + dual.sum()
    conn_ops = 0
    if spec.connected:
        walked = (idm * n_cand[li]).sum() + cand_lanes.sum() + (
            dual * n_cand[out.target_lane.clamp(0, L - 1).long()]).sum()
        conn_ops = GEN_OPS_CONN_LANE * walked + (V - 1) * queries

    def evals(rows):
        return rows.sum() + 2 * (rows & deciding).sum() + 4 * (cands * rows).sum() + (
            rows & dual).sum()

    lin = idm & (veh.kind == KIND_LINEAR)
    lin_evals = evals(lin)
    idm_evals = evals(idm) - lin_evals
    aborting = (idm & mid & (geo.edge_base[li] == geo.edge_base[tl])).sum()
    # collisions: unordered eligible pairs, and those within reach
    eye = torch.eye(V, dtype=torch.bool, device=dev)
    act, vh = out.kind != 0, out.is_vehicle
    chk, coll = out.check_collisions, out.collidable
    elig = (
        torch.triu(~eye) & act[:, :, None] & act[:, None, :]
        & (vh[:, :, None] | vh[:, None, :]) & (chk[:, :, None] | chk[:, None, :])
        & coll[:, :, None] & coll[:, None, :]
    )
    dpos = out.pos[:, :, None, :] - out.pos[:, None, :, :]
    diag = torch.sqrt(out.length**2 + out.width**2)
    reach = (diag[:, :, None] + diag[:, None, :]) / 2 + out.speed[:, :, None] * spec.dt
    near = elig & ((dpos * dpos).sum(-1) <= reach * reach)
    raw_egos = (veh.kind == 1).sum() if raw else 0
    rk4 = DYN_OPS_RK4 * (veh.kind == 1).sum() if spec.dynamical else 0
    return float(
        rk4 + poly_ops + (per_lane + GEN_OPS_SLOT) * live.sum()
        - GEN_OPS_EGO_CONTROLS * raw_egos
        + GEN_OPS_EDGE_LANE * edge_lanes
        + GEN_OPS_IDM * idm_evals + OPS_LINEAR_ACCEL * lin_evals
        - (GEN_OPS_STEER_PC - OPS_LINEAR_STEER) * lin.sum()
        + GEN_OPS_NEIGH_PAIR * (V - 1) * queries + conn_ops
        + GEN_OPS_ABORT_PAIR * V * aborting + OPS_SPHERE * elig.sum()
        + OPS_SAT * near.sum()
    )


def reg_tick_ops(veh, spec, tick) -> float:
    """float32 operations of the right-of-way pass on the envs where the
    (B,) bool ``tick`` is set, from the frame-start state ``veh``."""
    from highwayenv_tpu_torch.road import regulation

    B, V = veh.kind.shape
    R = veh.route_base.shape[-1]
    T = len(regulation.TIMES)
    pos, _ = regulation.predict_route_positions(spec.geo, veh)
    vh = veh.is_vehicle & tick[:, None]
    eye = torch.eye(V, dtype=torch.bool, device=veh.kind.device)
    pair = torch.triu(~eye) & vh[:, :, None] & vh[:, None, :]
    d = pos[:, None, :, :, :] - pos[:, :, None, :, :]  # (B, V, V, T, 2): j - i
    close = ((d * d).sum(-1) <= (veh.length**2)[:, :, None, None]) & pair[..., None]
    ruled = regulation.enforce_road_rules(spec.geo, veh)
    conflicts = (ruled.is_yielding & ~veh.is_yielding & tick[:, None]).sum()
    return float(
        (REG_OPS_SEGMENT * R + REG_OPS_TIME * T) * vh.sum()
        + REG_OPS_CLOSE * T * pair.sum() + REG_OPS_PROBES * close.sum()
        + REG_OPS_YIELD * conflicts
    )


def regulated_ops(veh, spec, sa, frames, steps0):
    """(float32 operations, the state after) of ``frames`` regulated frames
    from ``veh``, counted frame by frame on the plain version: each frame's
    general operations, plus the right-of-way pass on the envs that tick.
    ``sa`` None: raw controls stored on the egos."""
    from highwayenv_tpu_torch.ops import general_frames as gf
    from highwayenv_tpu_torch.road import lane as lane_ops

    ops, v, raw = 0.0, veh, sa is None
    phase = torch.remainder(steps0, spec.period)
    table = lane_ops.projection_table(spec.geo, v.pos)
    for f in range(frames):
        tick = torch.remainder(phase + (f + 1), spec.period) == 0
        out, next_table = gf.frame_general_plain(v, spec, table, sa if f == 0 else None, tick,
                                                 raw=raw)
        ops += gen_frame_ops(v, out, spec, table, raw=raw)
        if bool(tick.any()):
            ops += reg_tick_ops(v, spec, tick)
        v, table = out, next_table
    return ops, v


def yield_ticks(veh, spec, sa, frames, steps0) -> int:
    """Slot-ticks that yield: over ``frames`` plain regulated frames, the
    slots yielding after each tick of their env, summed."""
    from highwayenv_tpu_torch.ops import general_frames as gf
    from highwayenv_tpu_torch.road import lane as lane_ops

    n, v = 0, veh
    phase = torch.remainder(steps0, spec.period)
    table = lane_ops.projection_table(spec.geo, v.pos)
    for f in range(frames):
        tick = torch.remainder(phase + (f + 1), spec.period) == 0
        v, table = gf.frame_general_plain(v, spec, table, sa if f == 0 else None, tick)
        n += int((v.is_yielding & tick[:, None]).sum())
    return n


def regulated_scenes(env, states, gen, steps_in: bool = True):
    """K5's scenes at intersection-v0, each (vehicles, steps0, slot actions,
    frames): the reset scene; with ``steps_in`` 8 autoreset steps in (the
    env path, on the kernels: a mid-episode state to hold them to their
    plain versions on), with row b's frame
    counter advanced by 15 b so the tick phases cover all 7 values; a
    conflict scene (in every env slot 0 approaches the box from corner 0
    going straight and slot 1 from corner 2 turning left, at the same
    priority, slot 2 from corner 1 going straight, at a higher one, at
    distances that vary by env); and the reset's warm-up launch (the first
    16 slots of fresh spawns, 45 frames, frame counter 0, zero actions of
    the action type's shape)."""
    import dataclasses

    from highwayenv_tpu_torch.road import lane as lane_ops
    from highwayenv_tpu_torch.vehicle.state import KIND_IDM, VehicleState

    veh = states.vehicles
    Bn, V = veh.kind.shape
    dev = veh.pos.device
    spread = torch.arange(Bn, device=dev, dtype=torch.int32) * env.frames_per_step

    def actions():
        acts = random_actions(env, Bn, gen)
        return env._action_to_slots(acts)

    out = {"reset": (veh, states.steps, actions(), env.frames_per_step)}
    if steps_in:
        st = states
        for _ in range(8):
            acts = random_actions(env, Bn, gen)
            st = env.step_autoreset_batched(st, acts, gen)[1]
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
    extra = tuple(env.action_type.action_shape)
    out["warm-up"] = (sub, torch.zeros(Bn, dtype=torch.int32, device=dev),
                      torch.zeros((Bn, W) + extra, device=dev,
                                  dtype=torch.float32 if extra else torch.int32),
                      env._warmup_frames)
    return out


def general_scenes(env, states, gen, obstacle_hit=False):
    """The general frame's scenes: reset; 8 policy steps in (the env's
    autoreset path, on the kernels); every env's vehicles in a row 1.5 m apart along the
    ego's heading (an all-env pile-up); and with ``obstacle_hit`` (merge-v0)
    the ramp vehicle closing on the end-of-ramp obstacle at 15 m/s and slot
    1 on the ego at 40 m/s (the obstacle hit)."""
    veh = states.vehicles
    Bn, V = veh.kind.shape
    dev = veh.pos.device
    st = states
    for _ in range(8):
        acts = random_actions(env, Bn, gen)
        st = env.step_autoreset_batched(st, acts, gen)[1]
    out = {"reset": veh, "8 steps in": st.vehicles, "pile-up": pile_up(veh)}
    if obstacle_hit:  # merge-v0: the obstacle in slot 5
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


def pile_up(veh):
    """Every env's vehicles in a row 1.5 m apart along the ego's heading."""
    V, dev = veh.kind.shape[1], veh.pos.device
    h = veh.heading[:, 0]
    u = torch.stack([torch.cos(h), torch.sin(h)], dim=-1)
    k = torch.arange(V, device=dev, dtype=torch.float32)
    row = veh.pos[:, :1] + 1.5 * k[None, :, None] * u[:, None, :]
    is_veh = veh.is_vehicle
    return veh.replace(
        pos=torch.where(is_veh[..., None], row, veh.pos),
        heading=torch.where(is_veh, h[:, None], veh.heading),
        lane=torch.where(is_veh, veh.lane[:, :1], veh.lane),
        target_lane=torch.where(is_veh, veh.lane[:, :1], veh.target_lane),
    )


def compare_general(a, b, where: str) -> float:
    """K4 (K5) against its plain version: every field of the state bit-exact,
    the yielding state and the impacts included, and the continuous fields
    finite; prints the crashed slots and returns the max absolute
    difference over the continuous fields (0.0)."""
    err = exact_state(a, b, where)
    for name in GEN_CONTINUOUS:
        if not bool(torch.isfinite(getattr(a, name)).all()):
            raise AssertionError(f"{where}: {name} has non-finite values")
    print(f"  {where}: every field bit-exact; crashed slots {int(a.crashed.sum())}")
    return err


def check_autoreset(env, states, gen, label: str) -> None:
    """Three autoreset steps of the main path against the plain reference
    path from the same states and generators."""
    st_k = st_p = states
    for t in range(3):
        acts = random_actions(env, B, gen)
        g_k, g_p = env.generator(100 + t), env.generator(100 + t)
        obs_k, st_k, r_k, te_k, tr_k, _ = env.step_autoreset_batched(st_k, acts, g_k)
        obs_p, st_p, r_p, te_p, tr_p, _ = env.step_autoreset(st_p, acts, g_p)
        compare(st_k.vehicles, st_p.vehicles, f"{label}step {t}")
        if not (torch.equal(te_k, te_p) and torch.equal(tr_k, tr_p)):
            raise AssertionError(f"{label}step {t}: terminated / truncated differ")
        fk, fp = obs_fields(obs_k), obs_fields(obs_p)
        obs_err = max(float((fk[k] - fp[k]).abs().max()) for k in fk)
        rew_err = float((r_k - r_p).abs().max())
        print(f"  {label}step {t}: obs err {obs_err:.3e}, reward err {rew_err:.3e}")
        if obs_err > 1e-4 or rew_err > 1e-4:
            raise AssertionError(f"{label}step {t}: obs / reward disagree")


def field_bytes(state, fields) -> int:
    return sum(getattr(state, n).numel() * getattr(state, n).element_size()
               for n, _, _ in fields)


def read_bytes(state, fields) -> int:
    """The bytes a frame kernel reads of ``fields``: every field once, but
    the Linear parameter fields only on the Linear rows, the only threads
    that load them."""
    from highwayenv_tpu_torch.vehicle.state import KIND_LINEAR

    rows = int((state.kind == KIND_LINEAR).sum())
    params = [f for f in fields if f[0] in PARAM_FIELDS]
    per_row = sum(math.prod(trail) * 4 for _, _, trail in params)
    return field_bytes(state, [f for f in fields if f[0] not in PARAM_FIELDS]) + rows * per_row


def bound(ops: float, n_bytes: int):
    """(bound ms, what bounds it) of ``ops`` float32 operations and
    ``n_bytes`` moved, at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def group_size(V: int) -> int:
    """Threads per env of the general frame kernels (``threads_per_env`` in
    csrc/general_frames.cu; a block of 128 in the wide kernels, over 32
    slots)."""
    return 16 if V <= 16 else (32 if V <= 32 else 128)


def k4_work(gf, env, veh, sa, spec=None, with_state=False):
    """(float32 operations, bytes) of one K4 launch from ``veh`` with the
    slot actions ``sa`` (None: raw controls stored on the egos, which run
    no P-cascade) under ``spec`` (default the env's): the operations
    counted frame by frame on the plain version (``gen_frame_ops``), the
    bytes of every field read and written once (``read_bytes``), the slot
    actions, the lane tables and (connected) the candidate tables; with
    ``with_state`` also the plain frames' state after the launch's frames."""
    from highwayenv_tpu_torch.road import lane as lane_ops

    spec, raw = spec or env._general, sa is None
    ops, v = 0.0, veh
    table = lane_ops.projection_table(spec.geo, v.pos)
    for f in range(env.frames_per_step):
        out, next_table = gf.frame_general_plain(v, spec, table, sa if f == 0 else None,
                                                 raw=raw)
        ops += gen_frame_ops(v, out, spec, table, raw=raw)
        v, table = out, next_table
    R = veh.route_base.shape[-1]
    n_bytes = (read_bytes(veh, gf._resolve(gf._IN_FIELDS, R)) + (0 if raw else sa.numel() * 4)
               + field_bytes(v, gf._resolve(gf.OUT_FIELDS, R))
               + table_bytes(gf, spec, raw, R, env.device) + dyn_bytes(gf, spec, veh))
    return (ops, n_bytes, v) if with_state else (ops, n_bytes)


def table_bytes(gf, spec, raw: bool, R: int, device, glob: bool = False) -> int:
    """The bytes of the tables a general launch at R route slots reads:
    the lane tables, (connected) the candidate tables, in the layout of
    ``scene_tables`` (``glob``: the global library's kSized one, and its
    lanes' order), (poly lanes) the poly bank and (the kSized layout's
    meta-actions) the speed grid."""
    S, K, sized = gf.scene_tables(spec, R, raw, glob)
    tables = gf.lane_tables(spec.geo, device, S, sized) + gf.poly_tables(spec.geo, device)
    if glob:
        tables += (gf.lane_order(spec.geo, device),)
    if spec.connected:
        tables += gf.conn_tables(spec.geo, device, K)
    if sized:  # the fixed layout's grid is in the parameter block
        tables += gf.speed_table(spec, raw, device)
    return sum(t.numel() * t.element_size() for t in tables)


def dyn_bytes(gf, spec, veh) -> int:
    """The bytes of the lateral speed and yaw rate a dynamical launch reads
    and writes, 16 a row."""
    return 2 * field_bytes(veh, gf.DYN_FIELDS) if spec.dynamical else 0


def k5_work(gf, env, veh, sa, steps0, frames, spec=None, with_state=False):
    """(float32 operations, bytes) of one K5 launch under ``spec``
    (default the env's): ``regulated_ops``, and the bytes of every field
    and K5's own read and written once, the slot actions (none with ``sa``
    None: raw controls stored on the egos), the tick phases, the lane
    tables, (connected) the candidate tables and (dynamical) the lateral
    speed and yaw rate; with ``with_state`` also the plain frames' state
    after the launch's frames."""
    spec, raw = spec or env._general, sa is None
    ops, out = regulated_ops(veh, spec, sa, frames, steps0)
    R = veh.route_base.shape[-1]
    n_bytes = (read_bytes(veh, gf._resolve(gf._IN_FIELDS, R) + gf.REG_FIELDS)
               + (0 if raw else sa.numel() * 4) + veh.kind.shape[0] * 4
               + field_bytes(out, gf._resolve(gf.OUT_FIELDS, R) + gf.REG_FIELDS)
               + table_bytes(gf, spec, raw, R, env.device) + dyn_bytes(gf, spec, veh))
    return (ops, n_bytes, out) if with_state else (ops, n_bytes)


def check_slice_kernels(ht, gf, err) -> dict:
    """K4 against its plain version at the five envs of the slice
    (SLICE_ENVS) on the reset scene, 8 steps in and the all-env pile-up,
    every field bit-exact; records each env's max error in ``err`` under
    "K4 <env id>".  Returns {env id: (env, states)}."""
    k4 = gf.frames_general_kernel
    envs = {}
    for env_id in SLICE_ENVS:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        V, key = env.num_slots, f"K4 {env_id}"
        err[key] = 0.0
        print(f"== 3. K4 vs plain: {env_id} V={V}, L={env.geo.num_lanes}, "
              f"R={states.vehicles.route_base.shape[-1]}, at most {spec.max_edge_lanes} "
              f"lanes an edge, group {group_size(V)} threads an env, {frames} frames, "
              f"B={B}, observation {type(env.observation_type).__name__}")
        for name, veh in general_scenes(env, states, gen).items():
            sa = env._action_to_slots(random_actions(env, B, gen))
            out_k = k4(veh, spec, sa, frames, linear=env.linear_rows)
            out_p = gf.frames_general_plain(veh, spec, sa, frames)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} {name}"))
            if name == "pile-up" and not bool(out_k.crashed[:, 0].any()):
                raise AssertionError(f"{env_id}: no ego of the pile-up crashed")
        envs[env_id] = (env, states)
    return envs


def parking_hits(env, veh):
    """The parking scene in which every env's ego is about to hit
    something: in env b, by b % 3, the north wall (0.2 m from it, heading
    north, east of the spots), its goal landmark (0.3 m from it, along the
    goal's heading) or, on parking-parked-v0, its first parked car (0.3 m
    from it), else the east wall (its front at the wall's face); at 3 to
    7 m/s by env."""
    Bn = veh.kind.shape[0]
    dev = veh.pos.device
    b = torch.arange(Bn, device=dev)
    which = (b % 3)[:, None]

    def behind(slot, gap):
        h = veh.heading[:, slot]
        return veh.pos[:, slot] - gap * torch.stack([torch.cos(h), torch.sin(h)], -1), h

    goal_pos, goal_head = behind(env.goal_slot_of(0), 3.8)
    if env.config["vehicles_count"]:
        other_pos, other_head = behind(1, 5.3)
    else:
        other_pos = torch.tensor([32.0, 0.0], device=dev).expand(Bn, 2)
        other_head = torch.zeros(Bn, device=dev)
    wall_pos = torch.stack([29.5 + ((b // 3) % 3).float(),
                            torch.full((Bn,), 17.8, device=dev)], -1)
    pos, heading, speed = veh.pos.clone(), veh.heading.clone(), veh.speed.clone()
    pos[:, 0] = torch.where(which == 0, wall_pos,
                            torch.where(which == 1, goal_pos, other_pos))
    heading[:, 0] = torch.where(which[:, 0] == 0, math.pi / 2,
                                torch.where(which[:, 0] == 1, goal_head, other_head))
    speed[:, 0] = 3.0 + (b % 5).float()
    return veh.replace(pos=pos, heading=heading, speed=speed)


def check_parking_kernels(ht, gf, err) -> dict:
    """K4's raw-control branch against its plain version at the parking
    family (PARKING_ENVS), 14 lanes an edge, on the reset scene, 8 steps
    in, the all-env pile-up and the scene where the egos hit the walls,
    their goals and the parked cars, every field bit-exact; records each
    env's max error in ``err`` under "K4 <env id>".  Returns {env id:
    (env, states)}."""
    k4 = gf.frames_general_kernel
    envs = {}
    for env_id in PARKING_ENVS:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        V, key = env.num_slots, f"K4 {env_id}"
        err[key] = 0.0
        print(f"== 3. K4 raw vs plain: {env_id} V={V}, L={env.geo.num_lanes}, "
              f"{spec.max_edge_lanes} lanes an edge, group {group_size(V)} threads an env, "
              f"{frames} frames, B={B}, raw controls {env.action_type.stores_raw_controls}, "
              f"observation {type(env.observation_type).__name__}")
        scenes_ = general_scenes(env, states, gen)
        scenes_["hits"] = parking_hits(env, states.vehicles)
        for name, veh in scenes_.items():
            sa = env._action_to_slots(random_actions(env, B, gen))
            veh, _, raw = gf.store_raw_controls(env, veh, sa)
            out_k = k4(veh, spec, None, frames, raw=raw, linear=env.linear_rows)
            out_p = gf.frames_general_plain(veh, spec, None, frames, raw=raw)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} {name}"))
            if name == "hits":
                which = torch.arange(B, device=env.device) % 3
                walls = int(out_k.crashed[which == 0, 0].sum())
                goals = int(out_k.hit[which == 1, env.goal_slot_of(0)].sum())
                others = int(out_k.crashed[which == 2, 0].sum())
                print(f"  {env_id} hits: egos crashed into the north wall {walls}, goal "
                      f"landmarks hit {goals} (egos crashed there "
                      f"{int(out_k.crashed[which == 1, 0].sum())}), egos crashed into a "
                      f"{'parked car' if env.config['vehicles_count'] else 'wall'} {others}")
                if not (walls and goals and others):
                    raise AssertionError(f"{env_id}: the hits scene did not hit")
        envs[env_id] = (env, states)
    return envs


def check_refusals(ht) -> None:
    """``make`` on the card refuses what the kernels do not take, as on the
    CPU, naming the limit (OVER_LIMITS): no such env reaches a launch.  The roads the
    fixed tables once refused (a crowded node under the connected-lane
    search, poly lanes, with ``sequential_decisions`` too) are made and
    take two policy steps at 64 rows."""
    from highwayenv_tpu_torch.tools import custom_roads

    for env_id, config, what in OVER_LIMITS:
        try:
            ht.make(env_id, config)
        except NotImplementedError as e:
            if what not in str(e) or "not ported" not in str(e):
                raise AssertionError(f"{env_id}: refused for another reason: {e}") from e
            print(f"  make('{env_id}', {config}) on CUDA refused: {e}")
        else:
            raise AssertionError(f"{env_id} {config}: made past the kernels' limits")
    for cls, config in ((custom_roads.CrowdedMerge, {"neighbour_vehicles_connected_lanes": True}),
                        (custom_roads.PolyJunctionMerge, None),
                        (custom_roads.PolyJunctionMerge, {"sequential_decisions": True})):
        env = cls(config)
        gen = env.generator(SEED)
        _, st = env.reset(64, gen)
        st, m = rollout(env, st, 2, gen)
        if not all(np.isfinite([float(v) for v in m.values()])):
            raise AssertionError(f"{cls.__name__} {config}: non-finite metrics")
        print(f"  {cls.__name__} {config} on CUDA made and stepped: {env.geo.num_lanes} lanes, "
              f"{env.geo.pred_edge_base.shape[1]} predecessor and "
              f"{env.geo.succ_edge_base.shape[1]} successor edges a lane at most, "
              f"{'a' if env.geo.poly is not None else 'no'} poly bank")


def check_connected_kernels(ht, gf, err) -> dict:
    """K4's kConnected instantiation against its plain version at
    CONNECTED_K4 on the reset scene, 8 steps in and the all-env pile-up
    (racetrack-v1's raw controls stored on the egos first), and K5 at
    REGULATED_12 on ``regulated_scenes`` (the tick phases spread over all 7
    values, the conflict scene, the warm-up): kConnected at intersection-v2
    and intersection-multi-agent-v2, the v0 instantiation with two egos at
    intersection-multi-agent-v0; every field bit-exact.  Records the errors
    under "K4 connected", "K5 connected" and "K5 step" / "K5 warm-up".
    Returns {env id: (env, states)}."""
    envs = {}
    err["K4 connected"] = err["K5 connected"] = 0.0
    k4c = gf.frames_general_connected_kernel
    for env_id in CONNECTED_K4:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        print(f"== 3. K4 connected vs plain: {env_id} V={env.num_slots}, "
              f"L={env.geo.num_lanes}, candidate lanes a lane "
              f"{int((env.geo.conn_lanes >= 0).sum(-1).max())} of "
              f"{env.geo.conn_lanes.shape[1]}, group {group_size(env.num_slots)} threads "
              f"an env, {frames} frames, B={B}, raw controls "
              f"{env.action_type.stores_raw_controls}")
        if not spec.connected:
            raise AssertionError(f"{env_id}: the spec has no connected-lane search")
        for name, veh in general_scenes(env, states, gen).items():
            sa = env._action_to_slots(random_actions(env, B, gen))
            veh, sa, raw = gf.store_raw_controls(env, veh, sa)
            out_k = k4c(veh, spec, sa, frames, raw=raw, linear=env.linear_rows)
            out_p = gf.frames_general_plain(veh, spec, sa, frames, raw=raw)
            torch.cuda.synchronize()
            err["K4 connected"] = max(err["K4 connected"],
                                      compare_general(out_k, out_p, f"{env_id} {name}"))
        envs[env_id] = (env, states)
    for env_id in REGULATED_12:
        env = ht.make(env_id)
        spec = env._general
        kernel = gf.frames_regulated_connected_kernel if spec.connected else (
            gf.frames_regulated_kernel)
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        print(f"== 3. K5{' connected' if spec.connected else ''} vs plain: {env_id} "
              f"V={env.num_slots}, egos {env.ego_slots}, {env.frames_per_step} frames, "
              f"tick period {spec.period}, B={B}")
        for name, (rveh, rsteps, rsa, rframes) in regulated_scenes(env, states, gen).items():
            out_k = kernel(rveh, spec, rsa, rframes, rsteps, linear=False)
            out_p = gf.frames_general_plain(rveh, spec, rsa, rframes, rsteps)
            torch.cuda.synchronize()
            key = "K5 connected" if spec.connected else (
                "K5 warm-up" if name == "warm-up" else "K5 step")
            err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} {name}"))
            phases = torch.unique(torch.remainder(rsteps, spec.period)).numel()
            print(f"    V={rveh.kind.shape[1]}, {rframes} frames, {phases} tick phases; "
                  f"slots yielding after the step {int(out_k.is_yielding.sum())}")
            if name == "8 steps in" and phases != spec.period:
                raise AssertionError(f"{env_id}: the tick phases are not mixed")
        envs[env_id] = (env, states)
    return envs


def dynamical_scenes(env, states):
    """The dynamical instantiations' own scenes from ``states``: "crashed
    ego", every other env's ego crashed and every fourth with a pending
    impact of (0.7, 0.7) (a dynamical ego's position does not take it);
    "low speed", the egos' speeds spread over 0.5 to 1.5 m/s across the
    damping branch's |v| = 1, their yaw rates over +-9 rad/s (past the
    +-2 pi clip) and lateral speeds over +-2 m/s.  ``store_low_speed_steering``
    then puts the steering past the +-pi/2 clip."""
    veh = states.vehicles
    Bn = veh.kind.shape[0]
    dev = veh.pos.device
    ego = veh.kind == 1
    row = torch.arange(Bn, device=dev)[:, None]
    hit = ego & (row % 4 == 0)
    u = ((torch.arange(Bn, device=dev) % 64).float() / 63.0)[:, None]
    return {
        "crashed ego": veh.replace(
            crashed=veh.crashed | (ego & (row % 2 == 0)),
            impact_pending=veh.impact_pending | hit,
            impact=torch.where(hit[..., None], 0.7, veh.impact),
        ),
        "low speed": veh.replace(
            speed=torch.where(ego, 0.5 + u, veh.speed),
            yaw_rate=torch.where(ego, 9.0 * (2.0 * u - 1.0), veh.yaw_rate),
            lateral_speed=torch.where(ego, 2.0 * (1.0 - 2.0 * u), veh.lateral_speed),
        ),
    }


def store_low_speed_steering(veh):
    """The egos of every third env steering at +-2 rad, past the +-pi/2
    clip, after their controls are stored."""
    Bn = veh.kind.shape[0]
    row = torch.arange(Bn, device=veh.pos.device)[:, None]
    wide = (veh.kind == 1) & (row % 3 == 0)
    return veh.replace(steering=torch.where(wide, torch.where(row % 2 == 0, 2.0, -2.0),
                                            veh.steering))


def check_dynamical_kernels(ht, gf, err) -> dict:
    """The kDynamical instantiations against their plain versions:
    K5's at intersection-v1 on ``regulated_scenes`` (the reset scene with
    the tick phases spread over all 7 values, 8 steps in, the conflict
    scene, the warm-up, which holds no ego row) and K4's at lane-keeping-v0
    on ``general_scenes`` (reset, 8 steps in, the pile-up), plus
    ``dynamical_scenes``' crashed-ego and low-speed scenes, each with the
    egos' raw controls stored first; every field bit-exact, the lateral
    speed and yaw rate included.  Records the errors under "K5 dynamical"
    and "K4 dynamical".  Returns {env id: (env, states)}."""
    envs = {}
    for env_id in DYNAMICAL_IDS:
        env = ht.make(env_id)
        spec, frames = env._general, env.frames_per_step
        key = ("K5" if env.regulated else "K4") + " dynamical"
        kernel = gf.frames_kernel_for(spec, env.regulated)
        if not spec.dynamical or kernel.entry != "general_frames" + (
                "_regulated" * env.regulated) + "_dynamical":
            raise AssertionError(f"{env_id}: not on a dynamical instantiation")
        err[key] = 0.0
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        print(f"== 3. {key} vs plain: {env_id} V={env.num_slots}, L={env.geo.num_lanes}, "
              f"egos {env.ego_slots}, {frames} frames, B={B}, dt {env.dt:.6f}")
        spread = states.steps + torch.arange(B, device=env.device, dtype=torch.int32) * 15
        if env.regulated:
            cases = regulated_scenes(env, states, gen)
            cases["reset"] = (cases["reset"][0], spread) + cases["reset"][2:]
        else:
            cases = {name: (veh, None, env._action_to_slots(random_actions(env, B, gen)), frames)
                     for name, veh in general_scenes(env, states, gen).items()}
        for name, veh in dynamical_scenes(env, states).items():
            cases[name] = (veh, spread if env.regulated else None,
                           env._action_to_slots(random_actions(env, B, gen)), frames)
        for name, (veh, steps0, sa, nframes) in cases.items():
            veh, sa, raw = gf.store_raw_controls(env, veh, sa)
            if name == "low speed":
                veh = store_low_speed_steering(veh)
            out_k = kernel(veh, spec, sa, nframes, steps0, raw=raw, linear=False)
            out_p = gf.frames_general_plain(veh, spec, sa, nframes, steps0, raw=raw)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} {name}"))
            ego = veh.kind == 1
            print(f"    V={veh.kind.shape[1]}, {nframes} frames; ego rows {int(ego.sum())}, "
                  f"below 1 m/s {int((ego & (veh.speed.abs() < 1)).sum())}, crashed "
                  f"{int((ego & veh.crashed).sum())}; |yaw rate| after the step up to "
                  f"{float(out_k.yaw_rate.abs().max()):.4f}")
            if name in ("reset", "low speed") and not bool((out_k.yaw_rate[ego] != 0).any()):
                raise AssertionError(f"{env_id} {name}: no ego turned")
        envs[env_id] = (env, states)
    return envs


def poly_lanes(net_mod, seed: int = SEED):
    """A fixed-width and a variable-width poly lane of seeded control points
    (``net_mod``'s classes): (fixed, variable)."""
    rng = np.random.default_rng(seed + 40)
    x = np.cumsum(rng.uniform(6.0, 15.0, size=8)) - 6.0
    y = np.cumsum(rng.normal(scale=3.0, size=8))
    pts = np.stack([x, y], 1)
    half = rng.uniform(1.8, 3.0, size=8)[:, None] * np.array([0.0, 1.0])
    return (net_mod.PolyLaneFixedWidth(pts.tolist(), width=3.5),
            net_mod.PolyLane(pts.tolist(), (pts + half).tolist(), (pts - half).tolist()))


# Several controlled vehicles at the highway, parking and racetrack
# families (K1-K3 with two ego rows, K4's raw branch with two and three),
# and the heads that run on their states (Lidar, the shuffled Kinematics
# order, the finite-MDP export)
SEVERAL_STRAIGHT = {"controlled_vehicles": 2}  # highway-v0, V=52, egos in slots 0, 26
SEVERAL_GENERAL = (("parking-v0", 2), ("parking-v0", 3), ("parking-parked-v0", 2),
                   ("racetrack-v0", 2))
#: the several-ego K4 configs with a row of their own in the kernel table
SEVERAL_ROWS = ("parking-v0 3 egos", "racetrack-v0 2 egos")
LIDAR_CONFIG = {"observation": {"type": "LidarObservation"}}
SHUFFLED_CONFIG = {"observation": {"type": "Kinematics", "order": "shuffled"}}


def eight_steps_in(env, states, gen):
    """``states`` after 8 random-policy autoreset steps of the env's main
    path."""
    n = states.time.shape[0]
    for _ in range(8):
        states = env.step_autoreset_batched(states, random_actions(env, n, gen), gen)[1]
    return states


def check_several_egos_kernels(ht, gf, err) -> dict:
    """K4's raw-control branch with several ego rows against its plain
    version at SEVERAL_GENERAL, B=4096, on the reset scene, 8 steps in and
    the all-env pile-up (every ego crashed there), every field bit-exact;
    records each config's max error in ``err`` under "K4 <id> <n> egos".
    Returns {"<id> <n> egos": (env, states)}."""
    k4 = gf.frames_general_kernel
    envs = {}
    for env_id, n in SEVERAL_GENERAL:
        env = ht.make(env_id, {"controlled_vehicles": n})
        spec, frames = env._general, env.frames_per_step
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        label, egos = f"{env_id} {n} egos", list(env.ego_slots)
        key = f"K4 {label}"
        err[key] = 0.0
        print(f"== 3. K4 raw vs plain: {label} (slots {egos}) V={env.num_slots}, "
              f"L={env.geo.num_lanes}, {frames} frames, B={B}, observation a tuple of "
              f"{n} {type(env.observation_type).__name__}")
        for name, veh in general_scenes(env, states, gen).items():
            if int((veh.kind == 1).sum()) != B * n:
                raise AssertionError(f"{label} {name}: not {n} ego rows an env")
            sa = env._action_to_slots(random_actions(env, B, gen))
            veh, _, raw = gf.store_raw_controls(env, veh, sa)
            out_k = k4(veh, spec, None, frames, raw=raw, linear=env.linear_rows)
            out_p = gf.frames_general_plain(veh, spec, None, frames, raw=raw)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{label} {name}"))
            if name == "pile-up" and not bool(out_k.crashed[:, egos].all()):
                raise AssertionError(f"{label}: an ego of the pile-up did not crash")
        envs[label] = (env, states)
    return envs


def drive_several_straight(env, kernels, launches) -> None:
    """highway-v0 with two egos: reset and a HORIZON-step random-policy
    rollout through the sorted step, the counts set to 0 just before and
    read just after: K1, K2a, K3 and K2b once per policy step, alone."""
    print(f"== 4. several-ego path: make('highway-v0', {SEVERAL_STRAIGHT}) on CUDA, B={B}, "
          f"V={env.num_slots}, egos in slots {list(env.ego_slots)}, reset and {HORIZON} "
          "random-policy autoreset steps, sorted step")
    gen = env.generator(SEED + 1)
    for k in kernels.values():
        k.launches = 0
    _, st = env.reset(B, gen)
    st, m = rollout(env, st, HORIZON, gen)
    torch.cuda.synchronize()
    counts = {n: kernels[n].launches for n in ("K1", "K2a", "K3", "K2b")}
    others = {n: k.launches for n, k in kernels.items() if n not in counts}
    m = {k: float(v) for k, v in m.items()}
    print(f"  launches: {counts}, other kernels {others}; rollout {m}")
    if any(v != HORIZON for v in counts.values()) or any(others.values()):
        raise AssertionError("highway-v0 2 egos: the sorted kernels must launch once per "
                             "policy step, alone")
    if not all(np.isfinite(list(m.values()))) or not m["done_rate"] > 0:
        raise AssertionError("highway-v0 2 egos: non-finite metrics or no episode ended")
    for name, n in counts.items():
        launches[f"{name} 2 egos"] = n


def straight_rows(env, states, timed, rows, sfx: str = "", glob: bool = False) -> None:
    """K2a, K3, K2b and K1 (every env, and masked with no env firing) on the
    reset scene ``states`` with every ego's FASTER applied: the rows "K2a"
    .. "K1" (with ``sfx``, e.g. " 2 egos", and the env in the names), each
    timed beside its bound.  ``glob``: the scene takes the global layout of
    K1 and K3, whose sources the rows name."""
    from highwayenv_tpu_torch.ops import straight_frames as sf, straight_sorted as ss

    fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
    V, L = env.num_slots, len(fs.offsets)
    k1, k3 = sf.frames_kernel_for(V, L), ss.frames_sorted_kernel_for(V, L)
    k2a, k2b = ss.sort_kernel, ss.unsort_kernel
    if k1.glob != glob or k3.glob != glob:
        raise AssertionError(f"V={V}, L={L}: K1 / K3 layout global={k1.glob} / {k3.glob}")
    Bc = states.vehicles.kind.shape[0]
    sa = env._action_to_slots(torch.ones((Bc,) + env.action_shape, dtype=torch.int32,
                                         device=env.device))
    veh = env.action_type.apply(env.geo, states.vehicles, states.vehicles.kind == 1, sa)
    srt, idx = ss.sort_plain(veh, fs)
    band, flags = ss.frames_sorted_plain(srt, idx, fs, p, dt, frames)
    back = ss.unsort_plain(band, idx, veh)
    none = torch.zeros(Bc, dtype=torch.bool, device=env.device)
    tag = (f" (highway-v0,{sfx}, V={V}" + (f", B={Bc}" if Bc != B else "") + ")") if sfx else ""
    glob_sfx = "_global" if glob else ""
    src_sort = "highwayenv_tpu_torch/csrc/straight_sort.cu"

    # K2a: bytes of every field read once and written once, plus idx; the
    # operations those of a comparison sort of V keys (V log2 V comparisons
    # an env) and the projection to s, not the kernel's V^2 rank count
    s_key = ss.s_coordinate(veh.pos, fs) + 0.0

    def sort_library():  # torch.sort + torch.gather of every field
        order = torch.sort(s_key, dim=1, stable=True).indices
        return [torch.gather(getattr(veh, n), 1, ss._per_row(order, getattr(veh, n)))
                for n, _, _ in ss.SORT_FIELDS]

    ms, plain_ms, lib_ms = timed(
        f"K2a straight_sort{tag} (yardstick: torch.sort + torch.gather sequence)",
        lambda: k2a(veh, fs), lambda: ss.sort_plain(veh, fs), sort_library, 50, 10)
    n_bytes = 2 * field_bytes(veh, ss.SORT_FIELDS) + idx.numel() * 4
    rank_ops = Bc * V * math.log2(max(V, 2)) + 4.0 * Bc * V
    bms, by, t_ops, t_bytes = bound(rank_ops, n_bytes)
    rows["K2a" + sfx] = ("straight_sort" + tag, src_sort,
                         "highwayenv_tpu/ops/straight_pallas_bm.py:1241", ms, plain_ms, bms, by,
                         lib_ms)
    print(f"    bound {bms:.4f} ms by {by} ({n_bytes} bytes -> {t_bytes:.4f} ms, "
          f"{rank_ops:.3e} ops -> {t_ops:.5f} ms)")

    # K3: operations of this input's frames, frame by frame on the plain version
    ms, plain_ms, _ = timed(
        f"K3 straight_frames_sorted{tag}, per policy step",
        lambda: k3(srt, idx, fs, p, dt, frames, linear=False),
        lambda: ss.frames_sorted_plain(srt, idx, fs, p, dt, frames), None, 20, PLAIN_REPS)
    ops, v = 0.0, srt
    for _ in range(frames):
        out, _ = ss.frames_sorted_plain(v, idx, fs, p, dt, 1)
        ops += sorted_frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = (read_bytes(srt, sf._IN_FIELDS) + field_bytes(band, sf._OUT_FIELDS)
               + idx.numel() * 4 + Bc * 2)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K3" + sfx] = (f"straight_frames_sorted{glob_sfx}" + tag,
                        f"highwayenv_tpu_torch/csrc/straight_frames_sorted{glob_sfx}.cu",
                        "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms, by,
                        None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.4f} ms); firing envs "
          f"{int(flags.any(dim=1).sum())}")

    # K2b: the mutated fields and idx read once, the fields written once
    index = idx.long()

    def unsort_library():  # torch scatter_ of every mutated field
        return [torch.empty_like(getattr(band, n)).scatter_(
            1, ss._per_row(index, getattr(band, n)), getattr(band, n))
            for n, _, _ in ss.MUT_FIELDS]

    ms, plain_ms, lib_ms = timed(
        f"K2b straight_unsort{tag} (yardstick: torch scatter_ sequence)",
        lambda: k2b(band, idx, veh), lambda: ss.unsort_plain(band, idx, veh),
        unsort_library, 50, 10)
    n_bytes = 2 * field_bytes(band, ss.MUT_FIELDS) + idx.numel() * 4
    bms, by, t_ops, t_bytes = bound(0.0, n_bytes)
    rows["K2b" + sfx] = ("straight_unsort" + tag, src_sort,
                         "highwayenv_tpu/ops/straight_pallas_bm.py:1257", ms, plain_ms, bms, by,
                         lib_ms)
    print(f"    bound {bms:.4f} ms by {by} ({n_bytes} bytes)")

    # K1: dense (every env), and masked with no env firing (the main path's
    # usual launch)
    ms, plain_ms, _ = timed(
        f"K1 straight_frames{tag}, every env, per policy step",
        lambda: k1(veh, fs, p, dt, frames, linear=False),
        lambda: sf.frames_plain(veh, fs, p, dt, frames), None, 20, PLAIN_REPS)
    masked_ms = queued_ms(lambda: k1(veh, fs, p, dt, frames, mask=none, out=back,
                                   linear=False), 50)
    ops, v = 0.0, veh
    for _ in range(frames):
        out = sf.frames_plain(v, fs, p, dt, 1)
        ops += frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = read_bytes(veh, sf._IN_FIELDS) + field_bytes(veh, sf._OUT_FIELDS)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K1" + sfx] = (f"straight_frames{glob_sfx}" + tag,
                        f"highwayenv_tpu_torch/csrc/straight_frames{glob_sfx}.cu",
                        "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms, by,
                        None)
    print(f"    masked with no env firing: {masked_ms:.4f} ms queued; bound "
          f"{bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, {n_bytes} "
          f"bytes -> {t_bytes:.4f} ms)")


def check_finite_mdp(ht) -> None:
    """``to_finite_mdp`` of a B=1 highway-v0 state on CUDA against the same
    call on the CPU, and of a B=8 batch (the widest edge's rule): the
    transition table, the terminal states and the current state equal, the
    rewards within 1e-6."""
    from highwayenv_tpu_torch.envs.base import map_fields

    env, cpu = ht.make("highway-v0"), ht.make("highway-v0", device="cpu")
    _, states = env.reset(8, env.generator(SEED))
    states = eight_steps_in(env, states, env.generator(SEED + 9))
    for label, st in (("B=1", map_fields(lambda t: t[:1], states)), ("B=8", states)):
        m = env.to_finite_mdp(st)
        mc = cpu.to_finite_mdp(map_fields(lambda t: t.cpu(), st))
        same = (m.original_shape == mc.original_shape
                and torch.equal(m.transition.cpu(), mc.transition)
                and torch.equal(m.terminal.cpu(), mc.terminal)
                and torch.equal(m.state.cpu(), mc.state))
        rew_err = float((m.reward.cpu() - mc.reward).abs().max())
        print(f"  to_finite_mdp highway-v0 {label}: grid {m.original_shape}, CUDA vs CPU "
              f"transition / terminal / state {'equal' if same else 'DIFFER'}, reward err "
              f"{rew_err:.3e}; terminal states before the horizon "
              f"{int(m.terminal.view(-1, *m.original_shape)[..., :-1].sum())}")
        if not same or rew_err > 1e-6:
            raise AssertionError(f"to_finite_mdp {label}: CUDA and CPU differ")


def drive_general_paths(gf, envs, kernels, launches, rollouts, others=()) -> None:
    """A slice's general paths, each with the counts set to 0 just before
    it: ``rollouts`` made on CUDA, reset and HORIZON random-policy
    autoreset steps eager (K4's instantiation once a step; K5's once a
    step and once a warm-up, plus the first reset's), then the same
    through a CapturedStep, and ``others`` CONNECTED_SHORT captured steps;
    each replay profiled: one launch of the path's instantiation (two on a
    regulated road: its step and its reset's warm-up), none of any other
    instantiation (at a connected id the v0 one's, at a dynamical id the
    v0 one's)."""
    gf_names = {path: name for path, (_, name) in GENERAL_PATHS.items()}
    for env_id in rollouts + others:
        env = envs[env_id]
        spec = env._general
        path = (("K5" if env.regulated else "K4") + (" connected" if spec.connected else "")
                + (" dynamical" if spec.dynamical else ""))
        per_step = 2 if env.regulated else 1
        for graph in (False, True):
            if not graph and env_id not in rollouts:
                continue
            steps = HORIZON if env_id in rollouts else CONNECTED_SHORT
            print(f"== 4. slice path: make('{env_id}') on CUDA, B={B}, reset and {steps} "
                  f"random-policy autoreset steps through {path}"
                  + (", each one replay of a CapturedStep" if graph else ""))
            gen = env.generator(SEED + (3 if graph else 1))
            recorder = FrameRecorder(kernels[path])
            attr = GENERAL_PATHS[path][0]
            setattr(gf, attr, recorder)
            try:
                for k in kernels.values():
                    k.launches = 0
                _, st = env.reset(B, gen)
                st, m = rollout(env, st, steps, gen, graph=graph)
                torch.cuda.synchronize()
            finally:
                setattr(gf, attr, kernels[path])
            counts = {n: k.launches for n, k in kernels.items()}
            m = {k: float(v) for k, v in m.items()}
            step_n = sum(f == env.frames_per_step for f in recorder.frames)
            print(f"  launches counted in Python: {counts} ({step_n} of {env.frames_per_step} "
                  f"frames){' (the warm-up step and the capture)' if graph else ''}; "
                  f"rollout {m}")
            others = sum(n for name, n in counts.items() if name != path)
            want = (steps * per_step + (1 if env.regulated else 0)) if not graph else None
            if others or (want is not None and counts[path] != want) or counts[path] < 1:
                raise AssertionError(f"{env_id}: {path} must launch {per_step} a step, alone")
            if not all(np.isfinite(list(m.values()))):
                raise AssertionError(f"{env_id}: non-finite metrics")
            for k in ("pos", "speed", "heading"):
                if not bool(torch.isfinite(getattr(st.vehicles, k)).all()):
                    raise AssertionError(f"{env_id}: non-finite {k}")
            if not graph:
                launches[f"{path} {env_id}"] = step_n
                continue
            prof = profile_replays(env, st, gen, list(gf_names.values()), kernels)
            ours = {n: prof["ours"].get(gf_names[n], 0.0) for n in gf_names}
            counted = {n: c for n, c in prof["counted"].items() if c}
            print(f"  profile of {PROFILE_REPLAYS} replays: {prof['kernels']:.1f} device "
                  f"kernels and {prof['busy_ms']:.4f} ms device busy per replay; per replay "
                  f"{ours}; counted by the wrappers over the capture {counted}")
            if counted != {path: per_step}:
                raise AssertionError(f"{env_id}: a capture launched {counted}, expected "
                                     f"{per_step} of {path} alone")
            if prof["kernels"] > 0 and (ours[path] != per_step or any(
                    v for n, v in ours.items() if n != path)):
                raise AssertionError(f"{env_id}: a replay launched {ours}, expected "
                                     f"{per_step} of {path} alone")


def drive_slice(envs, kernels, launches, crash_first: bool = False) -> None:
    """The slice's paths: each env of ``envs`` made on CUDA, reset and a
    HORIZON-step random-policy rollout through K4 at B, the counts set to
    0 just before and read just after: K4 once per policy step, alone.
    ``crash_first``: every CRASH_EVERY-th ego crashed at the start, so
    that episodes end within the horizon (parking-v0's last 100 s)."""
    k4 = kernels["K4"]
    for env_id, (env, _) in envs.items():
        print(f"== 4. slice path: make('{env_id}') on CUDA, B={B}, reset and {HORIZON} "
              "random-policy autoreset steps through K4")
        gen = env.generator(SEED + 1)
        for k in kernels.values():
            k.launches = 0
        _, st = env.reset(B, gen)
        if crash_first:
            st = crashed_every(env, st)
        st, m = rollout(env, st, HORIZON, gen)
        torch.cuda.synchronize()
        others = {n: k.launches for n, k in kernels.items() if n != "K4"}
        m = {k: float(v) for k, v in m.items()}
        print(f"  launches: K4 {k4.launches} in {HORIZON} policy steps, other kernels "
              f"{others}; rollout {m}")
        if k4.launches != HORIZON or any(others.values()):
            raise AssertionError(f"{env_id}: K4 must launch once per policy step, alone")
        if not all(np.isfinite(list(m.values()))) or not m["done_rate"] > 0:
            raise AssertionError(f"{env_id}: non-finite metrics or no episode ended")
        for k in ("pos", "speed", "heading"):
            if not bool(torch.isfinite(getattr(st.vehicles, k)).all()):
                raise AssertionError(f"{env_id}: non-finite {k}")
        launches[f"K4 {env_id}"] = k4.launches


def crashed_every(env, states, k: int = CRASH_EVERY):
    """``states`` with the ego of every k-th env crashed: their episodes end
    at the next step."""
    veh = states.vehicles
    crashed = veh.crashed.clone()
    crashed[::k, env.ego_slots[0]] = True
    return states.replace(vehicles=veh.replace(crashed=crashed))


def obs_fields(obs, name: str = "obs") -> dict:
    """An observation's tensors by name: itself, a dict one's fields, a
    tuple one's elements (one per ego), recursively."""
    if isinstance(obs, dict):
        parts = obs.items()
    elif isinstance(obs, tuple):
        parts = enumerate(obs)
    else:
        return {name: obs}
    return {k: v for key, part in parts for k, v in obs_fields(part, f"{name} {key}").items()}


def same_obs(a, b) -> bool:
    """Two observations (tensors, or dicts or tuples of them) bit-exact."""
    fa, fb = obs_fields(a), obs_fields(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def same_step(a, b, where: str) -> None:
    """Two autoreset steps' obs (every field of a dict one, every element of
    a tuple one), every field of
    the state, reward, terminated, truncated and (exit-v0, parking)
    ``info["is_success"]`` bit-exact."""
    import dataclasses

    oa, ob = obs_fields(a[0]), obs_fields(b[0])
    if oa.keys() != ob.keys():
        raise AssertionError(f"{where}: observation fields {list(oa)} and {list(ob)}")
    names = list(oa) + ["reward", "terminated", "truncated", "time", "steps"]
    pairs = list(oa.values()) + [a[2], a[3], a[4], a[1].time, a[1].steps]
    others = list(ob.values()) + [b[2], b[3], b[4], b[1].time, b[1].steps]
    if a[1].obs_stack is not None or b[1].obs_stack is not None:  # Grayscale
        names.append("obs_stack")
        pairs.append(a[1].obs_stack)
        others.append(b[1].obs_stack)
    for f in dataclasses.fields(a[1].vehicles):
        names.append(f.name)
        pairs.append(getattr(a[1].vehicles, f.name))
        others.append(getattr(b[1].vehicles, f.name))
    if "is_success" in a[5]:  # exit-v0, parking
        names.append("is_success")
        pairs.append(a[5]["is_success"])
        others.append(b[5]["is_success"])
    bad = [n for n, x, y in zip(names, pairs, others) if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{where}: differ in {bad}")


class PassCounter:
    """Stands in for an env's ``_compact_pass`` and counts its calls."""

    def __init__(self, env):
        self.env, self.fn, self.calls = env, env._compact_pass, 0

    def __enter__(self):
        self.env._compact_pass = self
        return self

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)

    def __exit__(self, *exc):
        del self.env._compact_pass


def check_compact(env, states, label: str, slots=COMPACT_SLOTS) -> None:
    """``reset_slots=P`` (each P of ``slots``) against the full autoreset:
    COMPACT_STEPS steps from ``states`` with every CRASH_EVERY-th ego
    crashed, from one generator state, each step's outputs bit-exact and the
    generators equal at the end; prints the done rows and the passes of each
    step."""
    start = crashed_every(env, states)
    n = start.time.shape[0]
    for P in slots:
        g_f, g_c = env.generator(200), env.generator(200)
        s_f = s_c = start
        log = []
        for t in range(COMPACT_STEPS):
            acts = random_actions(env, n, g_f)
            random_actions(env, n, g_c)
            out_f = env.step_autoreset_batched(s_f, acts, g_f)
            with PassCounter(env) as passes:
                out_c = env.step_autoreset_batched(s_c, acts, g_c, reset_slots=P)
            same_step(out_c, out_f, f"{label}P={P} step {t}")
            log.append(f"{int((out_f[3] | out_f[4]).sum())} done / {passes.calls} passes")
            s_f, s_c = out_f[1], out_c[1]
        if not torch.equal(g_f.get_state(), g_c.get_state()):
            raise AssertionError(f"{label}P={P}: the generators differ")
        print(f"  {label}compact P={P} vs full, B={n}: bit-exact on every field, obs, "
              f"reward, terminated, truncated; generator equal; per step {log}")


def check_graph(env, states, label: str, variants=None) -> None:
    """CapturedStep replays against eager steps: GRAPH_STEPS steps from one
    cloned state (every CRASH_EVERY-th ego crashed) and one cloned generator
    state, full and compact, and with ``final_obs`` (the vector env's
    terminal observations), bit-exact, the generators equal at the end.
    ``variants``: the (reset slots, final_obs) pairs, by default all."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.parallel.graph import CapturedStep

    start = crashed_every(env, states)
    n = start.time.shape[0]
    if variants is None:
        variants = [(P, False) for P in (None,) + COMPACT_SLOTS] + [(None, True), (64, True)]
    for P, final_obs in variants:
        g_e, g_g = env.generator(300), env.generator(300)
        s_e = map_fields(torch.clone, start)
        t0 = time.perf_counter()
        step = CapturedStep(env, start, g_g, reset_slots=P, final_obs=final_obs)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        where = f"{label}graph P={P}{' final_obs' if final_obs else ''}"
        dones = []
        for t in range(GRAPH_STEPS):
            acts = random_actions(env, n, g_e)
            acts_g = random_actions(env, n, g_g)
            out_e = env._autoreset_rest(*env._autoreset_first(s_e, acts, g_e, P, final_obs))
            out_g = step(acts_g)
            same_step(out_g, out_e, f"{where} step {t}")
            if final_obs and not same_obs(out_g[5]["final_obs"], out_e[5]["final_obs"]):
                raise AssertionError(f"{where} step {t}: final_obs differs")
            dones.append(int((out_e[3] | out_e[4]).sum()))
            s_e = out_e[1]
        if not torch.equal(g_e.get_state(), g_g.get_state()):
            raise AssertionError(f"{where}: the generators differ")
        print(f"  {label}CapturedStep P={P}{', final_obs' if final_obs else ''} vs eager, "
              f"{GRAPH_STEPS} steps, B={n}: bit-exact, generator equal; warm-up and capture "
              f"{capture_s:.3f} s; done rows {dones}")


def profile_replays(env, states, gen, kernel_names, counters: dict) -> dict:
    """Device kernels per replay of a CapturedStep of the full autoreset,
    from torch.profiler over PROFILE_REPLAYS replays: {kernel name: launches
    per replay} for the names containing one of ``kernel_names``, and the
    device busy time per replay; and, apart from the profiler's events,
    ``counted``: {name: launches per replay} of the wrappers ``counters``
    over the CapturedStep's build, whose eager warm-up step and capture make
    the same launches (a replay runs what was captured)."""
    from torch.profiler import ProfilerActivity, profile

    from highwayenv_tpu_torch.parallel.graph import CapturedStep

    for k in counters.values():
        k.launches = 0
    step = CapturedStep(env, states, gen)
    counted = {name: k.launches / 2 for name, k in counters.items()}
    step(torch.zeros_like(step.actions))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPLAYS):
            step(random_actions(env, states.time.shape[0], gen))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {}
    for name in kernel_names:
        count = sum(e.count for e in kernel_events(prof, name))
        if count:
            ours[name] = count / PROFILE_REPLAYS
    return {
        "ours": ours,
        "counted": counted,
        "kernels": sum(e.count for e in kernels) / PROFILE_REPLAYS,
        "busy_ms": sum(e.self_device_time_total for e in kernels) / PROFILE_REPLAYS / 1e3,
    }


def stepper(env, states, gen, reset_slots, graph: bool):
    """``step(actions)``: random-policy autoreset steps from a copy of
    ``states``, eager or one replay of a CapturedStep (built here), and
    the action draw; one step taken, untimed."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.parallel.graph import CapturedStep

    if graph:
        step = CapturedStep(env, states, gen, reset_slots=reset_slots)
    else:
        box = [map_fields(torch.clone, states)]

        def step(acts):
            out = env.step_autoreset_batched(box[0], acts, gen, reset_slots=reset_slots)
            box[0] = out[1]
            return out

    n = states.time.shape[0]

    def acts():
        return random_actions(env, n, gen)

    step(acts())
    torch.cuda.synchronize()
    return lambda: step(acts())


def timed_steps(env, states, gen, steps: int, reset_slots, graph: bool) -> float:
    """Wall ms per step of ``steps`` steps (host clock, synchronized at both
    ends); a CapturedStep is built before the clock starts."""
    step = stepper(env, states, gen, reset_slots, graph)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def step_device_ms(env, states, gen, reset_slots, graph: bool):
    """(device busy ms, device kernels) per step (torch.profiler, kernels'
    self device time) over PROFILE_REPLAYS steps."""
    from torch.profiler import ProfilerActivity, profile

    step = stepper(env, states, gen, reset_slots, graph)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPLAYS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / PROFILE_REPLAYS / 1e3,
            sum(e.count for e in kernels) / PROFILE_REPLAYS)


class FrameRecorder:
    """Stands in for the K5 wrapper during a rollout and keeps the frame
    count of each call, so the step launches (15 frames) and the warm-up
    launches (45 frames) can be told apart after."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.frames = []

    def __call__(self, veh, spec, slot_actions, frames, *args, **kwargs):
        self.frames.append(frames)
        return self.kernel(veh, spec, slot_actions, frames, *args, **kwargs)


class PlainKernels:
    """Within it, every frame kernel wrapper of the env path stands in for
    its plain torch version: the same path, each kernel replaced by the
    function it is held to (K2a, K3, K2b and masked K1 on the sorted step,
    K1 on the dense one, every K4 / K5 instantiation on the general one).
    The wrappers' launch counts do not move."""

    def __init__(self, ss, sf, gf):
        def frames(veh, fs, p, dt, frames, mask=None, out=None, raw=False, linear=True,
                   objects=False):
            if mask is None:
                return sf.frames_plain(veh, fs, p, dt, frames, raw)
            return sf._masked_plain(veh, fs, p, dt, frames, mask, out, raw)

        def sorted_frames(srt, idx, fs, p, dt, frames, raw=False, linear=True):
            return ss.frames_sorted_plain(srt, idx, fs, p, dt, frames, raw)

        def general(veh, spec, slot_actions, frames, steps0=None, raw=False, linear=True):
            return gf.frames_general_plain(veh, spec, slot_actions, frames, steps0, raw)

        self.plain = [(ss, "sort_kernel", ss.sort_plain),
                      (ss, "frames_sorted_kernel", sorted_frames),
                      (ss, "unsort_kernel", ss.unsort_plain),
                      (sf, "frames_kernel", frames)]
        self.plain += [(gf, attr, general) for attr, _ in GENERAL_PATHS.values()]
        self.saved = []

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.plain]
        for mod, name, fn in self.plain:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _copied(x):
    """A copy of a kernel call's argument: its tensors cloned (a state's
    field by field), the specs and numbers as they are."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.vehicle.state import VehicleState

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, VehicleState):
        return map_fields(torch.clone, x)
    if type(x) in (tuple, list):  # a spec (a NamedTuple) is kept as it is
        return type(x)(_copied(v) for v in x)
    if type(x) is dict:
        return {k: _copied(v) for k, v in x.items()}
    return x


def _out_tensors(x) -> list:
    """The tensors of a kernel's output (a state, a tensor or a tuple)."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _out_tensors(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _out_tensors(v)]
    return []


class KernelInputs:
    """Within it, every frame kernel wrapper of the env path logs each call
    (wrapper, rows, frames of a general one) and keeps a copy of the inputs
    of its first call of each kind, so that after a path's run, its counts
    read, each kernel is held against its plain version on inputs the path
    gave it (``check``).  The wrappers still launch and count."""

    ROW_OF = {"sort_kernel": "K2a", "frames_sorted_kernel": "K3", "unsort_kernel": "K2b",
              "frames_kernel": "K1"}

    def __init__(self, ss, sf, gf):
        self.gf = gf
        self.plain = PlainKernels(ss, sf, gf).plain
        self.log = []
        self.kept = {}
        self.saved = []

    def __enter__(self):
        self.log.clear()
        self.kept.clear()
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.plain]
        for (mod, name, kernel), (_, _, plain) in zip(self.saved, self.plain):
            setattr(mod, name, self._keeper(mod, name, kernel, plain))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _keeper(self, mod, name, kernel, plain):
        def call(*args, **kwargs):
            key = (name, args[0].speed.shape[0], args[3] if mod is self.gf else None)
            self.log.append(key)
            if key not in self.kept:
                self.kept[key] = (kernel, plain, _copied(args), _copied(kwargs))
            return kernel(*args, **kwargs)

        return call

    def row(self, env, key) -> str:
        """The kernel row of a logged call: "K1" .. "K2b", or for K5 "K5
        step" / "K5 warm-up" by its frame count."""
        name, _, frames = key
        if name in self.ROW_OF:
            return self.ROW_OF[name]
        if name != "frames_regulated_kernel":
            raise AssertionError(f"a call of {name} where this path runs K1-K3 or K5")
        return "K5 step" if frames == env.frames_per_step else "K5 warm-up"

    def launches(self, env) -> dict:
        """The logged calls, counted by row."""
        out = {}
        for key in self.log:
            out[self.row(env, key)] = out.get(self.row(env, key), 0) + 1
        return out

    def check(self, env, where: str) -> dict:
        """Each kept call's kernel against its plain version, both on copies
        of its inputs, every output tensor bit-exact: {row: max abs err}."""
        err = {}
        for key, (kernel, plain, args, kwargs) in self.kept.items():
            got = _out_tensors(kernel(*_copied(args), **_copied(kwargs)))
            want = _out_tensors(plain(*_copied(args), **_copied(kwargs)))
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
            if len(got) != len(want) or bad:
                raise AssertionError(f"{where}: {key} differs from its plain version in "
                                     f"outputs {bad}")
            e = max([float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)
                     if a.is_floating_point() and a.numel()] + [0.0])
            row = self.row(env, key)
            err[row] = max(err.get(row, 0.0), e)
        return err


def state_tensors(state, prefix: str = "") -> dict:
    """Every tensor of an EnvState (its vehicles' fields and any field of the
    env's own state type, lane-keeping's noise) by name."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(state_tensors(v, f"{prefix}{f.name}."))
        elif v is not None:  # the frame stack of an env without one is None
            out[prefix + f.name] = v
    return out


def same_single(a, b, where: str) -> None:
    """A seeded reset's (obs, state), or a step's (obs, state, reward,
    terminated, truncated, info), against another: every tensor bit-exact."""
    fa, fb = obs_fields(a[0]), obs_fields(b[0])
    fa.update(state_tensors(a[1], "state.")), fb.update(state_tensors(b[1], "state."))
    if len(a) > 2:
        for k, name in ((2, "reward"), (3, "terminated"), (4, "truncated")):
            fa[name], fb[name] = a[k], b[k]
        fa.update(obs_fields(a[5], "info")), fb.update(obs_fields(b[5], "info"))
    if fa.keys() != fb.keys():
        raise AssertionError(f"{where}: fields {sorted(fa)} and {sorted(fb)}")
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    if bad:
        raise AssertionError(f"{where}: kernels and plain versions differ in {bad}")


def drive_single_env(ht, ss, sf, gf, kernels, card: str) -> dict:
    """The single-env seeded path, the slice's main path: every
    registered id made on CUDA at its registered config, B=1, a seeded
    reset (``reset_seeded``: the reference's NumPy draw order on the host,
    and on the intersection ids the 3 s warm-up, one K5 launch) and
    SINGLE_STEPS policy steps of ``step_batched`` (what the Gymnasium
    ``GymEnv`` calls) under ``random_actions``, the counts set to 0 just
    before and read just after: the straight ids launch K2a, K3, K2b and
    masked K1 once a step, the general ids their K4 instantiation once a
    step, the intersection ids their K5 instantiation once a step and once
    for the warm-up, and nothing else.  Then, at the first id of each
    instantiation (ids that share one are held once), the same reset
    and steps with every kernel stood in for by its plain version
    (``PlainKernels``): obs, every field of the state, reward, flags and
    info bit-exact.
    Prints the host ms of the seeded reset and the ms of an eager B=1 step
    per id; returns the B=1 launches summed over the ids by kernel."""
    totals = {name: 0 for name in kernels}
    held = set()  # the instantiations held to their plain versions
    for env_id in ht.registered_ids():
        env = ht.make(env_id)
        spec = env._general
        if spec is None:
            path = ("K1", "K2a", "K3", "K2b")
        else:
            path = (("K5" if env.regulated else "K4") + (" connected" if spec.connected else "")
                    + (" dynamical" if spec.dynamical else ""),)
        acts = [random_actions(env, 1, env.generator(SEED + t)) for t in range(SINGLE_STEPS)]
        recorder = None
        if env.regulated:
            recorder = FrameRecorder(kernels[path[0]])
            setattr(gf, GENERAL_PATHS[path[0]][0], recorder)
        try:
            for k in kernels.values():
                k.launches = 0
            gen = torch.Generator(device=env.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_k = env.reset_seeded(seed=SEED, generator=gen)
            torch.cuda.synchronize()
            reset_ms = (time.perf_counter() - t0) * 1e3
            steps_k, step_ms, st = [], [], reset_k[1]
            for a in acts:
                t0 = time.perf_counter()
                out = env.step_batched(st, a, gen)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                steps_k.append(out)
                st = out[1]
        finally:
            if recorder is not None:
                setattr(gf, GENERAL_PATHS[path[0]][0], kernels[path[0]])
        counts = {n: k.launches for n, k in kernels.items() if k.launches}
        want = {n: SINGLE_STEPS + (1 if env.regulated else 0) for n in path}
        if counts != want:
            raise AssertionError(f"{env_id} single env: launches {counts}, expected {want}")
        if recorder is not None and sorted(recorder.frames) != sorted(
                [env.frames_per_step] * SINGLE_STEPS + [env._warmup_frames]):
            raise AssertionError(f"{env_id} single env: K5 frames {recorder.frames}")
        for n, c in counts.items():
            totals[n] += c
        plain = path not in held
        if plain:
            held.add(path)
            with PlainKernels(ss, sf, gf):
                gen = torch.Generator(device=env.device)
                reset_p = env.reset_seeded(seed=SEED, generator=gen)
                same_single(reset_k, reset_p, f"{env_id} seeded reset")
                st = reset_p[1]
                for t, a in enumerate(acts):
                    out = env.step_batched(st, a, gen)
                    same_single(steps_k[t], out, f"{env_id} step {t}")
                    st = out[1]
        veh = steps_k[-1][1].vehicles
        for k in ("pos", "speed", "heading"):
            if not bool(torch.isfinite(getattr(veh, k)).all()):
                raise AssertionError(f"{env_id} single env: non-finite {k}")
        mid = sorted(step_ms)[len(step_ms) // 2]
        print(f"  {env_id}: V={env.num_slots}, launches {counts}; seeded reset and "
              f"{SINGLE_STEPS} steps " + ("bit-exact against the plain versions" if plain
                                          else "(instantiation held at an earlier id)")
              + "; rewards "
              f"{[round(float(o[2][0]), 6) for o in steps_k]}; seeded reset {reset_ms:.3f} ms "
              f"on the host, a B=1 eager step {mid:.3f} ms median (min {min(step_ms):.3f}, "
              f"first {step_ms[0]:.3f}) ({card})")
    return totals


class FlagRecorder:
    """Stands in for the K3 wrapper during a rollout and keeps each step's
    per-env flags (on the device), so the firing share can be read after."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.flags = []

    def __call__(self, *args, **kwargs):
        out, flags = self.kernel(*args, **kwargs)
        self.flags.append(flags)
        return out, flags


def check_frames_cpu(ht, env_id, env, states, label: str) -> str:
    """The env's Grayscale frames of the first GRAY_CPU_ROWS rows of
    ``states`` on CUDA against the CPU's plain torch frames of the same
    states copied over: at least GRAY_MIN_EQUAL of each frame's pixels equal
    and none off by more than GRAY_MAX_LEVELS.  Returns the count."""
    from highwayenv_tpu_torch.envs.base import map_fields

    cpu = ht.make(env_id, GRAY_CONFIG, device="cpu")
    veh = map_fields(lambda t: t[:GRAY_CPU_ROWS], states.vehicles)
    got = env.observation_type.frame(env.geo, veh, env.ego_slots[0]).cpu()
    want = cpu.observation_type.frame(cpu.geo, map_fields(lambda t: t.cpu(), veh),
                                      cpu.ego_slots[0])
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs().flatten(1)
    equal = (diff == 0).double().mean(dim=1)
    off, n = int((diff > 0).sum()), diff.numel()
    if float(equal.min()) < GRAY_MIN_EQUAL or int(diff.max()) > GRAY_MAX_LEVELS:
        raise AssertionError(f"{label}: CUDA frames against the CPU's: {off} of {n} pixels "
                             f"differ, max {int(diff.max())} levels, a frame "
                             f"{float(equal.min()):.5f} equal")
    return f"{off} of {n} pixels differ (max {int(diff.max())} levels)"


def check_grayscale(ht, kernels, launches, rows, err, card: str, start: float) -> dict:
    """GrayscaleObservation on the card.

    highway-v0 (V=51) at GRAY_B with GRAY_CONFIG, the counts set to 0 just
    before a GRAY_SMALL_STEPS-step random-policy rollout and read just
    after: K1, K2a, K3 and K2b once a policy step, as at one-ego
    highway-v0, and no other kernel; K1, K2a, K3 and K2b against their
    plain versions on the reset scene, bit-exact (their errors in ``err``
    under "K1 grayscale" ..); then the compact autoreset (P = GRAY_B / 4)
    against the full one and the captured full step against the eager one,
    the stack included, bit-exact; the CUDA frames against the CPU's
    (``check_frames_cpu``) of the reset batch and of the rollout's last
    state; eager and graph ms per step (three runs each, in turns), a
    profile of replays, the step's peak device memory (at most
    GRAY_MAX_BYTES pro rata), and the rows "K1 grayscale" ..
    "K2b grayscale": the Grayscale path's launches beside the times of
    the same kernels on the main path's highway-v0 scene (phase 5: the
    state the kernels read is the same under any observation).  Then
    intersection-v0 (K5: twice a step and once for the first reset) and
    racetrack-v0 (K4 raw: once a step) at GRAY_SMALL_B and
    GRAY_SMALL_STEPS steps, the curved chords: the same equalities
    (compact at P = GRAY_SMALL_B / 4, further passes) and launches.
    Returns {env_id: (env, states)}."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.parallel.graph import CapturedStep

    out = {}
    for env_id, n, path in (("highway-v0", GRAY_B, ("K1", "K2a", "K3", "K2b")),
                            ("intersection-v0", GRAY_SMALL_B, ("K5",)),
                            ("racetrack-v0", GRAY_SMALL_B, ("K4",))):
        env = ht.make(env_id, GRAY_CONFIG)
        label = f"{env_id} Grayscale"
        steps = GRAY_SMALL_STEPS  # at GRAY_B too: HORIZON was cut for the time limit
        main = env_id == "highway-v0"
        print(f"== 4. Grayscale path: make('{env_id}', {GRAY_CONFIG}) on CUDA, B={n}, "
              f"V={env.num_slots}, reset and {steps} random-policy autoreset steps "
              f"[at {time.time() - start:.0f} s]")
        gen = env.generator(SEED + 20)
        for k in kernels.values():
            k.launches = 0
        obs, states = env.reset(n, gen)
        if obs.shape != (n, 4, 128, 64) or obs.dtype != torch.uint8:
            raise AssertionError(f"{label}: observation {tuple(obs.shape)} {obs.dtype}")
        if bool(obs[:, :3].any()) or not bool(obs[:, 3].any(dim=(1, 2)).all()):
            raise AssertionError(f"{label}: a reset stack is not three zero frames and one")
        last, m = rollout(env, states, steps, gen)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items() if k.launches}
        want = {name: steps for name in path}
        if env.regulated:
            want = {"K5": 2 * steps + 1}
        m = {k: float(v) for k, v in m.items()}
        print(f"  launches {counts}; rollout {m}")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if not all(np.isfinite(list(m.values()))):
            raise AssertionError(f"{label}: non-finite metrics")
        for name, c in counts.items():
            launches[f"{name} grayscale" + ("" if main else f" {env_id}")] = c
        for what, st in (("reset", states), (f"{steps} steps in", last)):
            print(f"  CUDA frames against the CPU's, {what}, {GRAY_CPU_ROWS} rows: "
                  + check_frames_cpu(ht, env_id, env, st, f"{label} {what}"))
        check_compact(env, states, label + " ", slots=(n // 4,))
        check_graph(env, states, label + " ", variants=((None, False),))
        out[env_id] = (env, states)
        if not main:
            continue

        # the path's times at GRAY_B
        walls = {name: [] for name in ("eager full", "graph full")}
        for r in range(3):
            for name in (("eager full", "graph full") if r % 2 == 0
                         else ("graph full", "eager full")):
                walls[name].append(timed_steps(env, states, env.generator(SEED + 5),
                                               TIMED_STEPS, None, name == "graph full"))
        for name, ws in walls.items():
            mid = sorted(ws)[1]
            print(f"  {label} {name}: " + ", ".join(f"{w:.4f}" for w in ws)
                  + f" ms per step at B={n} ({n * 1e3 / mid:.1f} env-steps/s at the median; "
                  f"{card})")
        # (the steps' device busy time, and the head's and the push's device
        # ms, are cut for the time limit: a profile of ~10,800 kernels a step)
        names = ("straight_frames_kernel", "sort_kernel", "straight_frames_sorted_kernel",
                 "unsort_kernel")
        prof = profile_replays(env, states, env.generator(SEED + 6), names, kernels)
        counted = {n: c for n, c in prof["counted"].items() if c}
        print(f"  {label} graph full, profile of {PROFILE_REPLAYS} replays: "
              f"{prof['kernels']:.1f} device kernels and {prof['busy_ms']:.4f} ms device busy "
              f"per replay; the port's kernels per replay {prof['ours']}; counted by the "
              f"wrappers over the capture {counted} ({card})")
        if counted != {name: 1.0 for name in path}:
            raise AssertionError(f"{label}: a capture launched {counted}, expected one of "
                                 f"each of {path}")
        if prof["kernels"] > 0 and any(prof["ours"].get(k, 0.0) != 1.0 for k in names):
            raise AssertionError(f"{label}: a replay launched {prof['ours']}, expected one "
                                 "of each sorted-path kernel")
        peaks = {}
        for name, P in (("full", None), (f"compact P={n // 4}", n // 4)):
            st = map_fields(torch.clone, states)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            env.step_autoreset_batched(st, random_actions(env, n, gen), gen, reset_slots=P)
            torch.cuda.synchronize()
            peaks[f"eager {name}"] = torch.cuda.max_memory_allocated()
            peaks[f"eager {name}, above the state"] = peaks[f"eager {name}"] - base
        torch.cuda.reset_peak_memory_stats()
        cap = CapturedStep(env, states, env.generator(SEED + 7))
        cap(random_actions(env, n, gen))
        torch.cuda.synchronize()
        peaks["captured full (capture and a replay)"] = torch.cuda.max_memory_allocated()
        del cap
        print(f"  {label} peak device memory (max_memory_allocated, bytes): {peaks} ({card})")
        if max(peaks.values()) > GRAY_MAX_BYTES * n / B:
            raise AssertionError(f"{label}: peak device memory {max(peaks.values())} bytes")
        check_gray_kernels(env, states, err)
        for name in path:
            main = rows[name]
            rows[f"{name} grayscale"] = (
                main[0] + " (highway-v0 Grayscale path; timed on the main path's scene)",
            ) + main[1:]
        torch.cuda.empty_cache()
    return out


def check_gray_kernels(env, states, err) -> None:
    """K1, K2a, K3 and K2b against their plain versions on the Grayscale
    path's reset scene with random actions applied, every field bit-exact;
    their max errors in ``err`` under "K1 grayscale" .. "K2b grayscale"."""
    from highwayenv_tpu_torch.ops import straight_frames as sf, straight_sorted as ss

    fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
    n = states.time.shape[0]
    sa = env._action_to_slots(random_actions(env, n, env.generator(SEED + 21)))
    veh = env.action_type.apply(env.geo, states.vehicles, states.vehicles.kind == 1, sa)
    where = "highway-v0 Grayscale reset"
    err["K1 grayscale"] = exact_state(sf.frames_kernel(veh, fs, p, dt, frames, linear=False),
                                      sf.frames_plain(veh, fs, p, dt, frames), f"{where} K1")
    srt_k, idx_k = ss.sort_kernel(veh, fs)
    srt_p, idx_p = ss.sort_plain(veh, fs)
    if not torch.equal(idx_k, idx_p):
        raise AssertionError(f"{where} K2a: idx differs")
    exact(srt_k, srt_p, [name for name, _, _ in ss.SORT_FIELDS], f"{where} K2a")
    band_k, flags_k = ss.frames_sorted_kernel(srt_p, idx_p, fs, p, dt, frames, linear=False)
    band_p, flags_p = ss.frames_sorted_plain(srt_p, idx_p, fs, p, dt, frames)
    if not torch.equal(flags_k, flags_p):
        raise AssertionError(f"{where} K3: flags differ")
    err["K3 grayscale"] = exact_state(band_k, band_p, f"{where} K3")
    exact(ss.unsort_kernel(band_p, idx_p, veh), ss.unsort_plain(band_p, idx_p, veh),
          [name for name, _, _ in ss.MUT_FIELDS], f"{where} K2b")
    err["K2a grayscale"] = err["K2b grayscale"] = 0.0
    print(f"  {where}: K1, K2a, K3 (flags too) and K2b bit-exact against their plain versions")

def check_render(ht, gray) -> None:
    """``render.render_rgb`` of row 0 of a CUDA state equal to the same
    from the state copied to the CPU, at highway-v0 and intersection-v0."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.render import render_rgb

    for env_id in ("highway-v0", "intersection-v0"):
        env, states = gray[env_id]
        cpu = ht.make(env_id, GRAY_CONFIG, device="cpu")
        got = render_rgb(env, states)
        want = render_rgb(cpu, map_fields(lambda t: t.cpu(), states))
        if got.shape != (env.config["screen_height"], env.config["screen_width"], 3) or (
                not np.array_equal(got, want)):
            raise AssertionError(f"{env_id}: render_rgb of a CUDA state differs "
                                 "from its CPU copy's")
        print(f"  render_rgb {env_id}: {got.shape} frame of row 0 on CUDA equal to "
              "its CPU copy's")


def check_sequential(ht, kernels, card: str) -> None:
    """``sequential_decisions`` (the reference's decision order, plain torch
    frames) at SEQ_IDS, B=SEQ_B, the counts set to 0 just before and read
    just after: the reset's scenes (intersection-v0's warm-up included) and
    SEQ_STEPS policy steps' frames on CUDA against the CPU on the same
    inputs (the draws, then each step's state copied over): discrete fields
    equal, pos within POS_ATOL; no frame kernel launched; ms per
    ``step_batched`` step on CUDA."""
    import dataclasses

    from highwayenv_tpu_torch.envs.base import map_fields

    for k in kernels.values():
        k.launches = 0
    for env_id in SEQ_IDS:
        cfg = {"sequential_decisions": True}
        env, cpu = ht.make(env_id, cfg), ht.make(env_id, cfg, device="cpu")
        if not (env._general.sequential and env._straight is None):
            raise AssertionError(f"{env_id}: sequential_decisions is not on the plain frames")
        gen = env.generator(SEED + 30)
        draws = env._reset_draws(SEQ_B, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = env._place_state(draws)
        torch.cuda.synchronize()
        reset_ms = (time.perf_counter() - t0) * 1e3
        pairs = [("reset", st, cpu._place_state({k: v.cpu() for k, v in draws.items()}))]
        step_ms = []
        for t in range(SEQ_STEPS):
            acts = random_actions(env, SEQ_B, gen)
            sim = env._simulate_batched(st, acts)
            pairs.append((f"step {t}", sim, cpu._simulate_batched(
                map_fields(lambda x: x.cpu(), st), acts.cpu())))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = env.step_batched(st, acts, gen)[1]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        pos_err = 0.0
        for what, a, b in pairs:
            for f in dataclasses.fields(a.vehicles):
                x, y = getattr(a.vehicles, f.name).cpu(), getattr(b.vehicles, f.name)
                if f.name in DISCRETE + ("kind", "route_ptr", "speed_index", "is_yielding"):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{env_id} sequential {what}: {f.name} differs "
                                             "between CUDA and the CPU")
            pos_err = max(pos_err, float((a.vehicles.pos.cpu() - b.vehicles.pos).abs().max()))
        if pos_err > POS_ATOL:
            raise AssertionError(f"{env_id} sequential: pos differs by {pos_err} m")
        print(f"  {env_id} sequential_decisions, V={env.num_slots}, B={SEQ_B}: the reset and "
              f"{SEQ_STEPS} steps' frames on CUDA against the CPU: discrete fields equal, pos "
              f"err {pos_err:.3e} m; the reset's placement {reset_ms:.1f} ms, a step "
              + ", ".join(f"{t:.1f}" for t in step_ms) + f" ms on CUDA ({card})")
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    if counts:
        raise AssertionError(f"sequential_decisions launched frame kernels: {counts}")
    print("  no frame kernel launched in the sequential_decisions runs")


# The robust-control tools: interval observers, LPV predictors,
# poly lanes, the route-choice preprocessor and the route-hypothesis tracker
RC_B = 4096  # observers, LPV systems, query points a lane, rows of the batch
RC_OBS_TOL = 1e-5  # observer bounds, CUDA against the CPU, of their magnitude
RC_LPV_TOL = 1e-6  # LPV intervals over RC_LPV_STEPS, of their magnitude
RC_LPV_STEPS = 20
RC_STEPS = 8  # K5 steps of the rerouted intersection-v0 batch (tracked)
RC_PLAIN_STEPS = 4  # of them held to the plain path
RC_ROUTE_OPTIONS = (0, 1, 2, 5, "random")
RC_WAIT_CYCLES = 500_000_000  # ~0.25 s: the device-side wait before a queued step


def rel_err(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def observer_inputs(net, geo_cpu, rng, n: int):
    """``observer_step_batch``'s inputs for n observers on random lanes of
    ``net`` (CPU tensors): a box around a point of the lane, a speed and a
    heading interval, and a front box 15 m ahead on the same lane."""
    from highwayenv_tpu_torch.ops import uncertainty as unc
    from highwayenv_tpu_torch.road import lane as lane_ops

    L = geo_cpu.num_lanes
    lane = torch.from_numpy(rng.integers(0, L, n).astype(np.int32))
    length = geo_cpu.length[lane.long()]
    s = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32)) * length
    lat = torch.from_numpy(rng.uniform(-1.0, 1.0, n).astype(np.float32))
    pos = lane_ops.position(geo_cpu, lane, s, lat)
    half = torch.from_numpy(rng.uniform(0.1, 0.5, (n, 2)).astype(np.float32))
    psi = lane_ops.heading_at(geo_cpu, lane, s)
    v = torch.from_numpy(rng.uniform(3.0, 12.0, n).astype(np.float32))
    fpos = lane_ops.position(geo_cpu, lane, s + 15.0, torch.zeros_like(s))
    f32 = torch.float32
    return dict(
        target_lane=lane, target_speed=v + 2.0,
        theta_a_i=torch.as_tensor(unc.ACCELERATION_RANGE, dtype=f32).expand(n, 2, 3).clone(),
        theta_b_i=torch.as_tensor(unc.STEERING_RANGE, dtype=f32).expand(n, 2, 2).clone(),
        position_i=torch.stack([pos - half, pos + half], 1),
        speed_i=torch.stack([v - 0.5, v + 0.5], -1),
        heading_i=torch.stack([psi - 0.05, psi + 0.05], -1),
        position=pos,
    ), dict(
        front_position_i=torch.stack([fpos - 0.5, fpos + 0.5], 1),
        front_speed_i=torch.stack([v - 2.0, v - 1.0], -1),
        front_mask=torch.from_numpy(rng.uniform(size=n) < 0.5),
    )


def check_observer_batch(ht, card: str) -> None:
    """``observer_step_batch`` at RC_B observers on intersection-v0's lanes
    (straight and circular) and on a network of poly lanes, without and with
    fronts: CUDA against the CPU on the same inputs, every bound within
    RC_OBS_TOL of its magnitude; the device ms of one batched step (CUDA
    events around steps queued behind a device-side wait) and its wall ms."""
    from highwayenv_tpu_torch.ops import uncertainty as unc
    from highwayenv_tpu_torch.road import network

    poly = network.RoadNetworkBuilder()
    for k, lane in enumerate(poly_lanes(network)):
        poly.add_lane("p", f"q{k}", lane)
    nets = {"intersection-v0": ht.make("intersection-v0", device="cpu").net, "poly lanes": poly}
    rng = np.random.default_rng(SEED + 41)
    for name, net in nets.items():
        geo_cpu, geo = net.build("cpu"), net.build("cuda")
        args, fronts = observer_inputs(net, geo_cpu, rng, RC_B)
        for with_front in (False, True):
            kw_cpu = {**args, **(fronts if with_front else {})}
            kw = {k: v.cuda() for k, v in kw_cpu.items()}
            got = unc.observer_step_batch(geo, **kw, dt=0.1)
            want = unc.observer_step_batch(geo_cpu, **kw_cpu, dt=0.1)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            if max(errs) > RC_OBS_TOL or not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"observer_step_batch {name} fronts={with_front}: CUDA "
                                     f"against the CPU {errs} (tolerance {RC_OBS_TOL})")
            def step():
                return unc.observer_step_batch(geo, **kw, dt=0.1)

            # one step is ~300 launches: queued alone, so that the CUDA
            # launch queue never fills and the events bracket device time
            dev_ms = queued_ms(step, 1, RC_WAIT_CYCLES)
            prof_ms = device_ms(step, 3)
            wall_ms = cuda_ms(step, 20)
            print(f"  observer_step_batch on {name}, B={RC_B}, fronts {with_front}: CUDA against "
                  f"the CPU (position, speed, heading) {errs[0]:.3e} {errs[1]:.3e} "
                  f"{errs[2]:.3e} of magnitude; a step {dev_ms:.4f} ms on the device (queued), "
                  f"its kernels {prof_ms:.4f} ms (profiler), {wall_ms:.4f} ms back to back "
                  f"({card})")


def lpv_systems():
    """The interval observer's longitudinal LPV (Metzler), its lateral one
    (the naive branch) and the lateral one over a steering box whose mean
    matrix has real eigenvalues (its eigenbasis coordinates)."""
    from highwayenv_tpu_torch.ops import interval as iv
    from highwayenv_tpu_torch.ops import uncertainty as unc

    obs = unc.IntervalObserver(geo=None, target_lane=0, target_speed=25.0)
    a, phi = obs._longitudinal_structure(front_exists=True, at_safe_gap=False)
    a0, da = iv.polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), obs.theta_a_i)
    x0 = [10.0, 40.0, 20.0, 15.0]
    out = {"longitudinal": iv.LPV(x0, a0, da, b=np.eye(4), d=np.array([[1], [0], [0], [0]]),
                                  omega_i=np.array([[-1], [1]]) * 1.0,
                                  u=[[25.0], [25.0], [0], [0]],
                                  center=[-72.5, 0, 25.0, 25.0])}
    a, phi = obs._lateral_structure()
    for name, box in (("lateral", obs.theta_b_i),
                      ("lateral eigenbasis", np.array([[6.0, 1.0], [8.0, 3.0]]))):
        a0, da = iv.polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), box)
        out[name] = iv.LPV([0.3, 0.02], a0, da, b=np.identity(2), d=np.array([[1], [0]]),
                           omega_i=np.array([[-1], [1]]) * 0.5, u=[[0], [0]], center=[0, 0])
    return out


def check_lpv(card: str) -> None:
    """``lpv_step`` at RC_B systems over RC_LPV_STEPS steps, each system's
    float32 params: CUDA against the CPU on the same seeded boxes within
    RC_LPV_TOL of magnitude, TF32 off."""
    from highwayenv_tpu_torch.ops import interval as iv

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    rng = np.random.default_rng(SEED + 42)
    for name, lpv in lpv_systems().items():
        p = lpv.params
        branch = "Metzler" if p.metzler else "naive"
        N, U, W = p.a0.shape[0], p.b.shape[1], p.d.shape[1]
        x = torch.from_numpy(np.sort(rng.normal(size=(RC_B, 2, N)) * 3, 1).astype(np.float32))
        u = torch.from_numpy(rng.normal(size=(RC_B, U)).astype(np.float32))
        om = torch.from_numpy(np.sort(rng.normal(size=(RC_B, 2, W)), 1).astype(np.float32))
        pc = p.to("cuda")
        xc, uc, omc = x.cuda(), u.cuda(), om.cuda()
        err = 0.0
        for _ in range(RC_LPV_STEPS):
            x = iv.lpv_step_batch(p, x, u, om, 0.05)
            xc = iv.lpv_step_batch(pc, xc, uc, omc, 0.05)
            err = max(err, rel_err(xc, x))
        if err > RC_LPV_TOL or not bool(torch.isfinite(xc).all()):
            raise AssertionError(f"lpv_step {name}: CUDA against the CPU {err:.3e}")
        step_ms = queued_ms(lambda: iv.lpv_step_batch(pc, xc, uc, omc, 0.05), 1,
                            RC_WAIT_CYCLES)
        wall_ms = cuda_ms(lambda: iv.lpv_step_batch(pc, xc, uc, omc, 0.05), 20)
        if lpv.coordinates is None:
            coords = "world"
        elif np.array_equal(lpv.coordinates[0], np.eye(N)):
            coords = "identity"
        else:
            coords = "eigenbasis"
        print(f"  lpv_step {name} ({branch} branch, {coords} coordinates), B={RC_B}, "
              f"{RC_LPV_STEPS} steps: CUDA against the CPU {err:.3e} of magnitude; a step "
              f"{step_ms:.4f} ms on the device (queued), {wall_ms:.4f} ms back to back "
              f"({card})")


def check_poly_ops(card: str) -> None:
    """The poly lane ops on RC_B points a lane (before the start, along the
    lane, past the end): the winning pose index equal, CUDA against the CPU,
    and ``local_coordinates``, ``position``, ``heading_at``, ``width_at``
    within RC_OBS_TOL of magnitude."""
    from highwayenv_tpu_torch.road import lane as lane_ops
    from highwayenv_tpu_torch.road import network

    net = network.RoadNetworkBuilder()
    for k, lane in enumerate(poly_lanes(network)):
        net.add_lane("p", f"q{k}", lane)
    geo_cpu, geo = net.build("cpu"), net.build("cuda")
    rng = np.random.default_rng(SEED + 43)
    for g, spec in enumerate(net.lanes_on_edge("p", "q0") + net.lanes_on_edge("p", "q1")):
        s = torch.from_numpy(rng.uniform(-8.0, spec.length + 8.0, RC_B).astype(np.float32))
        lat = torch.from_numpy(rng.uniform(-4.0, 4.0, RC_B).astype(np.float32))
        lane = torch.full((RC_B,), g, dtype=torch.int32)
        pos = lane_ops.position(geo_cpu, lane, s, lat)
        out = {}
        for dev, gg in (("cpu", geo_cpu), ("cuda", geo)):
            ln, p_, s_, l_ = lane.to(dev), pos.to(dev), s.to(dev), lat.to(dev)
            sc, lc = lane_ops.local_coordinates(gg, ln, p_)
            out[dev] = dict(pose=lane_ops.poly_pose_index(gg, ln, p_), s=sc, lat=lc,
                            position=lane_ops.position(gg, ln, s_, l_),
                            heading=lane_ops.heading_at(gg, ln, s_),
                            width=lane_ops.width_at(gg, ln, s_))
        if not torch.equal(out["cuda"]["pose"].cpu(), out["cpu"]["pose"]):
            raise AssertionError(f"poly lane {g}: the winning pose index differs")
        errs = {k: rel_err(out["cuda"][k], out["cpu"][k]) for k in out["cpu"] if k != "pose"}
        if max(errs.values()) > RC_OBS_TOL:
            raise AssertionError(f"poly lane {g}: CUDA against the CPU {errs}")
        ends = int((out["cpu"]["s"] < 0).sum()), int((out["cpu"]["s"] > spec.length).sum())
        print(f"  poly lane {g} ({type(spec).__name__}, {spec.length:.1f} m, "
              f"{int(geo.poly.n[g])} poses): {RC_B} points ({ends[0]} before the start, "
              f"{ends[1]} past the end), pose indices equal, CUDA against the CPU "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" of magnitude ({card})")


def route_cols(state, slot: int) -> dict:
    return {f: getattr(state.vehicles, f)[:, slot].cpu()
            for f in ("route_base", "route_n", "route_id", "route_ptr", "route_len")}


def check_route_choice(ht, ss, sf, gf, kernels, card: str) -> None:
    """``set_route_at_intersection`` on a CUDA intersection-v0 batch of RC_B
    rows for every option of RC_ROUTE_OPTIONS (``"random"`` from a CPU
    generator of one seed on both sides): the route arrays equal those of
    the same call on its CPU copy.  Then RC_STEPS eager ``step_batched``
    steps of the rerouted batch through K5, the counts set to 0 just before
    and read just after (K5 once a step, nothing else), the first
    RC_PLAIN_STEPS against the same steps with every kernel stood in for
    by its plain version, bit-exact; and a ``MultipleModelTracker`` on row 0
    over the RC_STEPS states, against one over their CPU copies: route,
    hypotheses and data equal.  Prints the host ms of a rerouting and of
    the tracker's ``act``."""
    from highwayenv_tpu_torch.envs import preprocessors
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.ops import uncertainty as unc
    from highwayenv_tpu_torch.vehicle.state import KIND_IDM

    env = ht.make("intersection-v0")
    gen = env.generator(SEED + 44)
    _, st = env.reset(RC_B, gen)
    cpu_st = map_fields(lambda x: x.cpu(), st)
    ego = env.ego_slots[0]
    for slot in (ego, 0):
        for to in RC_ROUTE_OPTIONS:
            g1 = torch.Generator().manual_seed(SEED + 45)
            g2 = torch.Generator().manual_seed(SEED + 45)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = preprocessors.set_route_at_intersection(env, st, slot, to, generator=g1)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            want = preprocessors.set_route_at_intersection(env, cpu_st, slot, to, generator=g2)
            got_c, want_c = route_cols(out, slot), route_cols(want, slot)
            bad = [f for f in got_c if not torch.equal(got_c[f], want_c[f])]
            if bad:
                raise AssertionError(f"set_route_at_intersection slot {slot} {to!r}: CUDA and "
                                     f"the CPU differ in {bad}")
            moved = int((got_c["route_base"] != route_cols(st, slot)["route_base"]).any(-1).sum())
            print(f"  set_route_at_intersection(slot {slot}, {to!r}) on CUDA, B={RC_B}: route "
                  f"arrays equal to the CPU copy's, {moved} rows rerouted, {host_ms:.1f} ms on "
                  f"the host ({card})")
    st = preprocessors.set_route_at_intersection(env, st, ego, "random",
                                                 generator=torch.Generator().manual_seed(SEED))
    acts = [random_actions(env, RC_B, env.generator(SEED + 46 + t)) for t in range(RC_STEPS)]
    veh = unc.host_row(st, 0)
    slot = int(np.nonzero((veh.kind == KIND_IDM) & (veh.route_len > 1))[0][0])
    route = unc.route_of_slot(env, st, slot, row=0)
    tracker = unc.MultipleModelTracker(env, slot, route=route, row=0)
    tracker_cpu = unc.MultipleModelTracker(env, slot, route=route, row=0)
    for k in kernels.values():
        k.launches = 0
    step_gen = env.generator(SEED + 47)
    states, act_ms = [st], []
    for t in range(RC_STEPS):
        st = env.step_batched(st, acts[t], step_gen)[1]
        states.append(st)
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    if counts != {"K5": RC_STEPS}:
        raise AssertionError(f"rerouted intersection-v0: launches {counts}, "
                             f"expected K5 {RC_STEPS}")
    with PlainKernels(ss, sf, gf):
        pst = states[0]
        plain_gen = env.generator(SEED + 47)
        for t in range(RC_PLAIN_STEPS):
            pst = env.step_batched(pst, acts[t], plain_gen)[1]
            kern = state_tensors(states[t + 1])
            bad = [k for k, v in state_tensors(pst).items() if not torch.equal(v, kern[k])]
            if bad:
                raise AssertionError(f"rerouted intersection-v0 step {t}: K5 and the plain "
                                     f"path differ in {bad}")
    for t, s_ in enumerate(states[:RC_STEPS]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.act(s_)
        act_ms.append((time.perf_counter() - t0) * 1e3)
        tracker_cpu.act(map_fields(lambda x: x.cpu(), s_))
        same = tracker.route == tracker_cpu.route and len(tracker.data) == len(tracker_cpu.data)
        for (ra, da), (rb, db) in zip(tracker.data, tracker_cpu.data):
            same = same and ra == rb and da.keys() == db.keys() and all(
                da[k]["outputs"] == db[k]["outputs"]
                and all(np.array_equal(x, y) for x, y in zip(da[k]["features"],
                                                             db[k]["features"]))
                for k in da)
        if not same:
            raise AssertionError(f"MultipleModelTracker step {t}: CUDA states and their CPU "
                                 "copies give different hypotheses or data")
    ob, r, _ = tracker.assume_model_is_valid(states[-1], 0)
    print(f"  rerouted intersection-v0, B={RC_B}: K5 {counts['K5']} launches in {RC_STEPS} "
          f"steps, nothing else; {RC_PLAIN_STEPS} steps bit-exact against the plain path; "
          f"MultipleModelTracker on row 0 slot {slot}: {len(tracker.data)} hypotheses, "
          f"{sum(len(d['lateral']['features']) for _, d in tracker.data)} lateral samples, equal "
          f"on CUDA and on the CPU copies; act {sorted(act_ms)[len(act_ms) // 2]:.3f} ms median "
          f"on the host (min {min(act_ms):.3f}, first {act_ms[0]:.3f}); observer of hypothesis "
          f"0 on lane {ob.target_lane} ({card})")


def check_robust_control(ht, ss, sf, gf, kernels, card: str) -> None:
    """The robust-control block: observers, LPV, poly lanes, rerouting and
    the tracker on the card."""
    check_observer_batch(ht, card)
    check_lpv(card)
    check_poly_ops(card)
    check_route_choice(ht, ss, sf, gf, kernels, card)


SHARD_B = 4096  # rows of every sharded scene, over all its shards
SHARD_STEPS = 8  # policy steps of each sharded run
SHARD_RUNS = 3  # timed runs of each variant, in turns
SHARD_POOL = 64  # pooled_rollout_fn's bank
SHARD_COMPACT = 1024  # reset slots of the compact sharded run


def one_card_loop(env, states, gen, graph: bool = False, compact_reset=None):
    """The one-card ``rollout``'s loop (``PolicyStep``, built and captured
    here) on ``states``: a function that runs SHARD_STEPS steps and returns
    the per-step sums the sharded rollout keeps, (steps, 3) float64, and
    the step."""
    from highwayenv_tpu_torch.parallel import sharding
    from highwayenv_tpu_torch.parallel.rollout import PolicyStep

    step = PolicyStep(env, states, gen, compact_reset=compact_reset, graph=graph)

    def run():
        sums = []
        for _ in range(SHARD_STEPS):
            step.launch()
            obs, _, reward, term, trunc, _ = step.finish()
            sums.append(sharding._step_sums(reward, term | trunc, obs))
        return torch.stack(sums)

    return run, step


def shard_scene(sharding, mesh, env, label, kernels, graph=False, compact_reset=None,
                inputs=None):
    """One sharded run of SHARD_STEPS steps from a fresh reset of SHARD_B
    rows: each shard's states bit-exact against the one-card loop on the
    same rows from a clone of its generator, the metrics bit-exact against
    those of the one-card loops' sums; the counts set to 0 just before the
    run and read just after.  Returns the counts; a ``KernelInputs``
    (eager runs) logs the run's calls."""
    import contextlib

    from highwayenv_tpu_torch.envs.base import map_fields

    _, states = env.reset(SHARD_B, env.generator(SEED + 60))
    shards = sharding.shard_batch(states, mesh)
    gens = sharding.shard_generators(SEED + 61, mesh)
    refs = sharding.shard_generators(SEED + 61, mesh)
    rows = [map_fields(torch.clone, s) for s in shards]
    fn = sharding.sharded_rollout_fn(env, mesh, SHARD_STEPS, graph=graph,
                                     compact_reset=compact_reset)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    with inputs if inputs is not None else contextlib.nullcontext():
        out, metrics = fn(shards, gens)
        torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    envs = sharding.shard_envs(env, mesh)
    sums = []
    for i in range(mesh.local_shards):
        run, step = one_card_loop(envs[i], rows[i], refs[i], compact_reset=compact_reset)
        sums.append(run())
        want, got = state_tensors(step.states), state_tensors(out[i])
        bad = [k for k, v in want.items() if not torch.equal(v, got[k])]
        if bad:
            raise AssertionError(f"{label} shard {i}: differs from the one-card loop in {bad}")
        if not torch.equal(gens[i].get_state(), refs[i].get_state()):
            raise AssertionError(f"{label} shard {i}: the generators differ")
    want = sharding._global_metrics(sharding.Mesh(mesh.devices), sums, SHARD_B)
    bad = [k for k in want if not torch.equal(want[k].to(metrics[k].device), metrics[k])]
    if bad:
        raise AssertionError(f"{label}: metrics {bad} differ from the one-card loops'")
    print(f"  {label}: {mesh.local_shards} shard(s) of {SHARD_B // mesh.local_shards} rows, "
          f"{SHARD_STEPS} steps: every shard's state bit-exact against the one-card loop on "
          f"its rows and generator, metrics bit-exact ({', '.join(f'{k} {float(v):.6f}' for k, v in metrics.items())}); "
          f"launches {counts}")
    return counts


def path_rows(inputs, env, label, sfx, what, rows, err, launches) -> None:
    """The kernel rows "<row> <sfx>" of a sharded path: its own launches,
    read from its own zeroed run (``inputs``' log), and each kernel's error
    against its plain version on the inputs the run gave it; its times and
    bound are those of the main path's row of the kernel (the same kernel
    timed on the main path's scene), as the Grayscale rows'."""
    errs = inputs.check(env, label)
    for row, n in inputs.launches(env).items():
        main = rows[row]
        rows[f"{row} {sfx}"] = (f"{main[0]} ({what}; timed on the main path's scene)",
                                ) + main[1:]
        launches[f"{row} {sfx}"] = n
        err[f"{row} {sfx}"] = errs[row]
    print(f"  {label}: its kernels bit-exact against their plain versions on the inputs the "
          f"run gave them; rows {sorted(f'{r} {sfx}' for r in errs)}")


def timed_turns(label, variants, card) -> None:
    """ms per step of each of ``variants`` ({name: run}), SHARD_RUNS runs of
    SHARD_STEPS steps each, in turns (the order reversed every other
    round), after one untimed run each."""
    for run in variants.values():
        run()
    torch.cuda.synchronize()
    ms = {name: [] for name in variants}
    for r in range(SHARD_RUNS):
        for name in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
            t0 = time.perf_counter()
            variants[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / SHARD_STEPS * 1e3)
    for name, ws in ms.items():
        print(f"  {label} {name}: " + ", ".join(f"{w:.4f}" for w in ws)
              + f" ms per step ({SHARD_B * 1e3 / sorted(ws)[1]:.1f} env-steps/s at the "
              f"median; {card})")


def sharded_runner(sharding, mesh, env, graph=False):
    """A function that runs SHARD_STEPS sharded steps from a fresh reset of
    SHARD_B rows, carrying its shards (and, with ``graph``, its captured
    steps) from call to call."""
    _, states = env.reset(SHARD_B, env.generator(SEED + 62))
    fn = sharding.sharded_rollout_fn(env, mesh, SHARD_STEPS, graph=graph)
    box = [sharding.shard_batch(states, mesh), sharding.shard_generators(SEED + 63, mesh)]

    def run():
        box[0] = fn(box[0], box[1])[0]

    return run


def check_sharding(ht, ss, sf, gf, kernels, rows, err, launches, card: str) -> None:
    """The multi-device layer on the one card: (a) ``make_mesh()`` under an
    NCCL group of world size 1 and ``sharded_rollout_fn`` at highway-v0,
    eager, captured and compact; (b) two shards on the one card at
    highway-v0 and intersection-v0, eager and captured; (c)
    ``pooled_rollout_fn`` at intersection-v0.  Each shard bit-exact against
    the one-card loop, the launch counts as stated, ms per step against one
    card in turns.  The eager full runs of (a), (b) and (c) get kernel rows
    of their own (``path_rows``): the main path's rows keep the main
    path's counts."""
    import torch.distributed as dist

    from highwayenv_tpu_torch.parallel import sharding
    from highwayenv_tpu_torch.tools.multiproc_rollout import free_port

    straight = ("K1", "K2a", "K3", "K2b")
    inputs = KernelInputs(ss, sf, gf)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    init_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        mesh = sharding.make_mesh()  # its check of the device counts: the first NCCL call
        first_s = time.perf_counter() - t0
        if not mesh.distributed or mesh.world_size != 1:
            raise AssertionError(f"make_mesh under a group of one: {mesh}")
        print(f"  NCCL group of world size 1: init_process_group {init_s:.3f} s, make_mesh "
              f"(the first all_gather) {first_s:.3f} s; mesh {[str(d) for d in mesh.devices]}")
        henv = ht.make("highway-v0")
        # (a) one shard a card under NCCL
        n = SHARD_STEPS * mesh.local_shards
        for graph, compact in ((False, None), (True, None), (False, SHARD_COMPACT)):
            label = (f"(a) highway-v0 {'graph' if graph else 'eager'}"
                     + (f" compact P={compact}" if compact else ""))
            full = not graph and compact is None
            counts = shard_scene(sharding, mesh, henv, label, kernels, graph, compact,
                                 inputs if full else None)
            want = {k: 2 * mesh.local_shards if graph else n for k in straight}
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, expected {want}")
            if full:
                path_rows(inputs, henv, label, "sharded", "sharded_rollout_fn, one shard "
                          "under NCCL", rows, err, launches)
        timed_turns("(a) highway-v0", {
            "sharded eager": sharded_runner(sharding, mesh, henv),
            "one card eager": one_card_loop(henv, henv.reset(SHARD_B, henv.generator(SEED))[1],
                                            henv.generator(SEED))[0],
            "sharded graph": sharded_runner(sharding, mesh, henv, graph=True),
            "one card graph": one_card_loop(henv, henv.reset(SHARD_B, henv.generator(SEED))[1],
                                            henv.generator(SEED), graph=True)[0],
        }, card)
        # (b) two shards on the one card
        two = sharding.make_mesh([mesh.devices[0]] * 2)
        ienv = ht.make("intersection-v0")
        for env_id, env in (("highway-v0", henv), ("intersection-v0", ienv)):
            for graph in (False, True):
                label = f"(b) {env_id} {'graph' if graph else 'eager'}"
                counts = shard_scene(sharding, two, env, label, kernels, graph,
                                     inputs=None if graph else inputs)
                per = 2 if graph else SHARD_STEPS  # a capture counts its warm-up and itself
                want = ({k: 2 * per for k in straight} if env is henv
                        else {"K5": 2 * 2 * per})
                if counts != want:
                    raise AssertionError(f"{label}: launches {counts}, expected {want}")
                if not graph:
                    split = inputs.launches(env)
                    if env.regulated and split != {"K5 step": 2 * per, "K5 warm-up": 2 * per}:
                        raise AssertionError(f"{label}: K5 calls {split}, expected a step "
                                             "and a warm-up a step on each shard")
                    path_rows(inputs, env, label, "two shards",
                              f"sharded_rollout_fn, two shards of {SHARD_B // 2} rows on the "
                              "card", rows, err, launches)
            timed_turns(f"(b) {env_id}", {
                "two shards eager": sharded_runner(sharding, two, env),
                "one card eager": one_card_loop(env, env.reset(SHARD_B, env.generator(SEED))[1],
                                                env.generator(SEED))[0],
                "two shards graph": sharded_runner(sharding, two, env, graph=True),
                "one card graph": one_card_loop(env, env.reset(SHARD_B, env.generator(SEED))[1],
                                                env.generator(SEED), graph=True)[0],
            }, card)
        # (c) the pooled rollout at intersection-v0
        roll, init_pool = sharding.pooled_rollout_fn(ienv, mesh, SHARD_STEPS,
                                                     pool_size=SHARD_POOL)
        pool = init_pool(SEED + 64)
        _, states = ienv.reset(SHARD_B, ienv.generator(SEED + 65))
        shards = sharding.shard_batch(crashed_every(ienv, states), mesh)
        gens = sharding.shard_generators(SEED + 66, mesh)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        with inputs:
            shards, pool, metrics = roll(shards, pool, gens)
            torch.cuda.synchronize()
        counts = {n_: k.launches for n_, k in kernels.items() if k.launches}
        calls = [(frames, n_rows) for _, n_rows, frames in inputs.log]
        steps_ = [c for c in calls if c == (ienv.frames_per_step, SHARD_B // mesh.local_shards)]
        warm = [c for c in calls if c == (ienv._warmup_frames, 1)]
        want_n = SHARD_STEPS * mesh.local_shards
        if counts != {"K5": 2 * want_n} or len(steps_) != want_n or len(warm) != want_n:
            raise AssertionError(f"(c) pooled intersection-v0: launches {counts}, calls "
                                 f"(frames, rows) {calls}; expected K5 once a step and a "
                                 "one-row warm-up a step, each shard")
        finite = all(math.isfinite(float(v)) for v in metrics.values())
        got = sharding.gather_batch(shards, mesh)
        # a row drawn from the bank during the run restarted its clock
        restarted = int((got.time < SHARD_STEPS / ienv.config["policy_frequency"]).sum())
        if not finite or restarted < SHARD_B // CRASH_EVERY:
            raise AssertionError(f"(c) pooled intersection-v0: metrics {metrics}, "
                                 f"{restarted} rows restarted")
        path_rows(inputs, ienv, "(c) pooled intersection-v0", "pooled",
                  f"pooled_rollout_fn, bank {SHARD_POOL}, one-row warm-ups", rows, err,
                  launches)
        print(f"  (c) pooled intersection-v0, B={SHARD_B}, bank {SHARD_POOL}, {SHARD_STEPS} "
              f"steps: K5 {len(steps_)} step launches and {len(warm)} one-row warm-ups, nothing "
              f"else; {restarted} rows drawn from the bank during the run; metrics "
              + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()))

        def pooled():
            box[0], box[1] = roll(box[0], box[1], gens)[:2]

        box = [shards, pool]
        timed_turns("(c) intersection-v0", {
            "pooled": pooled,
            "full autoreset": one_card_loop(ienv, ienv.reset(SHARD_B, ienv.generator(SEED))[1],
                                            ienv.generator(SEED))[0],
        }, card)
    finally:
        dist.destroy_process_group()


#: scenes over the narrow kernels' limits, each (row, env id,
#: config): the wide K5 (intersection-v0 with duration 30, V=42, and its
#: connected and dynamical ids), the wide K4 (exit-v0 at highway-v0's
#: density, V=51; racetrack-v0 with 40 NPCs, V=41, raw controls) and the
#: narrow K4 on 48 lanes (racetrack-oval-v0 with 6 lanes, V=2); each held
#: to its plain version, driven with the counts set to 0 and timed, with a
#: kernel row of its own
WIDE_ROWS = (
    ("K5 wide step", "intersection-v0", {"duration": 30}),
    ("K5 wide connected", "intersection-v2", {"duration": 30}),
    ("K5 wide dynamical", "intersection-v1", {"duration": 30}),
    ("K4 wide", "exit-v0", {"vehicles_count": 50}),
    ("K4 wide raw", "racetrack-v0", {"other_vehicles": 40}),
    ("K4 raw 48 lanes", "racetrack-oval-v0", {"no_lanes": 6}),
)
#: the wide instantiations no row reaches, held to their plain versions:
#: the connected K4 (exit-v1, V=51) and the dynamical K4 (racetrack-v0
#: with 40 NPCs under a dynamical ContinuousAction); and the wide K5 at
#: its 128 slots (intersection-v0 with duration 116: 61.0 KB of shared
#: memory a block, over the 48 KB default, the function attribute's path)
WIDE_CHECKED = (
    ("K4 wide connected", "exit-v1", {"vehicles_count": 50}),
    ("K4 wide dynamical", "racetrack-v0", {"other_vehicles": 40, "action": {
        "type": "ContinuousAction", "dynamical": True}}),
    ("K5 wide 128 slots", "intersection-v0", {"duration": 116}),
)
WIDE_HORIZON = 8  # policy steps of each wide path's zeroed rollout
#: rows of the wide scenes' checks (cut from B for the time limit)
WIDE_CHECK_ROWS = 256


def layout_kernels(gf, layout: str) -> dict:
    """The eight wrappers of one library's layout ("wide", "cluster",
    "global", or "" the narrow one), keyed "K4 wide", "K5 wide connected",
    ..., "K4 wide connected dynamical" ("K4", "K5 connected", ... for the
    narrow), as the rows name them."""
    return {" ".join(filter(None, (road, layout))) + law:
            getattr(gf, f"frames_{kind}{sfx}{'_' * bool(layout)}{layout}_kernel")
            for road, kind in (("K4", "general"), ("K5", "regulated"))
            for law, sfx in (("", ""), (" connected", "_connected"),
                             (" dynamical", "_dynamical"),
                             (" connected dynamical", "_connected_dynamical"))}


def wide_scenes(env, states, gen) -> dict:
    """A wide scene's frame calls, {name: (vehicles, steps0 or None, slot
    actions or None, frames, raw)}: on a regulated road ``regulated_scenes``
    (8 steps in with the tick phases spread, the conflict scene, the
    warm-up), else ``general_scenes`` (8 steps in, the all-env pile-up);
    raw controls stored on the egos first."""
    from highwayenv_tpu_torch.ops import general_frames as gf

    Bn = states.vehicles.kind.shape[0]
    if env.regulated:
        calls = regulated_scenes(env, states, gen)
    else:
        calls = {name: (veh, None, env._action_to_slots(random_actions(env, Bn, gen)),
                        env.frames_per_step)
                 for name, veh in general_scenes(env, states, gen).items()}
    out = {}
    for name, (veh, steps0, sa, frames) in calls.items():
        veh, sa, raw = gf.store_raw_controls(env, veh, sa)
        out[name] = (veh, steps0, sa, frames, raw)
    return out


def frame_call(gf, env, veh, steps0, sa, frames, raw, chunk=None):
    """(kernel call, plain call) of one frame launch of ``env``: the
    instantiation ``frames_kernel_for`` picks for its slots; with ``chunk``
    the plain frames run over the rows in chunks of that many rows (the
    pair tensors of a large scene), their states concatenated."""
    spec = env._general
    kernel = gf.frames_kernel_for(spec, env.regulated, veh.kind.shape[1])
    args = (veh, spec, sa, frames) + ((steps0,) if env.regulated else ())

    def run():
        return kernel(*args, raw=raw, linear=env.linear_rows)

    def plain():
        if chunk is None:
            return gf.frames_general_plain(*args, raw=raw)
        return chunked(lambda *a: gf.frames_general_plain(*a, raw=raw), args, chunk)

    return kernel, run, plain


def check_wide(ht, gf, kernels, rows, err, launches, card: str, start: float) -> None:
    """The scenes over the narrow kernels' limits: each of WIDE_ROWS
    and WIDE_CHECKED made on CUDA at WIDE_CHECK_ROWS rows, its wide (or 48-lane) instantiation
    against its plain version on every scene of ``wide_scenes``, every field
    bit-exact; each of WIDE_ROWS driven WIDE_HORIZON steps with the counts
    set to 0 just before (its instantiation once a step; on a regulated road
    the narrow K5 once a step and once more for the reset's 16-slot warm-up,
    nothing else), its launch timed from a fresh reset (queued), held to the
    plain frames, their time and the bound, a row of its own (``frame_row``);
    then at
    intersection-v0 with duration 30 compact against full and captured
    against eager, and its captured and eager full step in turns."""
    every = {**kernels, **layout_kernels(gf, "wide")}
    envs = {}
    for key, env_id, config in WIDE_ROWS + WIDE_CHECKED:
        env = ht.make(env_id, config)
        gen = env.generator(SEED)
        _, states = env.reset(WIDE_CHECK_ROWS, gen)
        V = env.num_slots
        kernel = gf.frames_kernel_for(env._general, env.regulated, V)
        print(f"== 4. wide scenes: {key}, {env_id} {config}: V={V}, L={env.geo.num_lanes}, "
              f"R={states.vehicles.route_base.shape[-1]}, {group_size(V)} threads an env, "
              f"{kernel.source}.{kernel.entry}, B={WIDE_CHECK_ROWS} "
              f"[at {time.time() - start:.0f} s]")
        err[key] = 0.0
        for name, call in wide_scenes(env, states, gen).items():
            k, run, plain = frame_call(gf, env, *call)
            out_k = run()
            out_p = plain()
            torch.cuda.synchronize()
            e = compare_general(out_k, out_p, f"{env_id} {name} ({k.source}.{k.entry}, "
                                f"V={call[0].kind.shape[1]})")
            if k is kernel:
                err[key] = max(err[key], e)
            if name == "pile-up" and not bool(out_k.crashed.any()):
                raise AssertionError(f"{env_id}: the pile-up crashed nothing")
        envs[key] = (env, states)
    for key, env_id, config in WIDE_ROWS:
        env = envs[key][0]
        launches[key] = drive_path(gf, env, every, key, env_id, config, WIDE_HORIZON)
        frame_row(gf, env, key, env_id, config, rows, err, card, start)
    # intersection-v0 with duration 30: the compact and captured steps
    ienv = envs["K5 wide step"][0]
    _, ist = ienv.reset(B, ienv.generator(SEED + 3))
    label = "intersection-v0 duration 30 "
    check_compact(ienv, ist, label)
    check_graph(ienv, ist, label)
    # its captured and eager full steps, in turns (the default
    # intersection-v0's are phase 5's)
    walls = {}
    runs = [(f"duration 30 {mode}", ienv, mode == "graph") for mode in ("eager", "graph")]
    firsts = {name: e.reset(B, e.generator(SEED + 4))[1] for name, e, _ in runs}
    for r in range(3):
        for name, e, graph in (runs if r % 2 == 0 else runs[::-1]):
            walls.setdefault(name, []).append(
                timed_steps(e, firsts[name], e.generator(SEED + 5), TIMED_STEPS, None, graph))
    for name, e, graph in runs:
        busy, n_kernels = step_device_ms(e, firsts[name], e.generator(SEED + 5), None, graph)
        ws = walls[name]
        print(f"  intersection-v0 {name} full: " + ", ".join(f"{w:.4f}" for w in ws)
              + f" ms per step ({B * 1e3 / sorted(ws)[1]:.1f} env-steps/s at the median); "
              f"device busy {busy:.4f} ms per step, {n_kernels:.1f} device kernels per step "
              f"({card})")


#: scenes over the wide kernels' 128 slots (the cluster K4 / K5), each
#: (row key, env id, config, rows of the checks): the cluster K5 at
#: intersection-v0, -v2 and -v1 at policy_frequency 15 (V=207, one frame a
#: step, the simulator's decision rate), the cluster K4 at exit-v0 and
#: exit-v1 with 150 vehicles (V=151) and, dynamical, at racetrack-v0 with 150
#: NPCs (V=151); each held to its plain version, driven with the counts set
#: to 0 and timed, with a kernel row of its own.  The checks run at fewer
#: rows than B: the plain frames' (B, V, V[, 11]) pair tensors (and the
#: time limit)
CLUSTER_ROWS = (
    ("K5 cluster step", "intersection-v0", {"policy_frequency": 15}, 64),
    ("K5 cluster connected", "intersection-v2", {"policy_frequency": 15}, 64),
    ("K5 cluster dynamical", "intersection-v1", {"policy_frequency": 15}, 64),
    ("K4 cluster", "exit-v0", {"vehicles_count": 150}, 64),
    ("K4 cluster connected", "exit-v1", {"vehicles_count": 150}, 64),
    ("K4 cluster dynamical", "racetrack-v0", {"other_vehicles": 150, "action": {
        "type": "ContinuousAction", "dynamical": True}}, 64),
)
#: held only: K4's raw branch at racetrack-v0 with 150 NPCs, and the top of
#: the range, intersection-v0 with duration 60 (V=912, 8 blocks a cluster)
CLUSTER_CHECKED = (
    ("K4 cluster raw", "racetrack-v0", {"other_vehicles": 150}, 64),
    ("K5 cluster 912 slots", "intersection-v0", {"duration": 60, "policy_frequency": 15}, 8),
)
CLUSTER_HORIZON = 8  # policy steps of each cluster path's zeroed rollout
#: float32 elements of one (rows, V, V, 11) tensor of the plain right-of-way
#: pass that a plain call of a timed row may make at once (0.5 GB)
PLAIN_PAIR_ELEMENTS = 2**27
#: the wide K5 at its 128 slots, held bit-exact by check_wide, timed here,
#: its row at WIDE_128_ROWS rows (its plain frames took 13 s at B)
WIDE_128 = ("K5 wide 128 slots", "intersection-v0", {"duration": 116})
WIDE_128_ROWS = 1024


def rolled(veh, sa, shift: int):
    """``veh`` and its slot actions with every slot moved ``shift`` places up
    (mod V): the live vehicles, which the intersection keeps in its first
    slots, then straddle a cluster rank's boundary."""
    from highwayenv_tpu_torch.envs.base import map_fields

    veh = map_fields(lambda t: torch.roll(t, shift, dims=1), veh)
    return veh, None if sa is None else torch.roll(sa, shift, dims=1)


def tied(veh, n: int = 23, every_rank: bool = False):
    """``veh`` with slots 1 .. n copied whole into slots 128 .. 127 + n: each
    copied vehicle meets its twin at the same s on the same lane across the
    cluster's first rank boundary (the front neighbour takes the later slot
    of a tie, the rear the earlier), and the twins collide (crash flags and
    impacts set across the boundary); with ``every_rank`` into the first n
    slots of every rank past the first, the copies meeting across every
    boundary."""
    from highwayenv_tpu_torch.envs.base import map_fields

    V = veh.kind.shape[1]
    starts = range(128, V, 128) if every_rank else (128,)

    def copy(t):
        t = t.clone()
        for lo in starts:
            m = min(n, V - lo)
            t[:, lo:lo + m] = t[:, 1:1 + m]
        return t

    return map_fields(copy, veh)


def row_slice(x, lo: int, rows: int):
    """Rows ``lo`` .. ``lo + rows`` of a state or tensor; None and specs
    and numbers as they are."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.vehicle.state import VehicleState

    if isinstance(x, VehicleState):
        return map_fields(lambda t: t[lo:lo + rows], x)
    return x[lo:lo + rows] if isinstance(x, torch.Tensor) else x


def chunked(fn, args, rows: int):
    """``fn(*args)`` over the batch in chunks of ``rows`` rows (``args``
    sliced by ``row_slice``), the output states concatenated."""
    from highwayenv_tpu_torch.envs.base import map_fields

    n = args[0].kind.shape[0]
    outs = [fn(*[row_slice(a, lo, rows) for a in args]) for lo in range(0, n, rows)]
    return map_fields(lambda *ts: torch.cat(ts), *outs)


def plain_work(gf, env, veh, sa, steps0, rows: int):
    """(plain ms, float32 operations, bytes, the plain frames' state) of one
    frame launch from ``veh`` over the batch: the plain frames once, in
    chunks of ``rows`` rows, frame by frame as ``frames_general_plain`` runs
    them, between CUDA events (the host's gaps included), each frame's
    inputs and outputs kept; then the operations counted on those
    (``gen_frame_ops``, and ``reg_tick_ops`` where an env ticks, as
    k4_work / k5_work count them) and the bytes of k4_work / k5_work over
    the batch, the tables once."""
    from highwayenv_tpu_torch.envs.base import map_fields
    from highwayenv_tpu_torch.road import lane as lane_ops

    spec, raw = env._general, sa is None
    kept, outs = [], []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for lo in range(0, veh.kind.shape[0], rows):
        v, a, s0 = (row_slice(x, lo, rows) for x in (veh, sa, steps0))
        phase = None if s0 is None else torch.remainder(s0.to(torch.int32), spec.period)
        table = lane_ops.projection_table(spec.geo, v.pos)
        for f in range(env.frames_per_step):
            tick = None if phase is None else torch.remainder(phase + (f + 1), spec.period) == 0
            out, next_table = gf.frame_general_plain(v, spec, table, a if f == 0 else None,
                                                     tick, raw=raw)
            kept.append((v, out, table, tick))
            v, table = out, next_table
        outs.append(v)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    ops = 0.0
    for v, out, table, tick in kept:
        ops += gen_frame_ops(v, out, spec, table, raw=raw)
        if tick is not None and bool(tick.any()):
            ops += reg_tick_ops(v, spec, tick)
    out = map_fields(lambda *ts: torch.cat(ts), *outs)
    R = veh.route_base.shape[-1]
    reg = gf.REG_FIELDS if env.regulated else []
    glob = gf.frames_kernel_for(spec, env.regulated, veh.kind.shape[1]).glob
    n_bytes = (read_bytes(veh, gf._resolve(gf._IN_FIELDS, R) + reg)
               + (0 if raw else sa.numel() * 4) + (veh.kind.shape[0] * 4 if reg else 0)
               + field_bytes(out, gf._resolve(gf.OUT_FIELDS, R) + reg)
               + table_bytes(gf, spec, raw, R, env.device, glob) + dyn_bytes(gf, spec, veh))
    return ms, ops, n_bytes, out


def check_cluster(ht, gf, kernels, rows, err, launches, card: str, start: float) -> None:
    """The scenes over the wide kernels' 128 slots: each of CLUSTER_ROWS and
    CLUSTER_CHECKED made on CUDA, its cluster instantiation against its plain
    version at the row count each names on every scene of ``wide_scenes``
    and on ``tied`` (twins across the first rank boundary) and, on a
    regulated road, on the 8-steps-in and conflict scenes ``rolled`` so
    that the live vehicles straddle a rank boundary, every field bit-exact;
    each of CLUSTER_ROWS driven CLUSTER_HORIZON steps at B with the counts
    set to 0 just before (its cluster instantiation once a step; on a
    regulated road the narrow K5 once a step and once more for the reset's
    16-slot warm-up, nothing else), its launch timed at B from a fresh reset
    (queued), held to its plain version over the same B rows in chunks,
    their time and the bound, a row of its own (``frame_row``); then at
    intersection-v1 with policy_frequency 15 compact against full and
    captured against eager; and the wide K5 at 128 slots driven and timed
    (WIDE_128), a row of its own."""
    every = {**kernels, **layout_kernels(gf, "wide"), **layout_kernels(gf, "cluster")}
    envs = {}
    for key, env_id, config, n_check in CLUSTER_ROWS + CLUSTER_CHECKED:
        env = ht.make(env_id, config)
        if not gf.frames_kernel_for(env._general, env.regulated, env.num_slots).cluster:
            raise AssertionError(f"{env_id} {config}: V={env.num_slots} is not a cluster scene")
        hold_scenes(gf, env, key, env_id, config, n_check, err, start)
        envs[key] = env
    for key, env_id, config, _ in CLUSTER_ROWS:
        env = envs[key]
        launches[key] = drive_path(gf, env, every, key, env_id, config, CLUSTER_HORIZON)
        frame_row(gf, env, key, env_id, config, rows, err, card, start)
    # intersection-v1 at the simulator's decision rate: compact and captured
    ienv = envs["K5 cluster dynamical"]
    _, ist = ienv.reset(B, ienv.generator(SEED + 3))
    label = "intersection-v1 policy_frequency 15 "
    check_compact(ienv, ist, label)
    check_graph(ienv, ist, label, variants=[(None, False), (COMPACT_SLOTS[0], False)])
    key, env_id, config = WIDE_128
    env = ht.make(env_id, config)
    launches[key] = drive_path(gf, env, every, key, env_id, config, CLUSTER_HORIZON)
    frame_row(gf, env, key, env_id, config, rows, err, card, start, batch=WIDE_128_ROWS)


def layout_text(gf, kernel, env) -> str:
    """How ``kernel`` (``frames_kernel_for`` of ``env``) maps an env: the
    threads of a narrow or wide env, a cluster's blocks, or the global
    layout's blocks, their threads and the slab's bytes an env."""
    V = env.num_slots
    if kernel.glob:
        G = gf.global_threads(V)
        words = gf.global_words(env.geo.num_lanes, V, env.route_slots, env.regulated)
        n = -(-V // G)
        return (f"{n} block{'s' * (n > 1)} of {G} threads an env, a slab of {4 * words} bytes "
                "an env")
    if kernel.cluster:
        return f"{-(-V // 128)} blocks an env"
    return f"{group_size(V)} threads an env"


def hold_scenes(gf, env, key: str, env_id: str, config, n_check: int, err,
                start: float) -> None:
    """``env``'s instantiation (``frames_kernel_for``) against its plain
    version at ``n_check`` rows, every field bit-exact, on every scene of
    ``wide_scenes`` and, over 128 slots, on the regulated 8-steps-in and
    conflict scenes rolled so that the live vehicles straddle a rank (a
    cluster's block, the global layout's chunk of 128 slots) boundary and on
    ``tied`` (twins across the first rank boundary, across every one over 8
    ranks); the plain frames in chunks of ``plain_rows``.  Records the
    largest error in ``err[key]``."""
    gen = env.generator(SEED)
    _, states = env.reset(n_check, gen)
    V = env.num_slots
    kernel = gf.frames_kernel_for(env._general, env.regulated, V)
    print(f"== 4. {key}, {env_id} {config}: V={V}, L={env.geo.num_lanes}, "
          f"R={states.vehicles.route_base.shape[-1]}, {layout_text(gf, kernel, env)}, "
          f"{kernel.source}.{kernel.entry}, B={n_check} [at {time.time() - start:.0f} s]")
    calls = wide_scenes(env, states, gen)
    if kernel.cluster or (kernel.glob and V > 128):
        for name in ("8 steps in", "conflict") if env.regulated else ():
            veh, steps0, sa, frames, raw = calls[name]
            shift = 100 if V < 256 else V - 32
            veh, sa = rolled(veh, sa, shift)
            calls[f"{name}, rolled {shift}"] = (veh, steps0, sa, frames, raw)
        veh, steps0, sa, frames, raw = calls["reset"]
        calls["tied"] = (tied(veh, every_rank=V > 1024), steps0, sa, frames, raw)
    err[key] = 0.0
    for name, call in calls.items():
        k, run, plain = frame_call(gf, env, *call, chunk=plain_rows(call[0].kind.shape[1]))
        out_k = run()
        out_p = plain()
        torch.cuda.synchronize()
        e = compare_general(out_k, out_p, f"{env_id} {name} ({k.source}.{k.entry}, "
                            f"V={call[0].kind.shape[1]})")
        if k is kernel:
            err[key] = max(err[key], e)
        if name in ("pile-up", "tied") and not bool(out_k.crashed.any()):
            raise AssertionError(f"{env_id}: the {name} scene crashed nothing")


def drive_path(gf, env, kernels, key: str, env_id: str, config, steps: int,
               batch: int = B) -> int:
    """``env``'s path with the counts of ``kernels`` set to 0 just before:
    a reset of ``batch`` rows (B unless said) and ``steps`` random-policy
    autoreset steps; its frame instantiation launches once a step and, on a
    regulated road, the narrow K5 of the same law once a step and once more
    for the reset's 16-slot warm-up (on a narrow scene the same wrapper: 2
    steps + 1), nothing else.  Returns the instantiation's launches."""
    kernel = gf.frames_kernel_for(env._general, env.regulated, env.num_slots)
    label = [n for n, k in kernels.items() if k is kernel][0]
    gen = env.generator(SEED + 1)
    for k in kernels.values():
        k.launches = 0
    _, st = env.reset(batch, gen)
    st, m = rollout(env, st, steps, gen)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    want = {label: steps}
    if env.regulated:  # the reset batch's 16-slot warm-up, every step and the first
        narrow = label.replace(" wide", "").replace(" cluster", "").replace(" global", "")
        want[narrow] = want.get(narrow, 0) + steps + 1
    m = {k: float(v) for k, v in m.items()}
    print(f"  {key} path, {env_id} {config}: reset and {steps} autoreset steps, B={batch}, "
          f"launches {counts}; rollout {m}")
    if counts != want:
        raise AssertionError(f"{env_id} {config}: launches {counts}, expected {want}")
    if not all(np.isfinite(list(m.values()))):
        raise AssertionError(f"{env_id} {config}: non-finite metrics")
    for k in ("pos", "speed", "heading"):
        if not bool(torch.isfinite(getattr(st.vehicles, k)).all()):
            raise AssertionError(f"{env_id} {config}: non-finite {k}")
    return counts[label]


def plain_rows(V: int) -> int:
    """Rows of a chunk of the plain frames at V slots: the largest power of
    two, up to B, whose (rows, V, V, 11) tensors hold PLAIN_PAIR_ELEMENTS."""
    return min(B, 2 ** int(math.log2(max(1, PLAIN_PAIR_ELEMENTS // (11 * V * V)))))


def row_inputs(gf, env, batch: int):
    """(vehicles, steps0 or None, slot actions or None, raw) of a timed
    frame launch at ``batch`` rows: a fresh reset, the tick phases spread,
    random actions, raw controls stored on the egos."""
    _, s0 = env.reset(batch, env.generator(SEED + 2))
    steps0 = None
    if env.regulated:
        steps0 = s0.steps + torch.arange(batch, device=env.device, dtype=torch.int32) * 15
    sa = env._action_to_slots(random_actions(env, batch, env.generator(SEED + 2)))
    veh, sa, raw = gf.store_raw_controls(env, s0.vehicles, sa)
    return veh, steps0, sa, raw


def frame_row(gf, env, key: str, env_id: str, config, rows, err, card: str,
              start: float, batch: int = B) -> None:
    """A kernel row for ``env``'s frame launch at ``batch`` rows (B unless
    said): its time queued from a fresh reset (the tick phases spread,
    random actions); the plain frames over the same rows once, in chunks of
    ``plain_rows`` rows (``plain_work``): their time, CUDA events around
    them, the host's gaps between their kernels included (the profiler's
    device sum, which leaves them out, took about two minutes to gather at
    the 128-slot scene), the operations counted on their frames (the
    bound), the launch's output held bit-exact to theirs."""
    veh, steps0, sa, raw = row_inputs(gf, env, batch)
    chunk = plain_rows(env.num_slots)
    kernel, run, _ = frame_call(gf, env, veh, steps0, sa, env.frames_per_step, raw)
    out_k = run()
    plain_ms, ops, n_bytes, out_p = plain_work(gf, env, veh, sa, steps0, chunk)
    err[key] = max(err.get(key, 0.0), compare_general(out_k, out_p, f"{key} timed inputs"))
    ms = queued_ms(run, 10)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    V = env.num_slots
    sized = gf.scene_tables(env._general, env.route_slots, raw, kernel.glob)[2]
    rows[key] = (f"{kernel.entry} ({env_id} {json.dumps(config)}, V={V}, "
                 f"L={env.geo.num_lanes}, {layout_text(gf, kernel, env)}"
                 + (", raw controls" if raw else "")
                 + (", kSized" if sized else "") + ("" if batch == B else f", B={batch}") + ")",
                 f"highwayenv_tpu_torch/csrc/{kernel.source}"
                 f"{'_sized' * (sized and not kernel.glob)}.cu",
                 "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by, None)
    print(f"  {key}: {ms:.4f} ms queued at B={batch}; plain {plain_ms:.4f} ms (CUDA events, chunks "
          f"of {chunk} rows); bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} "
          f"ms, {n_bytes} bytes -> {t_bytes:.5f} ms) ({card}) [at {time.time() - start:.0f} s]")


#: a dynamical ContinuousAction: the ego on the tire-slip model
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}
#: a dynamical action under the connected-lane search: the connected
#: dynamical instantiations, each (row key, env id, config, rows of the
#: checks): the narrow K4 (racetrack-v1, V=2, raw controls) and K5
#: (intersection-v2, V=25, and the warm-up of its resets), the wide K4 / K5
#: (exit-v1 with 50 vehicles, V=51; intersection-v2 with duration 30, V=42)
#: and the cluster K4 / K5 (exit-v1 with 150 vehicles, V=151;
#: intersection-v2 at policy_frequency 15, V=207); each held to its plain
#: version, driven with the counts set to 0 and timed at B, with a kernel
#: row of its own
CONN_DYN_ROWS = (
    ("K4 connected dynamical", "racetrack-v1", DYNAMICAL, 256),
    ("K5 connected dynamical", "intersection-v2", DYNAMICAL, 256),
    ("K4 wide connected dynamical", "exit-v1", {"vehicles_count": 50, **DYNAMICAL}, 256),
    ("K5 wide connected dynamical", "intersection-v2", {"duration": 30, **DYNAMICAL}, 256),
    ("K4 cluster connected dynamical", "exit-v1", {"vehicles_count": 150, **DYNAMICAL}, 64),
    ("K5 cluster connected dynamical", "intersection-v2",
     {"policy_frequency": 15, **DYNAMICAL}, 64),
)
#: held only: the narrow K4 at exit-v1 (V=21, the 32-thread group)
CONN_DYN_CHECKED = (("K4 connected dynamical exit-v1", "exit-v1", DYNAMICAL, 256),)
#: the slice's path at full width: the narrow K5 and K4 of the connected
#: dynamical law, driven HORIZON steps eager and captured (phase 4)
CONN_DYN_PATHS = ("intersection-v2", "racetrack-v1")
#: scenes over 1024 slots, clusters of 9 to 16 blocks (the non-portable
#: cluster size), each (row key, env id, config, rows of the checks, rows of
#: the kernel row): the regulated K5 at intersection-v0 at policy_frequency
#: 15 with duration 80 (V=1212, 10 blocks), K4 at exit-v0 with 2047 vehicles
#: (V=2048, 16 blocks) and the connected dynamical K5 at intersection-v2 at
#: the same settings (V=1212); each held to its plain version at 8 rows,
#: driven LARGE_HORIZON steps with the counts set to 0 at B and timed at B; its kernel row at
#: fewer rows than B: the plain frames over the row's rows give its bound
#: and plain time, and at B they would take minutes (29 s at V=2048 over
#: 256 rows, 9 s at V=1212 over 512, on the H100)
LARGE_ROWS = (
    ("K5 cluster 1212 slots", "intersection-v0", {"policy_frequency": 15, "duration": 80},
     8, 32),
    ("K4 cluster 2048 slots", "exit-v0", {"vehicles_count": 2047}, 8, 16),
    ("K5 cluster connected dynamical 1212 slots", "intersection-v2",
     {"policy_frequency": 15, "duration": 80, **DYNAMICAL}, 8, 32),
)
LARGE_HORIZON = 2  # policy steps of each large scene's zeroed rollout at B


def check_connected_dynamical(ht, gf, kernels, rows, err, launches, card: str,
                              start: float) -> None:
    """A dynamical action under the connected-lane search: each of
    CONN_DYN_ROWS and CONN_DYN_CHECKED made on CUDA, its connected dynamical
    instantiation held to its plain version (``hold_scenes``); at the
    slice's path (CONN_DYN_PATHS, driven eager and captured in phase 4) the
    captured step against the eager one bit-exact; the rows whose launches phase 4 did not count driven
    CLUSTER_HORIZON steps with the counts set to 0 (``drive_path``); a
    kernel row each (``frame_row``)."""
    every = {**kernels, **layout_kernels(gf, ""), **layout_kernels(gf, "wide"),
             **layout_kernels(gf, "cluster")}
    envs = {}
    for key, env_id, config, n_check in CONN_DYN_ROWS + CONN_DYN_CHECKED:
        env = ht.make(env_id, config)
        spec = env._general
        if not (spec.connected and spec.dynamical):
            raise AssertionError(f"{env_id} {config}: not a connected dynamical spec")
        hold_scenes(gf, env, key, env_id, config, n_check, err, start)
        envs[key] = env
    for env_id in CONN_DYN_PATHS:
        env = envs[f"{'K5' if env_id.startswith('intersection') else 'K4'} connected dynamical"]
        _, gst = env.reset(B, env.generator(SEED + 3))
        check_graph(env, gst, f"{env_id} dynamical ", variants=[(None, False)])
        print(f"  [{env_id} dynamical at {time.time() - start:.0f} s]")
        # (its eager and captured ms per step are cut for the time limit;
        # PERF.md keeps their earlier numbers)
    for key, env_id, config, _ in CONN_DYN_ROWS:
        env = envs[key]
        if key not in launches:
            launches[key] = drive_path(gf, env, every, key, env_id, config, CLUSTER_HORIZON)
        frame_row(gf, env, key, env_id, config, rows, err, card, start)


def check_large_clusters(ht, gf, kernels, rows, err, launches, card: str,
                         start: float) -> None:
    """The scenes over 1024 slots (LARGE_ROWS), on clusters of 9 to 16
    blocks: each made on CUDA (a cluster the card cannot hold is the
    launch's own error), its cluster instantiation held to its plain
    version at 8 rows (``hold_scenes``:
    every scene, the rolled ones, twins across every rank boundary), driven
    LARGE_HORIZON steps at B with the counts set to 0 (``drive_path``),
    its launch timed queued at B from a fresh reset, and a kernel row at the
    row's own rows (``frame_row``)."""
    every = {**kernels, **layout_kernels(gf, ""), **layout_kernels(gf, "wide"),
             **layout_kernels(gf, "cluster")}
    for key, env_id, config, n_check, n_row in LARGE_ROWS:
        env = ht.make(env_id, config)
        spec, V = env._general, env.num_slots
        kernel = gf.frames_kernel_for(spec, env.regulated, V)
        ranks = -(-V // gf.WIDE_SLOTS)
        if not kernel.cluster or ranks <= 8:
            raise AssertionError(f"{env_id} {config}: V={V}, {ranks} blocks, {kernel.entry}")
        hold_scenes(gf, env, key, env_id, config, n_check, err, start)
        launches[key] = drive_path(gf, env, every, key, env_id, config, LARGE_HORIZON)
        torch.cuda.reset_peak_memory_stats()
        veh, steps0, sa, raw = row_inputs(gf, env, B)
        _, run, _ = frame_call(gf, env, veh, steps0, sa, env.frames_per_step, raw)
        ms_b = queued_ms(run, 3)
        print(f"  {key}: {ms_b:.4f} ms queued at B={B}; peak device memory of the reset batch "
              f"and the launches {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
        frame_row(gf, env, key, env_id, config, rows, err, card, start, batch=n_row)


#: exit-v0 with 100 lanes and 100 vehicles (L=302, V=101): its wide block
#: would ask 315,840 bytes of shared memory
WIDE_EXIT = {"lanes_count": 100, "vehicles_count": 100}
#: intersection-v0 at the simulator's decision rate for 140 s (V=2112)
LONG_INTERSECTION = {"policy_frequency": 15, "duration": 140}
#: the scenes that no layout of shared memory holds, on the global K4 / K5
#: (``csrc/general_frames_global.cu``: past a block's 227 KB, past 2048
#: slots), each (row key, env id, config, rows of the checks, rows of the
#: driven path and the timed launch, rows of the kernel row): each held to
#: its plain version (``hold_scenes``), driven GLOBAL_HORIZON steps with the
#: counts set to 0, its launch timed queued, a kernel row at the row's own
#: rows (the plain frames at V = 2112 to 8192 go as (rows, V, V), so a few
#: rows; the driven rows cut from B as the launches grow as V^2)
GLOBAL_ROWS = (
    ("K4 global 302 lanes", "exit-v0", WIDE_EXIT, 16, B, 256),
    ("K4 global 4096 slots", "exit-v0", {"vehicles_count": 4095}, 2, 256, 4),
    ("K4 global 8192 slots", "exit-v0", {"vehicles_count": 8191}, 1, 64, 1),
    ("K5 global", "intersection-v0", LONG_INTERSECTION, 2, 512, 8),
)
#: held only: every other entry of the global library (connected,
#: dynamical, both; K4 at exit-v1 / exit-v0 with 100 lanes, K5 at
#: intersection-v2 / -v1 for 140 s), its Linear branch (an
#: AggressiveVehicle and a DefensiveVehicle preset) and its poly lanes
#: (PolyExit with 100 lanes), each (row key, env id or custom_roads class
#: name, config, rows of the checks)
GLOBAL_CHECKED = (
    ("K4 global connected", "exit-v1", WIDE_EXIT, 16),
    ("K4 global dynamical", "exit-v0", {**WIDE_EXIT, **DYNAMICAL}, 16),
    ("K4 global connected dynamical", "exit-v1", {**WIDE_EXIT, **DYNAMICAL}, 16),
    ("K4 global linear", "exit-v0", {**WIDE_EXIT, **AGGRESSIVE_CONFIG}, 16),
    ("K4 global poly", "PolyExit", WIDE_EXIT, 16),
    ("K5 global connected", "intersection-v2", LONG_INTERSECTION, 2),
    ("K5 global dynamical", "intersection-v1", LONG_INTERSECTION, 2),
    ("K5 global connected dynamical", "intersection-v2", {**LONG_INTERSECTION, **DYNAMICAL}, 2),
    ("K5 global linear", "intersection-v0", {**LONG_INTERSECTION, **DEFENSIVE_CONFIG}, 2),
)
GLOBAL_HORIZON = 2  # policy steps of each global row's zeroed rollout
GLOBAL_GRAPH_STEPS = 2  # captured steps against eager at the 302-lane scene


def check_global(ht, gf, kernels, rows, err, launches, card: str, start: float) -> None:
    """The scenes that no layout of shared memory holds, on the global K4 /
    K5: each of GLOBAL_ROWS and GLOBAL_CHECKED made on CUDA and routed to
    its global wrapper (``frames_kernel_for``), the slab's words of every
    global wrapper held to the library's count (``general_global_words``)
    at its scene, its global instantiation held to its plain version
    (``hold_scenes``: every scene, the rolled ones, twins across every
    chunk boundary), every entry of the global library among them; each of
    GLOBAL_ROWS driven GLOBAL_HORIZON steps with the counts set to 0 at its
    driven rows (``drive_path``), its launch timed queued there with the
    peak device memory of the reset batch and the launches, and a kernel
    row at its own rows (``frame_row``); the 302-lane scene's captured step
    against the eager one (GLOBAL_GRAPH_STEPS steps at B)."""
    every = {**kernels, **{k: w for layout in ("", "wide", "cluster", "global")
                           for k, w in layout_kernels(gf, layout).items()}}
    globs = layout_kernels(gf, "global")
    held, envs = set(), {}
    for key, name, config, n_check, *_ in GLOBAL_ROWS + GLOBAL_CHECKED:
        env = custom_env(ht, name, config)
        V, L, R = env.num_slots, env.geo.num_lanes, env.route_slots
        kernel = gf.frames_kernel_for(env._general, env.regulated, V)
        if not kernel.glob:
            raise AssertionError(f"{name} {config}: V={V}, L={L}, {kernel.source}, not global")
        for k in globs.values():
            got, want = k.global_words(L, V, R), gf.global_words(L, V, R, k.regulated)
            if got != want:
                raise AssertionError(f"{k.entry} L={L} V={V} R={R}: {got} slab words at "
                                     f"launch, {want} in general_frames.global_words")
        print(f"  {key}: the slab's words of the 8 global entries at L={L}, V={V}, R={R} "
              f"equal the library's; {4 * gf.global_words(L, V, R, env.regulated)} bytes an env")
        hold_scenes(gf, env, key, name, config, n_check, err, start)
        held.add(kernel.entry)
        envs[key] = env
    missing = {k.entry for k in globs.values()} - held
    if missing:
        raise AssertionError(f"global entries held by no scene: {sorted(missing)}")
    for key, name, config, _, n_drive, n_row in GLOBAL_ROWS:
        env = envs[key]
        launches[key] = drive_path(gf, env, every, key, name, config, GLOBAL_HORIZON, n_drive)
        torch.cuda.reset_peak_memory_stats()
        veh, steps0, sa, raw = row_inputs(gf, env, n_drive)
        _, run, _ = frame_call(gf, env, veh, steps0, sa, env.frames_per_step, raw)
        ms = queued_ms(run, 3)
        print(f"  {key}: {ms:.4f} ms queued at B={n_drive}; slab "
              f"{4 * n_drive * gf.global_words(env.geo.num_lanes, env.num_slots, env.route_slots, env.regulated)} "
              f"bytes; peak device memory of the reset batch and the launches "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
        del veh, steps0, sa, run
        frame_row(gf, env, key, name, config, rows, err, card, start, batch=n_row)
    key, name, config = GLOBAL_ROWS[0][:3]
    captured_against_eager(envs[key], f"{name} {json.dumps(config)}", GLOBAL_GRAPH_STEPS)


#: the straight scenes one block cannot hold, on the global K1 and K3
#: (``csrc/straight_frames_global.cu``, ``straight_frames_sorted_global.cu``:
#: past 1024 slots, or past a block's 227 KB of shared memory) and on K2a and
#: K2b (``straight_sort.cu``, each thread looping over its slots), each (label, env id, config, rows of the checks,
#: scenes): every kernel held bit-exact to its plain version on each scene,
#: the Linear rows' and the raw instantiations among them
STRAIGHT_GLOBAL_SCENES = (
    ("2048 slots", "highway-v0", {"vehicles_count": 2047}, 4, SCENES + ("boundary",)),
    ("4096 slots", "highway-v0", {"vehicles_count": 4095}, 2, ("normal", "compressed",
                                                              "boundary")),
    ("8192 slots", "highway-v0", {"vehicles_count": 8191}, 1, ("normal", "compressed",
                                                              "boundary")),
    ("32 lanes", "highway-v0", {"lanes_count": 32, "vehicles_count": 1023}, 4,
     ("normal", "compressed", "boundary")),
    ("1025 slots", "highway-fast-v0", {"vehicles_count": 1024}, 4,
     ("normal", "compressed", "boundary")),
    ("4 egos", "highway-v0", {"controlled_vehicles": 4, "vehicles_count": 1200}, 4,
     ("normal", "compressed", "boundary")),
    ("linear", "highway-v0", {"vehicles_count": 2047, **LINEAR_CONFIG}, 4,
     ("normal", "pileup_all", "boundary")),
    ("raw", "highway-v0", {"vehicles_count": 2047, **CONTINUOUS_CONFIG}, 4,
     ("normal", "compressed", "boundary")),
)
#: the slice's paths, each driven with the counts set to 0 just before it
#: ((label, rows, policy steps)), and the scenes of the kernel rows ((label,
#: rows)); the plain frames go as (rows, V, V) pair tensors, so the rows
#: are few where V is large
STRAIGHT_GLOBAL_DRIVES = (("2048 slots", 4096, 3), ("8192 slots", 64, 2))
STRAIGHT_GLOBAL_ROWS = (("2048 slots", 16), ("8192 slots", 1))
#: captured steps against eager at the 2048-slot scene, and its rows
STRAIGHT_GRAPH_STEPS, STRAIGHT_GRAPH_ROWS = 2, 256


def boundary_pileup(veh, G: int):
    """A 20-vehicle pile-up in 6 m across every block boundary of the
    global layout (blocks of G threads): slots k G - 10 .. k G + 9 moved to
    the s of the env's rank k G - 10, so that the pile-up straddles the
    boundary in slot order (K1) and about there in rank order (K3)."""
    pos = veh.pos.clone()
    V = veh.kind.shape[1]
    ramp = torch.linspace(0, 6, 20, device=veh.pos.device)
    xs = torch.sort(veh.pos[..., 0], dim=1).values
    for k in range(G, V, G):
        lo, hi = max(k - 10, 0), min(k + 10, V)
        pos[:, lo:hi, 0] = xs[:, lo:lo + 1] + ramp[: hi - lo]
    return veh.replace(pos=pos)


def hold_straight(ss, sf, env, veh, where: str, err, key: str, every_env: bool = True):
    """K1 (every env; with ``every_env`` masked to every env; masked by the
    band flags over the banded rows), K2a, K3 and K2b on ``veh`` with the
    env's action applied, each bit-exact to its plain version (K3's flags
    equal), the errors kept under "K1" + ``key`` and "K3" + ``key``; the
    sorted step within the ulp bound of the dense one.  Returns (K3's
    flags, the sorted step, whether it equals the dense step bitwise).
    K1 and K3 in the scene's layout (``*_kernel_for``)."""
    from highwayenv_tpu_torch.envs.base import map_fields

    fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
    raw, linear = env.action_type.stores_raw_controls, env.linear_rows
    Bc, V = veh.kind.shape
    k1 = sf.frames_kernel_for(V, len(fs.offsets))
    k3 = ss.frames_sorted_kernel_for(V, len(fs.offsets))
    k2a, k2b = ss.sort_kernel, ss.unsort_kernel
    out_k = k1(veh, fs, p, dt, frames, raw=raw, linear=linear)
    out_p = sf.frames_plain(veh, fs, p, dt, frames, raw)
    torch.cuda.synchronize()
    err["K1" + key] = max(err["K1" + key], exact_state(out_k, out_p, f"{where} K1"))
    del out_p
    srt_k, idx_k = k2a(veh, fs)
    srt_p, idx_p = ss.sort_plain(veh, fs)
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p):
        raise AssertionError(f"{where} K2a: idx differs")
    exact(srt_k, srt_p, [n for n, _, _ in ss.SORT_FIELDS], f"{where} K2a")
    del srt_k, idx_k
    band_k, flags_k = k3(srt_p, idx_p, fs, p, dt, frames, raw=raw, linear=linear)
    band_p, flags_p = ss.frames_sorted_plain(srt_p, idx_p, fs, p, dt, frames, raw)
    torch.cuda.synchronize()
    if not torch.equal(flags_k, flags_p):
        raise AssertionError(f"{where} K3: flags differ")
    err["K3" + key] = max(err["K3" + key], exact_state(band_k, band_p, f"{where} K3"))
    back_k = k2b(band_p, idx_p, veh)
    back_p = ss.unsort_plain(band_p, idx_p, veh)
    torch.cuda.synchronize()
    exact(back_k, back_p, [n for n, _, _ in ss.MUT_FIELDS], f"{where} K2b")
    if every_env:
        every = torch.ones(Bc, dtype=torch.bool, device=veh.speed.device)
        all_k = k1(veh, fs, p, dt, frames, mask=every, out=map_fields(torch.clone, back_k),
                   raw=raw, linear=linear)
        all_p = sf._masked_plain(veh, fs, p, dt, frames, every, map_fields(torch.clone, back_p),
                                 raw)
        torch.cuda.synchronize()
        err["K1" + key] = max(err["K1" + key],
                              exact_state(all_k, all_p, f"{where} K1 masked to every env"))
        del all_k, all_p
    mask = flags_p.any(dim=1)
    fix_k = k1(veh, fs, p, dt, frames, mask=mask, out=back_k, raw=raw, linear=linear)
    fix_p = sf._masked_plain(veh, fs, p, dt, frames, mask, back_p, raw)
    torch.cuda.synchronize()
    err["K1" + key] = max(err["K1" + key], exact_state(fix_k, fix_p, f"{where} K1 masked"))
    return flags_k, fix_k, compare_steps(fix_k, out_k, f"{where} sorted step vs dense")


def check_straight_global(ht, ss, sf, rows, err, launches, card: str, start: float,
                          timed) -> None:
    """The straight scenes one block cannot hold, on the global K1 and K3
    and on K2a and K2b past one slot a thread: each of
    STRAIGHT_GLOBAL_SCENES made on CUDA, its layout ``straight_layout_for``
    global, the slab's words of the global K1 and K3 held to the libraries'
    counts (``*_global_words``), every kernel held bit-exact to its plain
    version on each scene (``hold_straight``; the compressed scene and a
    pile-up across every block boundary reach across the chunks), K1 and K3
    picked by ``*_kernel_for`` (the global counts move, the block ones stay
    0), the Linear rows' and the raw instantiations among them;
    STRAIGHT_GLOBAL_DRIVES driven with the counts set to 0 (the band firing
    share, the launches of each kernel, one a step), the 2048-slot scene's
    captured step against the eager one; the kernel rows at
    STRAIGHT_GLOBAL_ROWS."""
    block = {"K1": sf.frames_kernel, "K3": ss.frames_sorted_kernel}
    glob = {"K1": sf.frames_global_kernel, "K2a": ss.sort_kernel,
            "K3": ss.frames_sorted_global_kernel, "K2b": ss.unsort_kernel}
    envs = {}
    for label, env_id, config, n_check, scene_names in STRAIGHT_GLOBAL_SCENES:
        t0 = time.time()
        env = ht.make(env_id, config)
        envs[label] = env
        V, L = env.num_slots, len(env._straight.offsets)
        if sf.straight_layout_for(V, L) != "global":
            raise AssertionError(f"{env_id} {config}: V={V}, L={L} not in the global layout")
        k1_words, k3_words = sf.global_words(V, L)
        got = (glob["K1"].global_words(V, L), glob["K3"].global_words(V, L))
        if got != (k1_words, k3_words):
            raise AssertionError(f"{env_id} {config}: slab words {got} at launch, "
                                 f"{(k1_words, k3_words)} in straight_frames.global_words")
        G = sf.global_threads(V)
        key = f" global {label}"
        err.update({f"{n}{key}": err.get(f"{n}{key}", 0.0) for n in ("K1", "K2a", "K3", "K2b")})
        gen = env.generator(SEED)
        _, states = env.reset(n_check, gen)
        scene_map = scenes(states.vehicles)
        scene_map["boundary"] = boundary_pileup(states.vehicles, G)
        acts = random_actions(env, n_check, gen)
        fired = [0, 0]
        for name in scene_names:
            veh = env.action_type.apply(env.geo, scene_map[name], scene_map[name].kind == 1,
                                        env._action_to_slots(acts))
            for k in (*block.values(), *glob.values()):
                k.launches = 0
            flags = hold_straight(ss, sf, env, veh, f"{env_id} {config} {name}", err, key)[0]
            moved = {**{f"{n} block": k.launches for n, k in block.items()},
                     **{n: k.launches for n, k in glob.items()}}
            if moved != {"K1 block": 0, "K3 block": 0, "K1": 3, "K2a": 1, "K3": 1, "K2b": 1}:
                raise AssertionError(f"{env_id} {config} {name}: launches {moved}")
            f = flags.sum(dim=0).tolist()
            fired = [fired[0] + f[0], fired[1] + f[1]]
        blocks = sf.global_blocks(V)
        print(f"  {label}: {env_id} {config}, V={V}, L={L}, {blocks} block"
              f"{'s' * (blocks > 1)} of {G} threads an env, slab "
              f"{4 * k1_words} / {4 * k3_words} bytes an env (K1 / K3, the libraries' counts); "
              f"K1 (every env, masked to every env, masked by the flags), K2a, K3 with its "
              f"flags and K2b bit-exact to their plain versions on {list(scene_names)} at "
              f"B={n_check}, K1 and K3 through their global wrappers; envs fired: collision "
              f"{fired[0]}, neighbour {fired[1]}; Linear rows {int((states.vehicles.kind == 3).sum())}"
              f" ({time.time() - t0:.1f} s) [at {time.time() - start:.0f} s]")
    every = {**{f"{n} block": k for n, k in block.items()},
             **{f"{n} global": k for n, k in glob.items()}}
    for label, n_drive, steps in STRAIGHT_GLOBAL_DRIVES:
        t0 = time.time()
        env = envs[label]
        gen = env.generator(SEED + 1)
        recorder = FlagRecorder(glob["K3"])
        ss.frames_sorted_global_kernel = recorder
        try:
            for k in every.values():
                k.launches = 0
            _, st = env.reset(n_drive, gen)
            st, m = rollout(env, st, steps, gen)
            torch.cuda.synchronize()
        finally:
            ss.frames_sorted_global_kernel = glob["K3"]
        counts = {n: k.launches for n, k in every.items()}
        want = {n: (steps if n.endswith("global") else 0) for n in every}
        m = {k: float(v) for k, v in m.items()}
        fl = torch.stack(recorder.flags)
        share = float(fl.any(dim=2).double().mean())
        print(f"  {label} path, highway-v0 V={env.num_slots}: reset and {steps} autoreset "
              f"steps, B={n_drive}, launches {counts}; env-steps whose band flag fired "
              f"{share:.6f} (collision {float(fl[..., 0].double().mean()):.6f}, neighbour "
              f"{float(fl[..., 1].double().mean()):.6f}); rollout {m} "
              f"({time.time() - t0:.1f} s) [at {time.time() - start:.0f} s]")
        if counts != want:
            raise AssertionError(f"{label} path: launches {counts}, expected {want}")
        if not all(np.isfinite(list(m.values()))):
            raise AssertionError(f"{label} path: non-finite metrics")
        for k in ("pos", "speed", "heading"):
            if not bool(torch.isfinite(getattr(st.vehicles, k)).all()):
                raise AssertionError(f"{label} path: non-finite {k}")
        for n in ("K1", "K2a", "K3", "K2b"):
            launches[f"{n} global {label}"] = counts[f"{n} global"]
        del st
    captured_against_eager(envs["2048 slots"], "highway-v0 2048 slots", STRAIGHT_GRAPH_STEPS,
                           STRAIGHT_GRAPH_ROWS)
    for label, n_row in STRAIGHT_GLOBAL_ROWS:
        env = envs[label]
        torch.cuda.reset_peak_memory_stats()
        _, st = env.reset(n_row, env.generator(SEED + 2))
        straight_rows(env, st, timed, rows, f" global {label}", glob=True)
        print(f"  rows at {label}: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              f" GB ({card}) [at {time.time() - start:.0f} s]")
        del st


#: roads the fixed tables once refused, on the general kernels
#: (``highwayenv_tpu_torch/tools/custom_roads.py``), each (row key, env id
#: or custom_roads class name, config, driven, rows of the checks): merge-v0
#: with a junction of 5 successor edges (a fixed-width and a variable-width
#: poly lane carrying NPCs, a chain of 17 short edges on an 18-slot route),
#: with 5 and 10 predecessor edges into a node under the connected-lane
#: search (7 and 12 candidate lanes a lane), roundabout-v0 with 17 and 31
#: target speeds, racetrack-oval-v0 with 9 lanes an edge (72 lanes); then
#: the kSized instantiation of each law in each layout (SIZED_ROWS); each
#: held to its plain version, the driven ones driven CUSTOM_STEPS steps with
#: the counts set to 0 and captured against eager, with a kernel row at B.
#: The 5-predecessor merge under a dynamical action is held only: merge's
#: reward compares the action to 0 and 2, which a ContinuousAction's is not.
CUSTOM_ROWS = (
    ("K4 poly junction", "PolyJunctionMerge", {}, True, 256),
    ("K4 connected 5 predecessors", "FivePredecessorMerge",
     {"neighbour_vehicles_connected_lanes": True}, True, 256),
    ("K4 connected 12 candidates", "CrowdedMerge",
     {"neighbour_vehicles_connected_lanes": True}, True, 256),
    ("K4 connected dynamical 5 predecessors", "FivePredecessorMerge",
     {"neighbour_vehicles_connected_lanes": True, **DYNAMICAL}, False, 256),
    ("K4 17 speeds", "roundabout-v0", {"action": {
        "type": "DiscreteMetaAction", "target_speeds": list(np.linspace(0.0, 16.0, 17))}},
     True, 256),
    ("K4 31 speeds", "roundabout-v0", {"action": {
        "type": "DiscreteMetaAction", "target_speeds": list(np.linspace(0.0, 30.0, 31))}},
     True, 256),
    ("K4 raw 72 lanes", "racetrack-oval-v0", {"no_lanes": 9}, True, 256),
)
#: intersection-v0's action with 17 target speeds (its own 3 are 0, 4.5, 9)
SPEEDS_17 = {"action": {"type": "DiscreteMetaAction", "longitudinal": True, "lateral": False,
                        "target_speeds": [float(x) for x in np.linspace(0.0, 9.0, 17)]}}
CONNECTED = {"neighbour_vehicles_connected_lanes": True}
#: the kSized instantiations of the wide and cluster libraries and the
#: sized K5, which ordinary settings reach: intersection-v0 with 17 target
#: speeds (V=25 narrow, at duration 30 V=42 wide, at policy_frequency 15
#: V=207 cluster) and exit-v0 with a poly edge past its end carrying NPCs
#: (PolyExit, V=51 wide and V=151 cluster, the poly lanes' NPCs in both
#: ranks); each driven, and its connected twin (intersection-v2, exit-v1's
#: search) held only, as are PolyExit's dynamical wide and connected
#: dynamical cluster instantiations
SIZED_ROWS = (
    ("K5 17 speeds", "intersection-v0", SPEEDS_17, True, 256),
    ("K5 wide 17 speeds", "intersection-v0", {"duration": 30, **SPEEDS_17}, True, 128),
    ("K5 cluster 17 speeds", "intersection-v0", {"policy_frequency": 15, **SPEEDS_17},
     True, 64),
    ("K4 wide poly", "PolyExit", {"vehicles_count": 50}, True, 128),
    ("K4 cluster poly", "PolyExit", {"vehicles_count": 150}, True, 64),
    ("K5 connected 17 speeds", "intersection-v0", {**CONNECTED, **SPEEDS_17}, False, 256),
    ("K5 wide connected 17 speeds", "intersection-v0",
     {"duration": 30, **CONNECTED, **SPEEDS_17}, False, 128),
    ("K5 cluster connected 17 speeds", "intersection-v0",
     {"policy_frequency": 15, **CONNECTED, **SPEEDS_17}, False, 64),
    ("K4 wide connected poly", "PolyExit", {"vehicles_count": 50, **CONNECTED}, False, 128),
    ("K4 cluster connected poly", "PolyExit", {"vehicles_count": 150, **CONNECTED}, False,
     64),
    ("K4 wide dynamical poly", "PolyExit", {"vehicles_count": 50, **DYNAMICAL}, False, 128),
    ("K4 cluster connected dynamical poly", "PolyExit",
     {"vehicles_count": 150, **CONNECTED, **DYNAMICAL}, False, 64),
)
#: the straight road past 16 lanes: K1 / K3 (phase 3 holds them on its
#: scenes with the other straight configs)
CUSTOM_STRAIGHT = {"lanes_count": 17}
CUSTOM_STEPS = 4  # policy steps of each driven path, eager and captured


def custom_env(ht, name: str, config):
    """``ht.make(name, config)``, or the custom_roads class ``name`` made
    with ``config`` on the card."""
    from highwayenv_tpu_torch.tools import custom_roads

    cls = getattr(custom_roads, name, None)
    return ht.make(name, config) if cls is None else cls(config)


def hold_custom(gf, env, key: str, label: str, err, start: float, steps_in: bool,
                n_check: int) -> None:
    """``env``'s instantiation against its plain version at ``n_check``
    rows (in chunks of ``plain_rows``), every field bit-exact, on the reset
    scene, 8 steps in (the env's autoreset step; with ``steps_in`` off the
    frames alone, ``_simulate_batched``) and the all-env pile-up, or on a
    regulated road ``regulated_scenes``; the largest error in
    ``err[key]``."""
    gen = env.generator(SEED)
    _, states = env.reset(n_check, gen)
    kernel = gf.frames_kernel_for(env._general, env.regulated, env.num_slots)
    sized = gf.scene_tables(env._general, env.route_slots, env.action_type.stores_raw_controls)[2]
    print(f"== 4. {key}, {label}: V={env.num_slots}, L={env.geo.num_lanes}, "
          f"R={states.vehicles.route_base.shape[-1]}, S={env.geo.succ_edge_base.shape[1]}, "
          f"K={env.geo.conn_lanes.shape[1] if env._general.connected else 0}, "
          f"{kernel.source}{'_sized' * sized}.{kernel.entry}, B={n_check} "
          f"[at {time.time() - start:.0f} s]")
    if steps_in:
        calls = wide_scenes(env, states, gen)
    else:  # the frames alone: the env's reward takes no such action
        st = states
        for _ in range(8):
            st = env._simulate_batched(st, random_actions(env, n_check, gen))
        calls = {}
        for name, veh in (("reset", states.vehicles), ("8 frames-only steps in", st.vehicles),
                          ("pile-up", pile_up(states.vehicles))):
            sa = env._action_to_slots(random_actions(env, n_check, gen))
            veh, sa, raw = gf.store_raw_controls(env, veh, sa)
            calls[name] = (veh, None, sa, env.frames_per_step, raw)
    err[key] = 0.0
    for name, call in calls.items():
        k, run, plain = frame_call(gf, env, *call, chunk=plain_rows(env.num_slots))
        out_k = run()
        out_p = plain()
        torch.cuda.synchronize()
        err[key] = max(err[key], compare_general(out_k, out_p, f"{label} {name} ({k.entry})"))
        if name == "pile-up" and not bool(out_k.crashed.any()):
            raise AssertionError(f"{label}: the pile-up scene crashed nothing")
    print(f"  {key}: {list(calls)} bit-exact on every field")


def captured_against_eager(env, label: str, steps: int = CUSTOM_STEPS, n: int = B) -> None:
    """``steps`` random-policy autoreset steps at ``n`` rows from one reset,
    eager and through the captured step (``rollout(..., graph=True)``), the
    states and metrics equal bit for bit."""
    from highwayenv_tpu_torch.envs.base import map_fields

    _, st = env.reset(n, env.generator(SEED + 6))
    s_e, m_e = rollout(env, map_fields(torch.clone, st), steps, env.generator(SEED + 7))
    s_g, m_g = rollout(env, map_fields(torch.clone, st), steps, env.generator(SEED + 7),
                       graph=True)
    torch.cuda.synchronize()
    same = {n: torch.equal(m_e[n], m_g[n]) for n in m_e}
    for f in dataclasses.fields(s_e.vehicles):
        same[f.name] = torch.equal(getattr(s_e.vehicles, f.name), getattr(s_g.vehicles, f.name))
    if not all(same.values()):
        raise AssertionError(f"{label}: captured differs from eager in "
                             f"{[n for n, ok in same.items() if not ok]}")
    print(f"  {label}: {steps} captured steps against eager at B={n}, states and metrics "
          f"bit-exact; {({n: float(v) for n, v in m_g.items()})}")


def check_custom_roads(ht, ss, sf, gf, kernels, rows, err, launches, card: str, start: float,
                       timed) -> None:
    """The roads the fixed tables once refused (CUSTOM_ROWS) and the kSized
    instantiations of every layout (SIZED_ROWS): each made on CUDA, its
    instantiation held to its plain version (``hold_custom``);
    the driven ones take CUSTOM_STEPS steps with the counts set to 0
    (``drive_path``) and CUSTOM_STEPS captured steps against eager, and get
    a kernel row at B (``frame_row``).  Then highway-v0 with 17 lanes: the
    sorted step driven CUSTOM_STEPS steps with the counts set to 0 (K1, K2a,
    K3, K2b once a step, alone), captured against eager, and rows
    "K1 17 lanes" .. (``straight_rows``).  Also holds the launch's shared
    memory (``general_smem_bytes`` of each library, ``*_smem_bytes`` of
    K1 and K3) to make's copy of its formula."""
    every = {**kernels, **layout_kernels(gf, ""), **layout_kernels(gf, "wide"),
             **layout_kernels(gf, "cluster")}
    # the launches' own shared-memory counts against make's copy, in the
    # fixed and the kSized libraries
    sizes = 0
    for layout, V in (("", 5), ("", 25), ("wide", 42), ("wide", 128), ("cluster", 207),
                      ("cluster", 2048)):
        lib = layout_kernels(gf, layout)
        for reg in (False, True):
            for conn in (False, True):
                for L, R, S, sized in ((20, 3, 4, False), (72, 16, 4, False),
                                       (72, 18, 5, True), (300, 40, 9, True)):
                    K = (gf.FIXED_CONN if not sized else 1 + 2 * S) if conn else 0
                    k = lib[f"{'K5' if reg else 'K4'}{' ' + layout if layout else ''}"
                            f"{' connected' if conn else ''}"]
                    got = k.smem_bytes(L, V, R, S, K, sized)
                    want = gf.launch_smem(V, L, R, S, K, reg, sized)
                    if got != want:
                        raise AssertionError(f"{k.source}.{k.entry} V={V} L={L} R={R} S={S} "
                                             f"K={K} sized={sized}: {got} bytes at launch, "
                                             f"{want} at make")
                    sizes += 1
    for V in (21, 51, 101, 1024):
        for L in (4, 17, 40):
            got = (sf.frames_kernel.smem_bytes(V, L), ss.frames_sorted_kernel.smem_bytes(V, L))
            if got != sf.launch_smem(V, L):
                raise AssertionError(f"K1 / K3 V={V} L={L}: {got} bytes at launch, "
                                     f"{sf.launch_smem(V, L)} at make")
            sizes += 1
    print(f"  shared memory a block: the launches' counts equal make's at {sizes} shapes")
    sized_keys = {row[0] for row in SIZED_ROWS}
    for key, name, config, driven, n_check in CUSTOM_ROWS + SIZED_ROWS:
        env = custom_env(ht, name, config)
        label = f"{name} {json.dumps(config)}"
        if key in sized_keys and not gf.scene_tables(
                env._general, env.route_slots, env.action_type.stores_raw_controls)[2]:
            raise AssertionError(f"{label}: not the kSized instantiation SIZED_ROWS names")
        # the frames alone only where the env's reward takes no such action
        # (merge's under a ContinuousAction)
        hold_custom(gf, env, key, label, err, start, driven or not env._general.dynamical,
                    n_check)
        if driven:
            launches[key] = drive_path(gf, env, every, key, name, config, CUSTOM_STEPS)
            captured_against_eager(env, label)
            frame_row(gf, env, key, name, config, rows, err, card, start)
    # the straight road past 16 lanes
    env = ht.make("highway-v0", CUSTOM_STRAIGHT)
    label = f"highway-v0 {json.dumps(CUSTOM_STRAIGHT)}"
    gen = env.generator(SEED + 1)
    for k in kernels.values():
        k.launches = 0
    _, st = env.reset(B, gen)
    st, m = rollout(env, st, CUSTOM_STEPS, gen)
    torch.cuda.synchronize()
    counts = {n: kernels[n].launches for n in ("K1", "K2a", "K3", "K2b")}
    others = {n: k.launches for n, k in kernels.items() if n not in counts and k.launches}
    print(f"  {label} path: reset and {CUSTOM_STEPS} autoreset steps, B={B}, launches "
          f"{counts}, other kernels {others}; rollout {({n: float(v) for n, v in m.items()})}")
    if any(v != CUSTOM_STEPS for v in counts.values()) or others:
        raise AssertionError(f"{label}: the sorted kernels must launch once a step, alone")
    for n, c in counts.items():
        launches[f"{n} 17 lanes"] = c
        err[f"{n} 17 lanes"] = err.get(f"{n} 17 lanes", 0.0)
    captured_against_eager(env, label)
    _, states = env.reset(B, env.generator(SEED))
    straight_rows(env, states, timed, rows, " 17 lanes")



#: obstacles, landmarks and plain Vehicle rows on a straight road, on K1's
#: objects instantiations (an env made with lean=False): the scenes of
#: highwayenv_tpu_torch/tools/object_scenes.py at B under the IDM and the
#: LinearVehicle configs, and at 2047 vehicles (V=2048, the global layout)
#: at OBJECT_GLOBAL_ROWS rows with a pile-up across every block boundary
OBJECT_CONFIGS = (("IDM", None), ("Linear", LINEAR_CONFIG))
OBJECT_GLOBAL = {"vehicles_count": 2047}
OBJECT_GLOBAL_ROWS = 4
OBJECT_HORIZON = 8  # policy steps of each lean=False path's zeroed eager rollout
OBJECT_GLOBAL_DRIVE = (256, 2)  # rows and policy steps of the global path's rollout
OBJECT_ROW_ROWS = 16  # rows of the global kernel row
#: a child process: the lean K3 launched on a state with one obstacle row,
#: which must trap; exit 3 on the launch failure, 0 if none came
LEAN_TRAP_CHILD = r"""
import sys, torch
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.ops import straight_sorted as ss
env = ht.make("highway-v0")
_, st = env.reset(64, env.generator(0))
kind = st.vehicles.kind.clone()
kind[:, 5] = 5  # KIND_OBSTACLE
srt, idx = ss.sort_kernel(st.vehicles.replace(kind=kind), env._straight)
try:
    ss.frames_sorted_kernel(srt, idx, env._straight, env.idm_params, env.dt, env.frames_per_step)
    torch.cuda.synchronize()
except RuntimeError as e:
    print(f"lean K3 on an obstacle row: {str(e).strip().splitlines()[0]}")
    sys.exit(3 if "launch failure" in str(e) else 4)
print("lean K3 on an obstacle row: no error")
"""


def hold_objects(sf, env, veh, where: str, err, key: str):
    """K1's objects instantiation on ``veh`` (the env's action applied), in
    the scene's layout, every field bit-exact to ``frames_plain`` (``hit``
    among them), and masked to every env bit-exact to the masked plain
    version; the errors kept under ``key``.  Returns the plain result."""
    from highwayenv_tpu_torch.envs.base import map_fields

    fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
    raw, linear = env.action_type.stores_raw_controls, env.linear_rows
    Bc, V = veh.kind.shape
    k1 = sf.frames_kernel_for(V, len(fs.offsets))
    out_k = k1(veh, fs, p, dt, frames, raw=raw, linear=linear, objects=True)
    out_p = sf.frames_plain(veh, fs, p, dt, frames, raw)
    torch.cuda.synchronize()
    err[key] = max(err[key], exact_state(out_k, out_p, f"{where} K1 objects"))
    every = torch.ones(Bc, dtype=torch.bool, device=veh.speed.device)
    base = map_fields(torch.clone, veh)
    all_k = k1(veh, fs, p, dt, frames, mask=every, out=map_fields(torch.clone, base), raw=raw,
               linear=linear, objects=True)
    all_p = sf._masked_plain(veh, fs, p, dt, frames, every, map_fields(torch.clone, base), raw)
    torch.cuda.synchronize()
    err[key] = max(err[key], exact_state(all_k, all_p, f"{where} K1 objects masked to every env"))
    return out_p


def object_work(sf, env, veh):
    """(fp32 operations, bytes) of K1's objects launch on ``veh``: the
    operations counted frame by frame on the plain version as the K1 row
    counts them, the bytes every field read once (``hit`` too) and the
    mutated ones and ``hit`` written once."""
    fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
    ops, v = 0.0, veh
    for _ in range(frames):
        out = sf.frames_plain(v, fs, p, dt, 1)
        ops += frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = (read_bytes(veh, sf._IN_FIELDS) + field_bytes(veh, sf._OUT_FIELDS)
               + 2 * field_bytes(veh, sf._HIT))
    return ops, n_bytes


def check_objects(ht, ss, sf, rows, err, launches, card: str, start: float, timed) -> None:
    """Obstacles, landmarks and plain Vehicle rows on a straight road: K1's
    four objects instantiations (IDM / Linear, block / global) held
    bit-exact to ``frames_plain`` on the object scenes (OBJECT_CONFIGS at B,
    OBJECT_GLOBAL at OBJECT_GLOBAL_ROWS rows); ``make("highway-v0",
    lean=False)`` (and LinearVehicle) driven OBJECT_HORIZON eager steps from
    an obstacle scene with the counts set to 0 (one K1 launch a step, no
    K2a, K3 or K2b), three autoreset steps against the plain reference
    path and the captured step against the eager one; the 2048-slot path
    driven alike; the lean K3 trapping on an obstacle row in a child
    process; and the rows "K1 objects", "K1 objects linear" and "K1 objects
    global 2048 slots", each beside the lean K1 on the same vehicles."""
    import pathlib

    from highwayenv_tpu_torch.tools import object_scenes

    every = {"K1": sf.frames_kernel, "K1 global": sf.frames_global_kernel,
             "K2a": ss.sort_kernel, "K3": ss.frames_sorted_kernel,
             "K3 global": ss.frames_sorted_global_kernel, "K2b": ss.unsort_kernel}
    envs = {}
    for label, config in OBJECT_CONFIGS:
        t0 = time.time()
        key = "K1 objects" + ("" if config is None else " linear")
        err[key] = err.get(key, 0.0)
        env = ht.make("highway-v0", config, lean=False)
        envs[label] = env
        gen = env.generator(SEED)
        _, states = env.reset(B, gen)
        acts = random_actions(env, B, gen)
        seen = []
        for name in object_scenes.SCENES:
            scene = object_scenes.object_state(states.vehicles, name)
            veh = env.action_type.apply(env.geo, scene, scene.kind == 1, env._action_to_slots(acts))
            out = hold_objects(sf, env, veh, f"highway-v0 {label} {name}", err, key)
            obst, land = veh.kind == 5, veh.kind == 6
            if not torch.equal(out.pos[obst | land], veh.pos[obst | land]):
                raise AssertionError(f"highway-v0 {label} {name}: an object moved")
            seen.append(f"{name}: crashed {int(out.crashed.sum())} (obstacles "
                        f"{int(out.crashed[obst].sum())}), hit {int(out.hit.sum())}")
            if name == "landmark" and not bool(out.hit[land].any()):
                raise AssertionError(f"highway-v0 {label} landmark: no landmark hit")
            if name == "obstacle" and not bool(out.crashed[obst].any()):
                raise AssertionError(f"highway-v0 {label} obstacle: no vehicle ran into one")
        print(f"  highway-v0 {label} lean=False, V={env.num_slots}, B={B}: K1 objects (every "
              f"env and masked to every env) bit-exact to its plain version on "
              f"{list(object_scenes.SCENES)}; {'; '.join(seen)} ({time.time() - t0:.1f} s) "
              f"[at {time.time() - start:.0f} s]")
    for label, config in OBJECT_CONFIGS:
        t0 = time.time()
        env = ht.make("highway-v0", {**OBJECT_GLOBAL, **(config or {})}, lean=False)
        envs[f"{label} global"] = env
        V, L = env.num_slots, len(env._straight.offsets)
        if sf.straight_layout_for(V, L) != "global":
            raise AssertionError(f"highway-v0 {label} V={V}: not the global layout")
        key = "K1 objects global 2048 slots" + ("" if config is None else " linear")
        err[key] = err.get(key, 0.0)
        gen = env.generator(SEED)
        _, states = env.reset(OBJECT_GLOBAL_ROWS, gen)
        acts = random_actions(env, OBJECT_GLOBAL_ROWS, gen)
        for name in ("obstacle", "boundary"):
            scene = object_scenes.object_state(states.vehicles, name, sf.global_threads(V))
            veh = env.action_type.apply(env.geo, scene, scene.kind == 1, env._action_to_slots(acts))
            for k in every.values():
                k.launches = 0
            hold_objects(sf, env, veh, f"highway-v0 {label} V={V} {name}", err, key)
            moved = {n: k.launches for n, k in every.items() if k.launches}
            if moved != {"K1 global": 2}:
                raise AssertionError(f"highway-v0 {label} V={V} {name}: launches {moved}")
        print(f"  highway-v0 {label} lean=False, V={V} ({sf.global_blocks(V)} blocks of "
              f"{sf.global_threads(V)} threads an env), B={OBJECT_GLOBAL_ROWS}: the global K1 "
              f"objects bit-exact to its plain version on the obstacle scene and a pile-up of "
              f"objects across every block boundary ({time.time() - t0:.1f} s) "
              f"[at {time.time() - start:.0f} s]")

    # the lean=False paths: one K1 launch a step, nothing else of the
    # straight path; against the plain reference path; captured
    drives = [(label, envs[label], B, OBJECT_HORIZON) for label, _ in OBJECT_CONFIGS]
    drives.append(("IDM global", envs["IDM global"], *OBJECT_GLOBAL_DRIVE))
    for label, env, n, steps in drives:
        t0 = time.time()
        glob = label.endswith("global")
        gen = env.generator(SEED + 1)
        _, st = env.reset(n, gen)
        st = st.replace(vehicles=object_scenes.object_state(st.vehicles, "obstacle"))
        start_state = st
        for k in every.values():
            k.launches = 0
        st, m = rollout(env, st, steps, gen)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in every.items()}
        want = {name: steps if name == ("K1 global" if glob else "K1") else 0 for name in every}
        m = {k: float(v) for k, v in m.items()}
        print(f"  make('highway-v0', lean=False) {label} path, V={env.num_slots}: the obstacle "
              f"scene and {steps} autoreset steps, B={n}, launches {counts}; rollout {m} "
              f"({time.time() - t0:.1f} s) [at {time.time() - start:.0f} s]")
        if counts != want:
            raise AssertionError(f"lean=False {label} path: launches {counts}, expected {want}")
        if not all(np.isfinite(list(m.values()))):
            raise AssertionError(f"lean=False {label} path: non-finite metrics")
        key = "K1 objects" + {"IDM": "", "Linear": " linear", "IDM global": " global 2048 slots"}[
            label]
        launches[key] = counts["K1 global" if glob else "K1"]
        if not glob:
            check_autoreset(env, start_state, env.generator(SEED + 2),
                            f"highway-v0 {label} lean=False ")
            check_graph(env, start_state, f"highway-v0 {label} lean=False ",
                        variants=((None, False),))
        del st, start_state

    # the lean K3 traps on an obstacle row: in a child process, whose CUDA
    # context the trap ends
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", LEAN_TRAP_CHILD],
                           cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
                           text=True, timeout=600)
    said = (child.stdout.strip().splitlines() or [""])[-1]
    print(f"  child process: {said!r}, exit {child.returncode} ({time.time() - t0:.1f} s)")
    if child.returncode != 3:
        raise AssertionError(f"the lean K3 on an obstacle row: exit {child.returncode}, not 3 "
                             f"(a launch failure); stderr {child.stderr[-2000:]}")

    # the rows: K1 objects on the obstacle scene from a fresh reset, every
    # ego FASTER; beside it the lean K1 and the objects K1 on the same
    # vehicles without the objects
    for label, rows_n, key in (("IDM", B, "K1 objects"), ("Linear", B, "K1 objects linear"),
                               ("IDM global", OBJECT_ROW_ROWS, "K1 objects global 2048 slots")):
        env = envs[label]
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        V, L = env.num_slots, len(fs.offsets)
        k1 = sf.frames_kernel_for(V, L)
        linear = env.linear_rows
        _, st = env.reset(rows_n, env.generator(SEED + 3))
        sa = env._action_to_slots(torch.ones((rows_n,) + env.action_shape, dtype=torch.int32,
                                             device=env.device))
        plain_veh = env.action_type.apply(env.geo, st.vehicles, st.vehicles.kind == 1, sa)
        veh = object_scenes.object_state(plain_veh, "obstacle")
        tag = f" (highway-v0 {label} obstacle scene, V={V}, B={rows_n})"
        out_k = k1(veh, fs, p, dt, frames, linear=linear, objects=True)
        out_p = sf.frames_plain(veh, fs, p, dt, frames)
        torch.cuda.synchronize()
        err[key] = max(err[key], exact_state(out_k, out_p, f"{key} timed inputs"))
        ms, plain_ms, _ = timed(
            f"{key} straight_frames{'_global' if k1.glob else ''}{tag}, per policy step",
            lambda: k1(veh, fs, p, dt, frames, linear=linear, objects=True),
            lambda: sf.frames_plain(veh, fs, p, dt, frames), None, 20, PLAIN_REPS)
        lean_ms = queued_ms(lambda: k1(plain_veh, fs, p, dt, frames, linear=linear), 20)
        same_ms = queued_ms(lambda: k1(plain_veh, fs, p, dt, frames, linear=linear,
                                       objects=True), 20)
        ops, n_bytes = object_work(sf, env, veh)
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        glob_sfx = "_global" if k1.glob else ""
        rows[key] = (f"straight_frames{glob_sfx} objects" + tag,
                     f"highwayenv_tpu_torch/csrc/straight_frames{glob_sfx}.cu",
                     "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms, by, None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, {n_bytes} "
              f"bytes -> {t_bytes:.4f} ms); on the same vehicles without objects: the lean K1 "
              f"{lean_ms:.4f} ms, the objects K1 {same_ms:.4f} ms queued (objects / lean "
              f"{same_ms / lean_ms:.3f}; {card}) [at {time.time() - start:.0f} s]")
        del st, veh, plain_veh, out_k, out_p


def main() -> int:
    start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import highwayenv_tpu_torch as ht
    from highwayenv_tpu_torch.envs import preprocessors
    from highwayenv_tpu_torch.ops import _build, general_frames, straight_frames, straight_sorted
    from highwayenv_tpu_torch.road import lane as lane_ops
    from highwayenv_tpu_torch.vehicle.state import KIND_LINEAR

    sf, ss, gf =straight_frames, straight_sorted, general_frames
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("== 1. device")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    print("== 2. build")
    t0 = time.time()
    wait_general = build_in_background(_build, GENERAL_LIBRARIES)
    paths = _build.build(STRAIGHT_LIBRARIES)
    print(f"built {[p.name for p in paths.values()]} in {time.time() - t0:.1f} s; the general "
          "libraries build meanwhile, while phase 3 holds the straight kernels")

    k1, k2a, k3, k2b = sf.frames_kernel, ss.sort_kernel, ss.frames_sorted_kernel, ss.unsort_kernel
    k4 = gf.frames_general_kernel
    err = {"K1": 0.0, "K2a": 0.0, "K3": 0.0, "K2b": 0.0, "K1 raw": 0.0, "K3 raw": 0.0,
           "K1 linear": 0.0, "K3 linear": 0.0, "K1 2 egos": 0.0, "K2a 2 egos": 0.0,
           "K3 2 egos": 0.0, "K2b 2 egos": 0.0}
    # highway-fast-v0 (V=21, 5 frames) and highway-v0 at the warp
    # boundaries run the same kernels; highway-v0 under a ContinuousAction
    # runs K1's and K3's raw-control branch (its env carried on below as
    # cenv); under the LinearVehicle preset (carried on as lenv, the Linear
    # slice's main path) and AggressiveVehicle, and with change_vehicles'
    # Linear rows on the IDM-config env, the Linear rows' branch, with K1
    # also masked to every env; the main path is highway-v0, checked last
    # so its env and states carry on below.  Each entry: (env id, config,
    # B, the class change_vehicles puts on the reset state or None, scenes)
    straight = ([("highway-fast-v0", None, B, None, SCENES)]
                + [("highway-v0", {"vehicles_count": n}, EDGE_B, None, SCENES)
                   for n in EDGE_VEHICLES]
                + [("highway-v0", CONTINUOUS_CONFIG, B, None, SCENES),
                   ("highway-v0", LINEAR_CONFIG, B, None, SCENES),
                   ("highway-v0", AGGRESSIVE_CONFIG, B, None, ("normal", "pileup_all")),
                   ("highway-v0", None, B, NPC + "LinearVehicle", ("normal", "pileup_all")),
                   ("highway-v0", SEVERAL_STRAIGHT, B, None, SCENES + ("8 steps in",)),
                   ("highway-v0", CUSTOM_STRAIGHT, B, None, ("normal", "compressed", "pileup_all")),
                   ("highway-v0", None, B, None, SCENES)])
    for env_id, config, Bc, change, scene_names in straight:
        env = ht.make(env_id, config)
        fs, p, dt, frames = env._straight, env.idm_params, env.dt, env.frames_per_step
        raw = env.action_type.stores_raw_controls
        gen = env.generator(SEED)
        _, states = env.reset(Bc, gen)
        if change is not None:
            states = preprocessors.change_vehicles(env, states, change)
        linear = env.linear_rows
        # several ego rows (highway-v0 with two egos) keep their own errors
        esfx = f" {len(env.ego_slots)} egos" if len(env.ego_slots) > 1 else ""
        sfx = " raw" if raw else (" linear" if linear else esfx)
        if config == CUSTOM_STRAIGHT:  # 17 lanes keep their own errors
            sfx = " 17 lanes"
            err.update({f"{n}{sfx}": 0.0 for n in ("K1", "K2a", "K3", "K2b")})
        label = (f"{env_id} V={env.num_slots}" + (" ContinuousAction" if raw else "")
                 + (f", egos in slots {list(env.ego_slots)}" if esfx else "")
                 + (f" {env.npc_preset}" if env.npc_preset else "")
                 + (f" change_vehicles({change.rsplit('.', 1)[-1]})" if change else ""))
        print(f"== 3. kernels vs plain: {label}, {frames} frames, B={Bc}")
        actions = random_actions(env, Bc, gen)
        both_fired = False
        scene_map = scenes(states.vehicles)
        if "8 steps in" in scene_names:
            scene_map["8 steps in"] = eight_steps_in(env, states, gen).vehicles
        for name, veh in scene_map.items():
            if name not in scene_names:
                continue
            where = f"{label} {name}"
            veh = env.action_type.apply(
                env.geo, veh, veh.kind == 1, env._action_to_slots(actions)
            )
            # K1 dense, K2a, K3 on the sorted plain inputs, K2b, K1 masked
            # to every env (the Linear branch's dense step) and by the flags
            # over the banded rows, and the sorted step against the dense one
            flags_k, fix_k, bitwise = hold_straight(ss, sf, env, veh, where, err, sfx,
                                                    every_env=linear)
            mask = flags_k.any(dim=1)
            fired = flags_k.sum(dim=0).tolist()
            both_fired |= min(fired) > 0
            lin_rows = int((veh.kind == KIND_LINEAR).sum())
            print(f"  {where}: K1, K3 and K1 masked bit-exact on every field; firing "
                  f"envs {int(mask.sum())} of {Bc} (collision {fired[0]}, neighbour "
                  f"{fired[1]}); sorted step vs dense step "
                  f"{'bitwise equal' if bitwise else 'within the ulp bound'}; "
                  f"crashed slots {int(fix_k.crashed.sum())}; Linear rows {lin_rows}, lane "
                  f"changes under way {int((fix_k.target_lane != fix_k.lane).sum())}")
            if linear and not lin_rows:
                raise AssertionError(f"{where}: no Linear row")
        if not both_fired and set(SCENES) <= set(scene_names):
            raise AssertionError(f"{label}: no scene fired both band flags")
        if raw:
            cenv = env
        if config == LINEAR_CONFIG:
            lenv, lstates = env, states
        if config == SEVERAL_STRAIGHT:
            e2env, e2states = env, states
    print(f"  [straight kernels checked at {time.time() - start:.0f} s]")
    # the whole autoreset step: the main path (sorted kernels) against the
    # plain reference path, and the Linear slice's main path
    check_autoreset(env, states, gen, "")
    check_autoreset(lenv, lstates, lenv.generator(SEED), "highway-v0 LinearVehicle ")
    check_autoreset(e2env, e2states, e2env.generator(SEED), "highway-v0 2 egos ")
    general_paths = wait_general()
    print(f"  [the general libraries {[p.name for p in general_paths.values()]} built at "
          f"{time.time() - start:.0f} s]")
    for lib in {**paths, **general_paths}.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # K4 on the general path, and its Linear rows' branch at roundabout-v0
    # under AggressiveVehicle (its env carried on as aenv); roundabout-v0
    # last, its env carried on below
    err["K4"] = err["K4 linear"] = 0.0
    for env_id, config in (("merge-v0", None), ("roundabout-v0", AGGRESSIVE_CONFIG),
                           ("roundabout-v0", None)):
        genv = ht.make(env_id, config)
        spec, gframes = genv._general, genv.frames_per_step
        gen = genv.generator(SEED)
        _, gstates = genv.reset(B, gen)
        key = "K4 linear" if config else "K4"
        label = env_id + (f" {genv.npc_preset}" if config else "")
        print(f"== 3. {key} vs plain: {label} V={genv.num_slots}, L={genv.geo.num_lanes}, "
              f"R={gstates.vehicles.route_base.shape[-1]}, {gframes} frames, B={B}")
        for name, veh in general_scenes(genv, gstates, gen,
                                        obstacle_hit=env_id == "merge-v0").items():
            acts = random_actions(genv, B, gen)
            sa = genv._action_to_slots(acts)
            out_k = k4(veh, spec, sa, gframes, linear=genv.linear_rows)
            out_p = gf.frames_general_plain(veh, spec, sa, gframes)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{label} {name}"))
            if config and not bool((veh.kind == KIND_LINEAR).any()):
                raise AssertionError(f"{label} {name}: no Linear row")
            if name == "obstacle hit" and not bool(out_k.crashed[:, 4].any()):
                raise AssertionError("merge-v0: the ramp vehicle hit the obstacle nowhere")
        if config:
            aenv = genv
    check_autoreset(genv, gstates, gen, "roundabout-v0 ")

    # K4's raw-control branch: the racetrack family, lateral-only
    # ContinuousAction egos (V=2; the oval with its 8 roadblocks, V=10),
    # and racetrack-v0 under a DiscreteAction (int actions stored as grid
    # points); each action stored on the egos first, as the env path does;
    # racetrack-v0 last, its env carried on below
    err["K4 raw"] = 0.0
    checked = RACETRACKS[:-1] + (("racetrack-v0", DISCRETE_CONFIG), RACETRACKS[-1])
    for env_id, config in checked:
        renv = ht.make(env_id, config)
        rspec, rframes = renv._general, renv.frames_per_step
        label = env_id + (" DiscreteAction" if config == DISCRETE_CONFIG else "")
        gen = renv.generator(SEED)
        _, rstates = renv.reset(B, gen)
        print(f"== 3. K4 raw vs plain: {label} V={renv.num_slots}, L={renv.geo.num_lanes}, "
              f"{rframes} frames, B={B}, raw controls "
              f"{renv.action_type.stores_raw_controls}")
        for name, veh in general_scenes(renv, rstates, gen).items():
            sa = renv._action_to_slots(random_actions(renv, B, gen))
            veh, _, raw = gf.store_raw_controls(renv, veh, sa)
            out_k = k4(veh, rspec, None, rframes, raw=raw, linear=False)
            out_p = gf.frames_general_plain(veh, rspec, None, rframes, raw=raw)
            torch.cuda.synchronize()
            err["K4 raw"] = max(err["K4 raw"],
                                compare_general(out_k, out_p, f"{label} {name}"))
            if name == "pile-up" and not bool(out_k.crashed[:, 0].all()):
                raise AssertionError(f"{label}: an ego of the pile-up did not crash")
        if env_id == "racetrack-v0":
            check_autoreset(renv, rstates, gen, label + " ")

    print(f"  [K4 checked at {time.time() - start:.0f} s]")
    # K5 on the regulated road; its env carried on below
    k5 = gf.frames_regulated_kernel
    err["K5 step"] = err["K5 warm-up"] = 0.0
    ienv = ht.make("intersection-v0")
    ispec = ienv._general
    gen = ienv.generator(SEED)
    _, istates = ienv.reset(B, gen)
    print(f"== 3. K5 vs plain: intersection-v0 V={ienv.num_slots}, L={ienv.geo.num_lanes}, "
          f"R={istates.vehicles.route_base.shape[-1]}, {ienv.frames_per_step} frames, tick "
          f"period {ispec.period}, B={B}")
    for name, (rveh, rsteps, rsa, rframes) in regulated_scenes(ienv, istates, gen).items():
        out_k = k5(rveh, ispec, rsa, rframes, rsteps, linear=False)
        out_p = gf.frames_general_plain(rveh, ispec, rsa, rframes, rsteps)
        torch.cuda.synchronize()
        key = "K5 warm-up" if name == "warm-up" else "K5 step"
        err[key] = max(err[key], compare_general(out_k, out_p, f"intersection-v0 {name}"))
        phases = torch.unique(torch.remainder(rsteps, ispec.period)).numel()
        ticks = yield_ticks(rveh, ispec, rsa, rframes, rsteps)
        print(f"    V={rveh.kind.shape[1]}, {rframes} frames, {phases} tick phases; slots "
              f"yielding after the step {int(out_k.is_yielding.sum())}, slot-ticks that "
              f"yield {ticks}")
        if name == "conflict" and ticks == 0:
            raise AssertionError("intersection-v0 conflict scene: no vehicle yields")
        if name == "8 steps in" and phases != ispec.period:
            raise AssertionError("intersection-v0: the tick phases are not mixed")
    # K5 at the warp's edge: with duration 20 intersection-v0 has V = 32
    wenv = ht.make("intersection-v0", {"duration": EDGE_DURATION})
    wgen = wenv.generator(SEED)
    _, wstates = wenv.reset(EDGE_B, wgen)
    print(f"== 3. K5 vs plain: intersection-v0 duration {EDGE_DURATION}, "
          f"V={wenv.num_slots}, B={EDGE_B}")
    for name, (rveh, rsteps, rsa, rframes) in regulated_scenes(wenv, wstates, wgen).items():
        if rveh.kind.shape[1] != 32:  # the warm-up runs 16 slots
            continue
        out_k = k5(rveh, wenv._general, rsa, rframes, rsteps, linear=False)
        out_p = gf.frames_general_plain(rveh, wenv._general, rsa, rframes, rsteps)
        torch.cuda.synchronize()
        err["K5 step"] = max(err["K5 step"], compare_general(
            out_k, out_p, f"intersection-v0 V=32 {name}"))
        phases = torch.unique(torch.remainder(rsteps, ispec.period)).numel()
        print(f"    {phases} tick phases; slots yielding after the step "
              f"{int(out_k.is_yielding.sum())}")
        if name == "8 steps in" and phases != ispec.period:
            raise AssertionError("intersection-v0 V=32: the tick phases are not mixed")
    # K5's Linear rows' branch at intersection-v0 under DefensiveVehicle
    # (denv) and its raw-control branch under a ContinuousAction (cienv):
    # the reset scene with the tick phases spread over all 7 values, the
    # conflict scene and, under raw controls, the warm-up launch, each
    # action stored on the egos first under raw controls
    err["K5 linear"] = err["K5 raw"] = 0.0
    k5_envs = {}
    for key, config, what in (("K5 linear", DEFENSIVE_CONFIG, "DefensiveVehicle"),
                              ("K5 raw", CONTINUOUS_CONFIG, "ContinuousAction")):
        xenv = ht.make("intersection-v0", config)
        k5_envs[key] = xenv
        xgen = xenv.generator(SEED)
        _, xstates = xenv.reset(B, xgen)
        label = f"intersection-v0 {what}"
        print(f"== 3. {key} vs plain: {label}, V={xenv.num_slots}, B={B}, raw controls "
              f"{xenv.action_type.stores_raw_controls}")
        spread = torch.arange(B, device=xenv.device, dtype=torch.int32) * xenv.frames_per_step
        for name, (rveh, rsteps, rsa, rframes) in regulated_scenes(
                xenv, xstates, xgen, steps_in=False).items():
            if name == "warm-up" and key == "K5 linear":
                continue  # IDM rows: the preset goes on after the warm-up
            if name == "reset":
                rsteps = rsteps + spread
            rveh, rsa, raw = gf.store_raw_controls(xenv, rveh, rsa)
            out_k = k5(rveh, xenv._general, rsa, rframes, rsteps, raw=raw,
                       linear=xenv.linear_rows)
            out_p = gf.frames_general_plain(rveh, xenv._general, rsa, rframes, rsteps, raw=raw)
            torch.cuda.synchronize()
            err[key] = max(err[key], compare_general(out_k, out_p, f"{label} {name}"))
            phases = torch.unique(torch.remainder(rsteps, ispec.period)).numel()
            lin_rows = int((rveh.kind == KIND_LINEAR).sum())
            print(f"    V={rveh.kind.shape[1]}, {rframes} frames, {phases} tick phases; "
                  f"Linear rows {lin_rows}; slots yielding after the step "
                  f"{int(out_k.is_yielding.sum())}")
            if name == "reset" and phases != ispec.period:
                raise AssertionError(f"{label}: the tick phases are not mixed")
            if key == "K5 linear" and name != "warm-up" and not lin_rows:
                raise AssertionError(f"{label} {name}: no Linear row")
    check_autoreset(ienv, istates, gen, "intersection-v0 ")

    print(f"  [K5 checked at {time.time() - start:.0f} s]")
    # K4 at the slice's five envs; exit-v0 (B rows) and u-turn-v0 (a fresh
    # batch of B rows) carry on to the compact and captured checks
    slice_envs = check_slice_kernels(ht, gf, err)
    xenv, xstates = slice_envs["exit-v0"]
    uenv = slice_envs["u-turn-v0"][0]
    _, ustates = uenv.reset(B, uenv.generator(SEED))
    # K4's raw-control branch on 14 lanes an edge: the parking family;
    # parking-v0 carries on to the compact and captured checks (the dict
    # observation)
    parking_envs = check_parking_kernels(ht, gf, err)
    penv, pstates = parking_envs["parking-v0"]
    # the connected-lane search's K4 and K5 and the two-ego K5 (PR 12);
    # intersection-multi-agent-v0 carries on to the compact and captured
    # checks (the tuple observation)
    conn_envs = check_connected_kernels(ht, gf, err)
    menv, mstates = conn_envs["intersection-multi-agent-v0"]
    for env_id in ("roundabout-v1", "intersection-v2"):
        check_autoreset(*conn_envs[env_id], conn_envs[env_id][0].generator(SEED),
                        env_id + " ")
    # the dynamical K5 and K4; both ids carry on to the compact and
    # captured checks, lane-keeping-v0's rows 1 to 8 steps short of its
    # 200-step truncation, its only episode end
    dyn_envs = check_dynamical_kernels(ht, gf, err)
    v1env, v1states = dyn_envs["intersection-v1"]
    lkenv, lkstates = dyn_envs["lane-keeping-v0"]
    lkstates = lkstates.replace(steps=199 - torch.remainder(
        torch.arange(B, device=lkenv.device, dtype=torch.int32), 8))
    for env_id, (e, st) in dyn_envs.items():
        check_autoreset(e, st, e.generator(SEED), env_id + " ")
    print(f"  [the slice, parking, connected and dynamical kernels checked at "
          f"{time.time() - start:.0f} s]")
    # K4's raw branch with several ego rows
    several_envs = check_several_egos_kernels(ht, gf, err)
    for label in SEVERAL_ROWS:
        e, st = several_envs[label]
        check_autoreset(e, st, e.generator(SEED), label + " ")
    print(f"  [the several-ego kernels checked at {time.time() - start:.0f} s]")
    print("== 3. the kernels' limits refused at make")
    check_refusals(ht)
    print("== 3. to_finite_mdp on CUDA against the CPU")
    check_finite_mdp(ht)

    # the compact autoreset and the captured step, every variant at each id
    for label, e, st in (("highway-v0 ", env, states), ("roundabout-v0 ", genv, gstates),
                         ("intersection-v0 ", ienv, istates),
                         ("racetrack-v0 ", renv, rstates),
                         ("highway-v0 LinearVehicle ", lenv, lstates),
                         ("u-turn-v0 ", uenv, ustates), ("exit-v0 ", xenv, xstates),
                         ("parking-v0 ", penv, pstates),
                         ("intersection-multi-agent-v0 ", menv, mstates),
                         ("intersection-v1 ", v1env, v1states),
                         ("lane-keeping-v0 ", lkenv, lkstates)):
        print(f"== 3. {label}compact autoreset vs full, CapturedStep vs eager "
              f"[at {time.time() - start:.0f} s]")
        check_compact(e, st, label)
        check_graph(e, st, label)

    print(f"(phases 1-3: {time.time() - start:.0f} s)")
    print(f"== 4. main path: make('highway-v0') on CUDA, B={B}, "
          f"{HORIZON} + {CRASH_HORIZON} autoreset steps, sorted step")
    gen = env.generator(SEED + 1)
    _, states = env.reset(B, gen)
    _, crash_states = env.reset(B, gen)
    crash_states = crash_states.replace(
        vehicles=scenes(crash_states.vehicles)["compressed"]
    )
    recorder = FlagRecorder(k3)
    ss.frames_sorted_kernel = recorder
    try:
        for k in (k1, k2a, k3, k2b):
            k.launches = 0
        states, metrics = rollout(env, states, HORIZON, gen)
        _, crash_metrics = rollout(env, crash_states, CRASH_HORIZON, gen)
        torch.cuda.synchronize()
        launches = {"K1": k1.launches, "K2a": k2a.launches, "K3": k3.launches,
                    "K2b": k2b.launches}
    finally:
        ss.frames_sorted_kernel = k3
    steps = HORIZON + CRASH_HORIZON
    print(f"  launches: {launches}")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(
                f"{name} launched {n} times, expected {steps} (one per policy step)"
            )
    fl = torch.stack(recorder.flags)  # (steps, B, 2)
    share = float(fl.any(dim=2).double().mean())
    coll_share = float(fl[..., 0].double().mean())
    neigh_share = float(fl[..., 1].double().mean())
    main_share = float(fl[:HORIZON].any(dim=2).double().mean())
    print(f"  env-steps whose band flag fired: {share:.6f} of {steps * B} "
          f"(collision {coll_share:.6f}, neighbour {neigh_share:.6f}); "
          f"{main_share:.6f} over the {HORIZON} steps from reset")
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
    dense_env = ht.make("highway-v0", sorted_frames=False)
    before = (k1.launches, k2a.launches, k3.launches, k2b.launches)
    _, dense_metrics = rollout(dense_env, states, DENSE_HORIZON, gen)
    torch.cuda.synchronize()
    after = (k1.launches, k2a.launches, k3.launches, k2b.launches)
    if after != (before[0] + DENSE_HORIZON,) + before[1:]:
        raise AssertionError(f"dense path launches {before} -> {after}")
    md = {k: float(v) for k, v in dense_metrics.items()}
    if not all(np.isfinite(list(md.values()))):
        raise AssertionError("dense path: non-finite metrics")
    print(f"  dense path (sorted_frames=False), {DENSE_HORIZON} steps: K1 only, {md}")

    print(f"== 4. main path: make('roundabout-v0') on CUDA, B={B}, {GEN_HORIZON} "
          "random-policy autoreset steps through K4")
    gen = genv.generator(SEED + 1)
    _, gstates = genv.reset(B, gen)
    ended = crashed = obs_sum = 0.0
    finite = torch.ones((), dtype=torch.bool, device=genv.device)
    for k in (k1, k2a, k3, k2b, k4):
        k.launches = 0
    for _ in range(GEN_HORIZON):
        acts = random_actions(genv, B, gen)
        obs, gstates, reward, term, trunc, _ = genv.step_autoreset_batched(gstates, acts, gen)
        ended = ended + (term | trunc).sum()
        crashed = crashed + term.sum()
        obs_sum = obs_sum + obs.double().sum()
        finite = finite & torch.isfinite(obs).all() & torch.isfinite(reward).all()
        for t in (gstates.vehicles.pos, gstates.vehicles.speed, gstates.vehicles.heading):
            finite = finite & torch.isfinite(t).all()
    torch.cuda.synchronize()
    launches["K4"] = k4.launches
    others = (k1.launches, k2a.launches, k3.launches, k2b.launches)
    print(f"  launches: K4 {k4.launches} in {GEN_HORIZON} policy steps, straight "
          f"kernels {others}; obs checksum {float(obs_sum):.6f}; episodes ended "
          f"{int(ended)}, of which by a crash {int(crashed)}, of {GEN_HORIZON * B} "
          "env-steps")
    if k4.launches != GEN_HORIZON or any(others):
        raise AssertionError("roundabout-v0: K4 must launch once per policy step, alone")
    if not bool(finite):
        raise AssertionError("roundabout-v0: non-finite obs, reward or state")
    if not int(ended) > 0:
        raise AssertionError("roundabout-v0: no episode ended")

    print(f"== 4. main path: make('intersection-v0') on CUDA, B={B}, reset and "
          f"{INT_HORIZON} random-policy autoreset steps through K5")
    gen = ienv.generator(SEED + 1)
    recorder = FrameRecorder(k5)
    gf.frames_regulated_kernel = recorder
    try:
        for k in (k1, k2a, k3, k2b, k4, k5):
            k.launches = 0
        _, istates = ienv.reset(B, gen)
        ended = crashed = arrived = obs_sum = 0.0
        finite = torch.ones((), dtype=torch.bool, device=ienv.device)
        for _ in range(INT_HORIZON):
            acts = random_actions(ienv, B, gen)
            obs, istates, reward, term, trunc, info = ienv.step_autoreset_batched(
                istates, acts, gen)
            ended = ended + (term | trunc).sum()
            crashed = crashed + (term & info["crashed"]).sum()
            arrived = arrived + (term & (info["rewards"]["arrived_reward"] > 0)).sum()
            obs_sum = obs_sum + obs.double().sum()
            finite = finite & torch.isfinite(obs).all() & torch.isfinite(reward).all()
            for t in (istates.vehicles.pos, istates.vehicles.speed, istates.vehicles.heading):
                finite = finite & torch.isfinite(t).all()
        torch.cuda.synchronize()
    finally:
        gf.frames_regulated_kernel = k5
    launches["K5 step"] = sum(f == ienv.frames_per_step for f in recorder.frames)
    launches["K5 warm-up"] = sum(f == ienv._warmup_frames for f in recorder.frames)
    others = (k1.launches, k2a.launches, k3.launches, k2b.launches, k4.launches)
    print(f"  launches: K5 {k5.launches} ({launches['K5 step']} step, "
          f"{launches['K5 warm-up']} warm-up) in {INT_HORIZON} policy steps and the first "
          f"reset, K4 and straight kernels {others}; obs checksum {float(obs_sum):.6f}; "
          f"episodes ended {int(ended)}, by a crash {int(crashed)}, by arriving "
          f"{int(arrived)}, of {INT_HORIZON * B} env-steps")
    if (k5.launches != 2 * INT_HORIZON + 1 or launches["K5 step"] != INT_HORIZON
            or launches["K5 warm-up"] != INT_HORIZON + 1 or any(others)):
        raise AssertionError("intersection-v0: K5 must launch twice per policy step and "
                             "once for the first reset, alone")
    if not bool(finite):
        raise AssertionError("intersection-v0: non-finite obs, reward or state")
    if not int(ended) > 0:
        raise AssertionError("intersection-v0: no episode ended")

    # the raw-control paths: the racetrack family through K4, and highway-v0
    # under a ContinuousAction through K2a, K3, K2b and masked K1
    racers = {}
    for env_id, config in RACETRACKS:
        e = renv if env_id == "racetrack-v0" else ht.make(env_id, config)
        racers[env_id] = e
        print(f"== 4. raw-control path: make('{env_id}'{', ' + str(config) if config else ''})"
              f" on CUDA, B={B}, V={e.num_slots}, reset and {HORIZON} random-policy "
              "(U(-1, 1) steering) autoreset steps through K4")
        gen = e.generator(SEED + 1)
        _, rst = e.reset(B, gen)
        for k in (k1, k2a, k3, k2b, k4, k5):
            k.launches = 0
        rst, rm = rollout(e, rst, HORIZON, gen)
        torch.cuda.synchronize()
        others = (k1.launches, k2a.launches, k3.launches, k2b.launches, k5.launches)
        rm = {k: float(v) for k, v in rm.items()}
        print(f"  launches: K4 {k4.launches} in {HORIZON} policy steps, other kernels "
              f"{others}; rollout {rm}")
        if k4.launches != HORIZON or any(others):
            raise AssertionError(f"{env_id}: K4 must launch once per policy step, alone")
        if not all(np.isfinite(list(rm.values()))) or not rm["done_rate"] > 0:
            raise AssertionError(f"{env_id}: non-finite metrics or no episode ended")
        for k in ("pos", "speed", "heading", "steering"):
            if not bool(torch.isfinite(getattr(rst.vehicles, k)).all()):
                raise AssertionError(f"{env_id}: non-finite {k}")
        if env_id == "racetrack-v0":
            launches["K4 raw"] = k4.launches
    print(f"== 4. raw-control path: make('highway-v0', {CONTINUOUS_CONFIG}) on CUDA, "
          f"B={B}, {HORIZON} random-policy (U(-1, 1)) autoreset steps, sorted step")
    gen = cenv.generator(SEED + 1)
    _, cst = cenv.reset(B, gen)
    for k in (k1, k2a, k3, k2b, k4, k5):
        k.launches = 0
    cst, cm = rollout(cenv, cst, HORIZON, gen)
    torch.cuda.synchronize()
    counts = {"K1": k1.launches, "K2a": k2a.launches, "K3": k3.launches, "K2b": k2b.launches}
    cm = {k: float(v) for k, v in cm.items()}
    print(f"  launches: {counts}, K4 and K5 {(k4.launches, k5.launches)}; rollout {cm}")
    if any(n != HORIZON for n in counts.values()) or k4.launches or k5.launches:
        raise AssertionError("highway-v0 ContinuousAction: the sorted kernels must "
                             "launch once per policy step, alone")
    if not all(np.isfinite(list(cm.values()))):
        raise AssertionError("highway-v0 ContinuousAction: non-finite metrics")
    launches["K1 raw"], launches["K3 raw"] = counts["K1"], counts["K3"]

    # the Linear slice's paths, each driven with the counts set to 0 just
    # before it: highway-v0 under LinearVehicle through the sorted step (the
    # slice's main path), roundabout-v0 under AggressiveVehicle through K4,
    # and intersection-v0 under DefensiveVehicle and under a
    # ContinuousAction through K5 (reset and steps: each step's launch and
    # the warm-up of the reset drawn every step)
    print(f"== 4. Linear main path: make('highway-v0', {LINEAR_CONFIG}) on CUDA, B={B}, "
          f"reset and {HORIZON} random-policy autoreset steps, sorted step")
    gen = lenv.generator(SEED + 1)
    for k in (k1, k2a, k3, k2b, k4, k5):
        k.launches = 0
    _, lst = lenv.reset(B, gen)
    lst, lm = rollout(lenv, lst, HORIZON, gen)
    torch.cuda.synchronize()
    counts = {"K1": k1.launches, "K2a": k2a.launches, "K3": k3.launches, "K2b": k2b.launches}
    lm = {k: float(v) for k, v in lm.items()}
    lin_rows = int((lst.vehicles.kind == KIND_LINEAR).sum())
    print(f"  launches: {counts}, K4 and K5 {(k4.launches, k5.launches)}; rollout {lm}; "
          f"Linear rows at the end {lin_rows} of {B * lenv.num_slots} slots")
    if any(n != HORIZON for n in counts.values()) or k4.launches or k5.launches:
        raise AssertionError("highway-v0 LinearVehicle: the sorted kernels must launch once "
                             "per policy step, alone")
    if not all(np.isfinite(list(lm.values()))) or not lm["done_rate"] > 0 or not lin_rows:
        raise AssertionError("highway-v0 LinearVehicle: non-finite metrics, no episode "
                             "ended or no Linear row")
    for k in ("pos", "speed", "heading", "steering", "accel"):
        if not bool(torch.isfinite(getattr(lst.vehicles, k)).all()):
            raise AssertionError(f"highway-v0 LinearVehicle: non-finite {k}")
    launches["K1 linear"], launches["K3 linear"] = counts["K1"], counts["K3"]
    print(f"== 4. Linear path: make('roundabout-v0', {AGGRESSIVE_CONFIG}) on CUDA, B={B}, "
          f"reset and {HORIZON} random-policy autoreset steps through K4")
    gen = aenv.generator(SEED + 1)
    for k in (k1, k2a, k3, k2b, k4, k5):
        k.launches = 0
    _, ast_ = aenv.reset(B, gen)
    ast_, am = rollout(aenv, ast_, HORIZON, gen)
    torch.cuda.synchronize()
    others = (k1.launches, k2a.launches, k3.launches, k2b.launches, k5.launches)
    am = {k: float(v) for k, v in am.items()}
    print(f"  launches: K4 {k4.launches} in {HORIZON} policy steps, other kernels {others}; "
          f"rollout {am}")
    if k4.launches != HORIZON or any(others):
        raise AssertionError("roundabout-v0 AggressiveVehicle: K4 must launch once per "
                             "policy step, alone")
    if not all(np.isfinite(list(am.values()))) or not am["done_rate"] > 0:
        raise AssertionError("roundabout-v0 AggressiveVehicle: non-finite metrics or no "
                             "episode ended")
    launches["K4 linear"] = k4.launches
    for key, xenv in k5_envs.items():
        what = "DefensiveVehicle" if key == "K5 linear" else "ContinuousAction"
        print(f"== 4. {'Linear' if key == 'K5 linear' else 'raw-control'} path: "
              f"make('intersection-v0', {what}) on CUDA, B={B}, reset and {HORIZON} "
              "random-policy autoreset steps through K5")
        gen = xenv.generator(SEED + 1)
        recorder = FrameRecorder(k5)
        gf.frames_regulated_kernel = recorder
        try:
            for k in (k1, k2a, k3, k2b, k4, k5):
                k.launches = 0
            _, xst = xenv.reset(B, gen)
            xst, xm = rollout(xenv, xst, HORIZON, gen)
            torch.cuda.synchronize()
        finally:
            gf.frames_regulated_kernel = k5
        step_n = sum(f == xenv.frames_per_step for f in recorder.frames)
        warm_n = sum(f == xenv._warmup_frames for f in recorder.frames)
        others = (k1.launches, k2a.launches, k3.launches, k2b.launches, k4.launches)
        xm = {k: float(v) for k, v in xm.items()}
        print(f"  launches: K5 {k5.launches} ({step_n} step, {warm_n} warm-up) in {HORIZON} "
              f"policy steps and the first reset, other kernels {others}; rollout {xm}")
        if (k5.launches != 2 * HORIZON + 1 or step_n != HORIZON or warm_n != HORIZON + 1
                or any(others)):
            raise AssertionError(f"intersection-v0 {what}: K5 must launch twice per policy "
                                 "step and once for the first reset, alone")
        if not all(np.isfinite(list(xm.values()))) or not xm["done_rate"] > 0:
            raise AssertionError(f"intersection-v0 {what}: non-finite metrics or no episode "
                                 "ended")
        launches[key] = step_n

    # the slice's paths, each with the counts set to 0 just before it; then
    # the parking family's, every 8th ego crashed at the start
    all_kernels = {"K1": k1, "K2a": k2a, "K3": k3, "K2b": k2b, "K4": k4, "K5": k5}
    print(f"  [the main, raw-control and Linear paths driven at {time.time() - start:.0f} s]")
    drive_slice(slice_envs, all_kernels, launches)
    drive_slice(parking_envs, all_kernels, launches, crash_first=True)
    # the connected-lane search's paths and the two-ego intersection (PR 12)
    k4c, k5c = gf.frames_general_connected_kernel, gf.frames_regulated_connected_kernel
    k4d, k5d = gf.frames_general_dynamical_kernel, gf.frames_regulated_dynamical_kernel
    conn_kernels = {**all_kernels, "K4 connected": k4c, "K5 connected": k5c,
                    "K4 dynamical": k4d, "K5 dynamical": k5d}
    drive_general_paths(gf, {env_id: conn_envs[env_id][0] if env_id in conn_envs
                             else ht.make(env_id)
                             for env_id in CONNECTED_ROLLOUTS + CONNECTED_OTHERS},
                        conn_kernels, launches, CONNECTED_ROLLOUTS, CONNECTED_OTHERS)
    launches["K4 connected"] = launches["K4 connected roundabout-v1"]
    launches["K5 connected"] = launches["K5 connected intersection-v2"]
    # the dynamical paths: intersection-v1 through K5's kDynamical
    # instantiation (its step and the warm-up of its resets: the warm-up has
    # no ego row, and the env's spec sends it there too), lane-keeping-v0
    # through K4's
    drive_general_paths(gf, {env_id: dyn_envs[env_id][0] for env_id in DYNAMICAL_IDS},
                        conn_kernels, launches, DYNAMICAL_IDS)
    launches["K5 dynamical"] = launches["K5 dynamical intersection-v1"]
    launches["K4 dynamical"] = launches["K4 dynamical lane-keeping-v0"]
    # a dynamical action under the connected-lane search: the
    # slice's path at full width, intersection-v2 through the narrow
    # connected dynamical K5 (its step and its resets' warm-up) and
    # racetrack-v1 through the K4 of the same law
    drive_general_paths(gf, {env_id: ht.make(env_id, DYNAMICAL) for env_id in CONN_DYN_PATHS},
                        {**conn_kernels, **layout_kernels(gf, "")}, launches, CONN_DYN_PATHS)
    for env_id in CONN_DYN_PATHS:
        key = f"{'K5' if env_id.startswith('intersection') else 'K4'} connected dynamical"
        launches[key] = launches.pop(f"{key} {env_id}")
    # several ego rows: highway-v0 with two egos through the sorted
    # step, and the four K4 configs, every 8th first ego crashed at the start
    drive_several_straight(e2env, all_kernels, launches)
    drive_slice(several_envs, all_kernels, launches, crash_first=True)
    print(f"  [the slice, connected, dynamical and several-ego paths driven at "
          f"{time.time() - start:.0f} s]")


    # the rollouts again, each step one replay of a CapturedStep
    straight_names = ("straight_frames_kernel", "sort_kernel",
                      "straight_frames_sorted_kernel", "unsort_kernel")
    straight_kernels = {"K1": k1, "K2a": k2a, "K3": k3, "K2b": k2b}
    path_kernels = (
        ("highway-v0", env, straight_kernels, straight_names),
        ("roundabout-v0", genv, {"K4": k4}, ("general_frames_kernel<false,",)),
        ("intersection-v0", ienv, {"K5": k5}, ("general_frames_kernel<true,",)),
    ) + tuple((env_id, e, {"K4": k4}, ("general_frames_kernel<false,",))
              for env_id, e in racers.items()) + (
        ("highway-v0 ContinuousAction", cenv, straight_kernels, straight_names),
        ("highway-v0 LinearVehicle", lenv, straight_kernels, straight_names),
    ) + tuple((env_id, e, {"K4": k4}, ("general_frames_kernel<false,",))
              for env_id, (e, _) in {**slice_envs, **parking_envs}.items())
    for label, e, path, names in path_kernels:
        print(f"== 4. graph path: {label} on CUDA, B={B}, {HORIZON} random-policy "
              f"autoreset steps, each one replay of a CapturedStep [at {time.time() - start:.0f} s]")
        gen = e.generator(SEED + 3)
        _, gst = e.reset(B, gen)
        if label in PARKING_ENVS:
            gst = crashed_every(e, gst)
        for k in (k1, k2a, k3, k2b, k4, k5):
            k.launches = 0
        gst, gm = rollout(e, gst, HORIZON, gen, graph=True)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in path.items()}
        others = sum(k.launches for k in (k1, k2a, k3, k2b, k4, k5)) - sum(counts.values())
        gm = {k: float(v) for k, v in gm.items()}
        print(f"  launches counted in Python (the warm-up step and the capture; a replay "
              f"counts none): {counts}, other kernels {others}; rollout {gm}")
        if min(counts.values()) < 1 or others:
            raise AssertionError(f"{label} graph path: its kernels were not captured alone")
        if not all(np.isfinite(list(gm.values()))) or not gm["done_rate"] > 0:
            raise AssertionError(f"{label} graph path: non-finite metrics or no episode ended")
        for k in ("pos", "speed", "heading"):
            if not bool(torch.isfinite(getattr(gst.vehicles, k)).all()):
                raise AssertionError(f"{label} graph path: non-finite {k}")
        every = {"K1": k1, "K2a": k2a, "K3": k3, "K2b": k2b, "K4": k4, "K5": k5}
        prof = profile_replays(e, gst, gen, names, every)
        counted = {n: c for n, c in prof["counted"].items() if c}
        print(f"  profile of {PROFILE_REPLAYS} replays: {prof['kernels']:.1f} device kernels "
              f"and {prof['busy_ms']:.4f} ms device busy per replay; the port's kernels per "
              f"replay {prof['ours']}; counted by the wrappers over the capture {counted}")
        want = {"intersection-v0": 2.0}.get(label, 1.0)  # K5: step and reset warm-up
        if counted != {name: want for name in path}:
            raise AssertionError(f"{label}: a capture launched {counted}, expected {want} of "
                                 f"each of {list(path)}")
        if prof["kernels"] > 0 and any(prof["ours"].get(n, 0.0) != want for n in names):
            raise AssertionError(f"{label}: a replay launched {prof['ours']}, expected "
                                 f"{want} of each of {names}")

    print(f"(phases 1-4: {time.time() - start:.0f} s)")
    print(f"== 5. times on {card}")
    gen = env.generator(SEED + 2)
    _, states = env.reset(B, gen)
    slot_actions = env._action_to_slots(torch.ones(B, dtype=torch.int32, device=env.device))
    veh = env.action_type.apply(env.geo, states.vehicles, states.vehicles.kind == 1,
                                slot_actions)
    # the masked K1 rows below write into the unsorted output of the banded
    # frames
    srt, idx = ss.sort_plain(veh, fs)
    band, _ = ss.frames_sorted_plain(srt, idx, fs, p, dt, frames)
    back = ss.unsort_plain(band, idx, veh)
    none = torch.zeros(B, dtype=torch.bool, device=env.device)
    rows = {}

    def timed(label, kernel_fn, plain_fn, library_fn, reps, plain_reps):
        """(kernel ms, plain ms, library device ms or None): the kernel's
        time between CUDA events around launches queued behind a
        device-side wait, printed with the wall time of one call; the
        plain version's between CUDA events around ``plain_reps`` runs (no
        warm-up: phase 3 ran it at these shapes), the host's gaps between
        its kernels included
        (as ``frame_row`` takes it: the profiler's device sum took 10 to
        30 s to gather over a K5 plain run's 40,000 to 120,000 kernels)."""
        ms = queued_ms(kernel_fn, reps)
        wall = cuda_ms(kernel_fn, reps)
        plain_ms = cuda_ms(plain_fn, plain_reps, warmup=False)
        lib_ms = None if library_fn is None else device_ms(library_fn, plain_reps)
        print(f"  {label}: {ms:.4f} ms between CUDA events behind a device-side wait "
              f"({wall:.4f} ms a call between CUDA events); plain {plain_ms:.4f} ms "
              "between CUDA events" + ("" if lib_ms is None else
                                       f"; yardstick {lib_ms:.4f} ms on the device")
              + f" [at {time.time() - start:.0f} s]")
        return ms, plain_ms, lib_ms

    straight_rows(env, states, timed, rows)

    # K4 at roundabout-v0 from a fresh reset, random actions
    gspec, gframes = genv._general, genv.frames_per_step
    _, g0 = genv.reset(B, genv.generator(SEED + 2))
    gveh = g0.vehicles
    gsa = genv._action_to_slots(random_actions(genv, B, gen))
    ms, plain_ms, _ = timed(
        "K4 general_frames (roundabout-v0), per policy step",
        lambda: k4(gveh, gspec, gsa, gframes, linear=False),
        lambda: gf.frames_general_plain(gveh, gspec, gsa, gframes), None, 20, PLAIN_REPS,
    )
    ops, n_bytes = k4_work(gf, genv, gveh, gsa)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K4"] = ("general_frames", "highwayenv_tpu_torch/csrc/general_frames.cu",
                  "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by, None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.5f} ms)")

    # K5 at intersection-v0 from a fresh reset, the tick phases spread over
    # all 7 values, random actions; and its warm-up launch
    _, i0 = ienv.reset(B, ienv.generator(SEED + 2))
    k5_scenes = regulated_scenes(ienv, i0, gen)
    for key, scene, label in (("K5 step", "reset", "per policy step"),
                              ("K5 warm-up", "warm-up", "per reset warm-up")):
        iveh, isteps, isa, iframes = k5_scenes[scene]
        if scene == "reset":
            isteps = isteps + torch.arange(B, device=ienv.device, dtype=torch.int32) * 15
        ms, plain_ms, _ = timed(
            f"K5 general_frames_regulated (intersection-v0), {label}",
            lambda: k5(iveh, ispec, isa, iframes, isteps, linear=False),
            lambda: gf.frames_general_plain(iveh, ispec, isa, iframes, isteps), None, 20, PLAIN_REPS,
        )
        ops, out = regulated_ops(iveh, ispec, isa, iframes, isteps)
        R = iveh.route_base.shape[-1]
        lf, li = gf.lane_tables(ispec.geo, ienv.device)
        n_bytes = (read_bytes(iveh, gf._resolve(gf._IN_FIELDS, R) + gf.REG_FIELDS)
                   + isa.numel() * 4 + B * 4
                   + field_bytes(out, gf._resolve(gf.OUT_FIELDS, R) + gf.REG_FIELDS)
                   + lf.numel() * 4 + li.numel() * 4)
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[key] = (f"general_frames_regulated ({scene.replace('reset', 'step')})",
                     "highwayenv_tpu_torch/csrc/general_frames.cu",
                     "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                     None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms)")

    # the raw-control branches: K4 at racetrack-v0 from a fresh reset, and
    # K3 and K1 at highway-v0 under a ContinuousAction, random actions; the
    # bounds drop the egos' P-cascade, which these launches do not run
    rspec, rframes = renv._general, renv.frames_per_step
    _, r0 = renv.reset(B, renv.generator(SEED + 2))
    rveh = r0.vehicles
    # the action stored on the egos first, as the env path does: the launch
    # reads no slot actions, and its bytes count none
    rsa = renv._action_to_slots(random_actions(renv, B, gen))
    rveh, _, _ = gf.store_raw_controls(renv, rveh, rsa)
    ms, plain_ms, _ = timed(
        "K4 general_frames, raw controls (racetrack-v0, V=2), per policy step",
        lambda: k4(rveh, rspec, None, rframes, raw=True, linear=False),
        lambda: gf.frames_general_plain(rveh, rspec, None, rframes, raw=True), None, 20, PLAIN_REPS,
    )
    ops, v = 0.0, rveh
    table = lane_ops.projection_table(rspec.geo, v.pos)
    for f in range(rframes):
        out, next_table = gf.frame_general_plain(v, rspec, table, None, raw=True)
        ops += gen_frame_ops(v, out, rspec, table, raw=True)
        v, table = out, next_table
    lf, li = gf.lane_tables(rspec.geo, renv.device)
    n_bytes = (read_bytes(rveh, gf._resolve(gf._IN_FIELDS, 1))
               + field_bytes(v, gf._resolve(gf.OUT_FIELDS, 1))
               + lf.numel() * 4 + li.numel() * 4)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K4 raw"] = ("general_frames (racetrack-v0, raw controls)",
                      "highwayenv_tpu_torch/csrc/general_frames.cu",
                      "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                      None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.5f} ms)")
    _, c0 = cenv.reset(B, cenv.generator(SEED + 2))
    cveh = cenv.action_type.apply(
        cenv.geo, c0.vehicles, c0.vehicles.kind == 1,
        cenv._action_to_slots(random_actions(cenv, B, gen)))
    csrt, cidx = ss.sort_plain(cveh, fs)
    ms, plain_ms, _ = timed(
        "K3 straight_frames_sorted, raw controls (highway-v0 ContinuousAction), per step",
        lambda: k3(csrt, cidx, fs, p, dt, frames, raw=True, linear=False),
        lambda: ss.frames_sorted_plain(csrt, cidx, fs, p, dt, frames, True), None, 20, PLAIN_REPS,
    )
    ops, v = 0.0, csrt
    for _ in range(frames):
        out, _ = ss.frames_sorted_plain(v, cidx, fs, p, dt, 1, True)
        ops += sorted_frame_ops(v, out, fs, p, dt, raw=True)
        v = out
    n_bytes = (read_bytes(csrt, sf._IN_FIELDS) + field_bytes(v, sf._OUT_FIELDS)
               + cidx.numel() * 4 + B * 2)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K3 raw"] = ("straight_frames_sorted (highway-v0 ContinuousAction, raw controls)",
                      "highwayenv_tpu_torch/csrc/straight_frames_sorted.cu",
                      "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms, by,
                      None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.4f} ms)")
    ms, plain_ms, _ = timed(
        "K1 straight_frames, raw controls (highway-v0 ContinuousAction), every env, per step",
        lambda: k1(cveh, fs, p, dt, frames, raw=True, linear=False),
        lambda: sf.frames_plain(cveh, fs, p, dt, frames, True), None, 20, PLAIN_REPS,
    )
    ops, v = 0.0, cveh
    for _ in range(frames):
        out = sf.frames_plain(v, fs, p, dt, 1, True)
        ops += frame_ops(v, out, fs, p, dt, raw=True)
        v = out
    n_bytes = read_bytes(cveh, sf._IN_FIELDS) + field_bytes(cveh, sf._OUT_FIELDS)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K1 raw"] = ("straight_frames (highway-v0 ContinuousAction, raw controls)",
                      "highwayenv_tpu_torch/csrc/straight_frames.cu",
                      "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms, by,
                      None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.4f} ms)")

    # the Linear rows' branches: K3 and K1 at highway-v0 under LinearVehicle,
    # K4 at roundabout-v0 under AggressiveVehicle, K5's step at
    # intersection-v0 under DefensiveVehicle, from fresh resets with random
    # actions; and K5's raw-control branch at intersection-v0 under a
    # ContinuousAction (the action stored on the egos first); the bounds
    # count the linear laws' operations and the parameter fields' bytes on
    # the Linear rows
    _, l0 = lenv.reset(B, lenv.generator(SEED + 2))
    lveh = lenv.action_type.apply(
        lenv.geo, l0.vehicles, l0.vehicles.kind == 1,
        lenv._action_to_slots(random_actions(lenv, B, gen)))
    lsrt, lidx = ss.sort_plain(lveh, fs)
    ms, plain_ms, _ = timed(
        "K3 straight_frames_sorted, Linear rows (highway-v0 LinearVehicle), per step",
        lambda: k3(lsrt, lidx, fs, p, dt, frames, linear=True),
        lambda: ss.frames_sorted_plain(lsrt, lidx, fs, p, dt, frames), None, 20, PLAIN_REPS,
    )
    ops, v = 0.0, lsrt
    for _ in range(frames):
        out, _ = ss.frames_sorted_plain(v, lidx, fs, p, dt, 1)
        ops += sorted_frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = (read_bytes(lsrt, sf._IN_FIELDS) + field_bytes(v, sf._OUT_FIELDS)
               + lidx.numel() * 4 + B * 2)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K3 linear"] = ("straight_frames_sorted (highway-v0 LinearVehicle, Linear rows)",
                         "highwayenv_tpu_torch/csrc/straight_frames_sorted.cu",
                         "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms,
                         by, None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.4f} ms); Linear rows "
          f"{int((lveh.kind == KIND_LINEAR).sum())}")
    ms, plain_ms, _ = timed(
        "K1 straight_frames, Linear rows (highway-v0 LinearVehicle), every env, per step",
        lambda: k1(lveh, fs, p, dt, frames, linear=True),
        lambda: sf.frames_plain(lveh, fs, p, dt, frames), None, 20, PLAIN_REPS,
    )
    masked_ms = queued_ms(lambda: k1(lveh, fs, p, dt, frames, mask=none, out=back,
                                   linear=True), 50)
    ops, v = 0.0, lveh
    for _ in range(frames):
        out = sf.frames_plain(v, fs, p, dt, 1)
        ops += frame_ops(v, out, fs, p, dt)
        v = out
    n_bytes = read_bytes(lveh, sf._IN_FIELDS) + field_bytes(lveh, sf._OUT_FIELDS)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K1 linear"] = ("straight_frames (highway-v0 LinearVehicle, Linear rows)",
                         "highwayenv_tpu_torch/csrc/straight_frames.cu",
                         "highwayenv_tpu/ops/straight_pallas_bm.py:1190", ms, plain_ms, bms,
                         by, None)
    print(f"    masked with no env firing: {masked_ms:.4f} ms queued; bound {bms:.4f} ms by "
          f"{by} ({ops:.3e} fp32 ops -> {t_ops:.4f} ms, {n_bytes} bytes -> {t_bytes:.4f} ms)")
    aspec = aenv._general
    _, a0 = aenv.reset(B, aenv.generator(SEED + 2))
    aveh = a0.vehicles
    asa = aenv._action_to_slots(random_actions(aenv, B, gen))
    ms, plain_ms, _ = timed(
        "K4 general_frames, Linear rows (roundabout-v0 AggressiveVehicle), per policy step",
        lambda: k4(aveh, aspec, asa, gframes, linear=True),
        lambda: gf.frames_general_plain(aveh, aspec, asa, gframes), None, 20, PLAIN_REPS,
    )
    ops, n_bytes = k4_work(gf, aenv, aveh, asa)
    bms, by, t_ops, t_bytes = bound(ops, n_bytes)
    rows["K4 linear"] = ("general_frames (roundabout-v0 AggressiveVehicle, Linear rows)",
                         "highwayenv_tpu_torch/csrc/general_frames.cu",
                         "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                         None)
    print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
          f"{n_bytes} bytes -> {t_bytes:.5f} ms)")
    # K4 at the slice's envs with a row of their own, from fresh resets with
    # random actions
    for env_id in SLICE_ROWS:
        e = slice_envs[env_id][0]
        _, s0 = e.reset(B, e.generator(SEED + 2))
        sveh, sspec, sframes = s0.vehicles, e._general, e.frames_per_step
        ssa = e._action_to_slots(random_actions(e, B, gen))
        what = f"{env_id}, V={e.num_slots}, group {group_size(e.num_slots)}"
        # the timed launch's own output against the plain frames that count
        # its operations
        out_k = k4(sveh, sspec, ssa, sframes, linear=False)
        ops, n_bytes, out_p = k4_work(gf, e, sveh, ssa, with_state=True)
        torch.cuda.synchronize()
        err[f"K4 {env_id}"] = max(err[f"K4 {env_id}"],
                                  compare_general(out_k, out_p, f"{env_id} timed inputs"))
        ms, plain_ms, _ = timed(
            f"K4 general_frames ({what}), per policy step",
            lambda: k4(sveh, sspec, ssa, sframes, linear=False),
            lambda: gf.frames_general_plain(sveh, sspec, ssa, sframes), None, 20, PLAIN_REPS,
        )
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[f"K4 {env_id}"] = (f"general_frames ({what})",
                                "highwayenv_tpu_torch/csrc/general_frames.cu",
                                "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms,
                                bms, by, None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms)")
    # K4's raw-control branch at the parking family, 14 lanes an edge, and
    # with several egos, from fresh resets with random actions
    # stored on the egos first
    for env_id, (e, _) in {**parking_envs,
                           **{k: several_envs[k] for k in SEVERAL_ROWS}}.items():
        _, s0 = e.reset(B, e.generator(SEED + 2))
        sspec, sframes = e._general, e.frames_per_step
        sveh, _, _ = gf.store_raw_controls(
            e, s0.vehicles, e._action_to_slots(random_actions(e, B, gen)))
        what = f"{env_id}, raw controls, V={e.num_slots}, group {group_size(e.num_slots)}"
        # the timed launch's own output against the plain frames that count
        # its operations
        out_k = k4(sveh, sspec, None, sframes, raw=True, linear=False)
        ops, n_bytes, out_p = k4_work(gf, e, sveh, None, with_state=True)
        torch.cuda.synchronize()
        err[f"K4 {env_id}"] = max(err[f"K4 {env_id}"],
                                  compare_general(out_k, out_p, f"{env_id} timed inputs"))
        ms, plain_ms, _ = timed(
            f"K4 general_frames ({what}), per policy step",
            lambda: k4(sveh, sspec, None, sframes, raw=True, linear=False),
            lambda: gf.frames_general_plain(sveh, sspec, None, sframes, raw=True), None, 20, PLAIN_REPS,
        )
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[f"K4 {env_id}"] = (f"general_frames ({what})",
                                "highwayenv_tpu_torch/csrc/general_frames.cu",
                                "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms,
                                bms, by, None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms)")
    for key, xenv in k5_envs.items():
        what = "DefensiveVehicle, Linear rows" if key == "K5 linear" else (
            "ContinuousAction, raw controls")
        xspec = xenv._general
        _, x0 = xenv.reset(B, xenv.generator(SEED + 2))
        xsteps = x0.steps + torch.arange(B, device=xenv.device, dtype=torch.int32) * 15
        xsa = xenv._action_to_slots(random_actions(xenv, B, gen))
        xveh, xsa, raw = gf.store_raw_controls(xenv, x0.vehicles, xsa)
        ms, plain_ms, _ = timed(
            f"K5 general_frames_regulated (intersection-v0 {what}), per policy step",
            lambda: k5(xveh, xspec, xsa, xenv.frames_per_step, xsteps, raw=raw,
                       linear=xenv.linear_rows),
            lambda: gf.frames_general_plain(xveh, xspec, xsa, xenv.frames_per_step, xsteps,
                                            raw=raw), None, 20, PLAIN_REPS,
        )
        ops, v = 0.0, xveh
        phase = torch.remainder(xsteps, xspec.period)
        table = lane_ops.projection_table(xspec.geo, v.pos)
        for f in range(xenv.frames_per_step):
            tick = torch.remainder(phase + (f + 1), xspec.period) == 0
            out, next_table = gf.frame_general_plain(v, xspec, table, xsa if f == 0 else None,
                                                     tick, raw=raw)
            ops += gen_frame_ops(v, out, xspec, table, raw=raw)
            if bool(tick.any()):
                ops += reg_tick_ops(v, xspec, tick)
            v, table = out, next_table
        R = xveh.route_base.shape[-1]
        lf, li = gf.lane_tables(xspec.geo, xenv.device)
        n_bytes = (read_bytes(xveh, gf._resolve(gf._IN_FIELDS, R) + gf.REG_FIELDS)
                   + (0 if raw else xsa.numel() * 4) + B * 4
                   + field_bytes(v, gf._resolve(gf.OUT_FIELDS, R) + gf.REG_FIELDS)
                   + lf.numel() * 4 + li.numel() * 4)
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[key] = (f"general_frames_regulated (intersection-v0 {what})",
                     "highwayenv_tpu_torch/csrc/general_frames.cu",
                     "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                     None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms)")

    # the connected K4 at roundabout-v1 and K5 at intersection-v2 from fresh
    # resets with random actions (K5: the tick phases spread over all 7
    # values), each beside the v0 instantiation on the same scene under the
    # v0 spec (roundabout-v0, intersection-v0)
    for key, env_id, v0_id in (("K4 connected", "roundabout-v1", "roundabout-v0"),
                               ("K5 connected", "intersection-v2", "intersection-v0")):
        e = conn_envs[env_id][0]
        spec, v0_spec, frames = e._general, ht.make(v0_id)._general, e.frames_per_step
        _, s0 = e.reset(B, e.generator(SEED + 2))
        sveh = s0.vehicles
        ssa = e._action_to_slots(random_actions(e, B, gen))
        if e.regulated:
            steps0 = s0.steps + torch.arange(B, device=e.device, dtype=torch.int32) * 15
            args, v0_args = (sveh, spec, ssa, frames, steps0), (sveh, v0_spec, ssa, frames, steps0)
            kernel, v0_kernel = k5c, k5
            plain = lambda: gf.frames_general_plain(sveh, spec, ssa, frames, steps0)  # noqa: E731
            ops, n_bytes, out_p = k5_work(gf, e, sveh, ssa, steps0, frames, with_state=True)
        else:
            args, v0_args = (sveh, spec, ssa, frames), (sveh, v0_spec, ssa, frames)
            kernel, v0_kernel = k4c, k4
            plain = lambda: gf.frames_general_plain(sveh, spec, ssa, frames)  # noqa: E731
            ops, n_bytes, out_p = k4_work(gf, e, sveh, ssa, with_state=True)
        out_k = kernel(*args, linear=False)
        torch.cuda.synchronize()
        err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} timed inputs"))
        what = f"{env_id}, V={e.num_slots}, group {group_size(e.num_slots)}"
        ms, plain_ms, _ = timed(f"{key} ({what}), per policy step",
                                lambda: kernel(*args, linear=False), plain, None, 20, PLAIN_REPS)
        v0_ms = queued_ms(lambda: v0_kernel(*v0_args, linear=False), 20)
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[key] = (f"{'general_frames_regulated' if e.regulated else 'general_frames'}"
                     f"_connected ({env_id})", "highwayenv_tpu_torch/csrc/general_frames.cu",
                     "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                     None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms); the v0 instantiation on the same "
              f"scene under {v0_id}'s spec: {v0_ms:.4f} ms queued; connected / v0 "
              f"{ms / v0_ms:.3f}")
    # the dynamical K5 at intersection-v1 and K4 at lane-keeping-v0
    # from fresh resets with random actions stored on the egos (K5: the tick
    # phases spread over all 7 values), each beside the v0 instantiation's
    # raw branch on the same scene under the spec without the flag
    for key, env_id in (("K5 dynamical", "intersection-v1"), ("K4 dynamical", "lane-keeping-v0")):
        e = dyn_envs[env_id][0]
        dspec, dframes = e._general, e.frames_per_step
        v0_spec = dspec._replace(dynamical=False)
        _, s0 = e.reset(B, e.generator(SEED + 2))
        sveh, _, _ = gf.store_raw_controls(
            e, s0.vehicles, e._action_to_slots(random_actions(e, B, gen)))
        extra = ((s0.steps + torch.arange(B, device=e.device, dtype=torch.int32) * 15,)
                 if e.regulated else ())
        kernel = gf.frames_kernel_for(dspec, e.regulated)
        v0_kernel = gf.frames_kernel_for(v0_spec, e.regulated)
        args = (sveh, dspec, None, dframes, *extra)
        v0_args = (sveh, v0_spec, None, dframes, *extra)

        def plain(args=args):
            return gf.frames_general_plain(*args, raw=True)

        out_k = kernel(*args, raw=True, linear=False)
        # the plain frames that count its operations
        ops, n_bytes, out_p = (
            k5_work(gf, e, sveh, None, extra[0], dframes, with_state=True) if e.regulated
            else k4_work(gf, e, sveh, None, with_state=True))
        torch.cuda.synchronize()
        err[key] = max(err[key], compare_general(out_k, out_p, f"{env_id} timed inputs"))
        what = f"{env_id}, V={e.num_slots}, group {group_size(e.num_slots)}, raw controls"
        ms, plain_ms, _ = timed(
            f"{key} ({what}), per policy step",
            lambda kernel=kernel, args=args: kernel(*args, raw=True, linear=False), plain,
            None, 20, PLAIN_REPS)
        v0_ms = queued_ms(lambda: v0_kernel(*v0_args, raw=True, linear=False), 20)
        bms, by, t_ops, t_bytes = bound(ops, n_bytes)
        rows[key] = (f"{'general_frames_regulated' if e.regulated else 'general_frames'}"
                     f"_dynamical ({env_id})", "highwayenv_tpu_torch/csrc/general_frames.cu",
                     "highwayenv_tpu/ops/general_pallas_bm.py:1474", ms, plain_ms, bms, by,
                     None)
        print(f"    bound {bms:.4f} ms by {by} ({ops:.3e} fp32 ops -> {t_ops:.5f} ms, "
              f"{n_bytes} bytes -> {t_bytes:.5f} ms); the v0 instantiation's raw branch on "
              f"the same scene without the flag: {v0_ms:.4f} ms queued; dynamical / v0 "
              f"{ms / v0_ms:.3f}")
    # several ego rows
    straight_rows(e2env, e2env.reset(B, e2env.generator(SEED + 2))[1], timed, rows,
                  " 2 egos")
    print(f"  [the kernel table done at {time.time() - start:.0f} s]")
    # the policy step's simulation, and the rollouts, in turns
    for which, sim in (("sorted", ss.simulate_bm_sorted), ("dense", sf.simulate_bm)):
        def call(sim=sim):
            return sim(env, states.vehicles, slot_actions, frames)

        print(f"  {which} simulation of one policy step (meta-action and frames): "
              f"{device_ms(call, 10):.4f} ms on the device, {cuda_ms(call, 10):.4f} ms "
              "between CUDA events")
    walls = {"sorted": [], "dense": []}
    for which in ("sorted", "dense", "dense", "sorted", "sorted", "dense"):
        e = env if which == "sorted" else dense_env
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(e, states, HORIZON, gen)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
    for which, ws in walls.items():
        for wall in ws:
            print(f"  {which} rollout: {HORIZON} steps x {B} envs in {wall:.4f} s = "
                  f"{HORIZON * B / wall:.1f} env-steps/s ({wall / HORIZON * 1e3:.4f} ms "
                  "per step)")
    print(f"  [the policy step's simulation and rollouts timed at {time.time() - start:.0f} s]")
    # (the step profiles of highway-v0 sorted and dense, roundabout-v0,
    # intersection-v0 and the racetracks, their rollouts three times and the
    # OccupancyGrid times are cut for the time limit; PERF.md keeps their
    # earlier numbers)

    # ms per step: eager against graph, full against compact, in turns
    from highwayenv_tpu_torch.parallel.graph import CapturedStep

    print(f"  ms per step of {TIMED_STEPS} random-policy autoreset steps at B={B}, "
          f"three runs each in turns, on {card}:")
    # (the compact P=1024 variants' timings, and racetrack-v0's and highway-v0
    # LinearVehicle's, are cut for the time limit; phase 3 still holds the
    # compact step to the full one and the captured step to the eager one)
    variants = (("eager full", None, False), ("graph full", None, True))
    for label, e in (("highway-v0", env), ("roundabout-v0", genv), ("intersection-v0", ienv)):
        print(f"  [{label} at {time.time() - start:.0f} s]")
        _, t0_states = e.reset(B, e.generator(SEED + 4))
        walls = {name: [] for name, _, _ in variants}
        for r in range(3):
            order = variants if r % 2 == 0 else variants[::-1]
            for name, P, graph in order:
                walls[name].append(timed_steps(e, t0_states, e.generator(SEED + 5), TIMED_STEPS,
                                               P, graph))
        for name, P, graph in variants:
            busy, n_kernels = step_device_ms(e, t0_states, e.generator(SEED + 5), P, graph)
            mid = sorted(walls[name])[1]
            print(f"  {label} {name}: " + ", ".join(f"{w:.4f}" for w in walls[name])
                  + f" ms per step ({B * 1e3 / mid:.1f} env-steps/s at the median); device "
                  f"busy {busy:.4f} ms per step, {100 * busy / mid:.1f}% of the median, "
                  f"{n_kernels:.1f} device kernels per step ({card})")
        # what the compact reset saves on the device: a reset's placement
        # at B rows and at P rows; and the host's time to issue one replay
        draws = e._reset_draws(B, e.generator(SEED + 6))
        part = {k: v[:1024] for k, v in draws.items()}
        place_b = device_ms(lambda: e._place_state(draws), 5)
        place_p = device_ms(lambda: e._place_state(part), 5)
        print(f"  {label} a reset's placement: {place_b:.4f} ms on the device at {B} rows, "
              f"{place_p:.4f} ms at 1024 rows")
        for name, P in (("full", None), ("compact P=1024", 1024)):
            cap = CapturedStep(e, t0_states, e.generator(SEED + 7), reset_slots=P)
            issue = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cap.graph.replay()
                issue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            print(f"  {label} graph {name}: the host issues a replay in "
                  f"{sorted(issue)[5]:.4f} ms (median of 10, from an idle queue)")

    # (the slice's, parking's, the connected and the dynamical ids' eager
    # against graph ms per step, their step profiles and head times are cut
    # for the time limit, ~104 s on a slow host, as ROADMAP's rules order
    # the cuts; PERF.md keeps their earlier numbers)

    # the captured full autoreset step against the eager one, and
    # eager against graph, at the several-ego configs and at highway-v0
    # under LidarObservation and the shuffled Kinematics order (whose
    # permutations the replays draw from the registered generator)
    pr15 = {"highway-v0 2 egos": e2env, **{k: e for k, (e, _) in several_envs.items()},
            "highway-v0 LidarObservation": ht.make("highway-v0", LIDAR_CONFIG),
            "highway-v0 shuffled": ht.make("highway-v0", SHUFFLED_CONFIG)}
    for label, e in pr15.items():
        print(f"  [{label} at {time.time() - start:.0f} s]")
        _, t0_states = e.reset(B, e.generator(SEED + 4))
        check_graph(e, t0_states, label + " ", variants=((None, False),))
        obs_ms = device_ms(lambda e=e, s=t0_states: e._observe(s, e.generator(SEED)), 5)
        print(f"  {label} observation ({type(e.observation_type).__name__}): {obs_ms:.4f} ms "
              "on the device")

    # GrayscaleObservation on the card (before phase 6: the profiles),
    # render_rgb of a CUDA state, and the reference's decision order
    gray = check_grayscale(ht, conn_kernels, launches, rows, err, card, start)
    print("== 4. render_rgb of a CUDA state against its CPU copy")
    check_render(ht, gray)
    print(f"== 4. sequential_decisions at {SEQ_IDS} on CUDA, B={SEQ_B} "
          f"[at {time.time() - start:.0f} s]")
    check_sequential(ht, conn_kernels, card)
    del gray
    t_rc = time.time()
    print(f"== 4. robust-control tools on CUDA: observer_step_batch, lpv_step, poly lanes, "
          f"set_route_at_intersection and MultipleModelTracker [at {time.time() - start:.0f} s]")
    check_robust_control(ht, ss, sf, gf, conn_kernels, card)
    print(f"  (robust-control block {time.time() - t_rc:.1f} s)")
    t_sh = time.time()
    print(f"== 4. sharded rollouts on CUDA: the mesh, an NCCL group of one, two shards on "
          f"the card, the pooled rollout [at {time.time() - start:.0f} s]")
    check_sharding(ht, ss, sf, gf, all_kernels, rows, err, launches, card)
    print(f"  (sharding block {time.time() - t_sh:.1f} s)")
    t_wide = time.time()
    print(f"== 4. scenes over the narrow kernels' limits on CUDA: the wide K4 / K5 and the "
          f"48-lane oval [at {time.time() - start:.0f} s]")
    check_wide(ht, gf, conn_kernels, rows, err, launches, card, start)
    print(f"  (wide block {time.time() - t_wide:.1f} s)")
    t_cluster = time.time()
    print(f"== 4. scenes over the wide kernels' 128 slots on CUDA: the cluster K4 / K5 "
          f"[at {time.time() - start:.0f} s]")
    check_cluster(ht, gf, conn_kernels, rows, err, launches, card, start)
    print(f"  (cluster block {time.time() - t_cluster:.1f} s)")
    t_cd = time.time()
    print(f"== 4. a dynamical action under the connected-lane search on CUDA: the connected "
          f"dynamical K4 / K5, narrow, wide and cluster [at {time.time() - start:.0f} s]")
    check_connected_dynamical(ht, gf, conn_kernels, rows, err, launches, card, start)
    print(f"  (connected dynamical block {time.time() - t_cd:.1f} s)")
    t_large = time.time()
    print(f"== 4. scenes over 1024 slots on CUDA: clusters of 9 to 16 blocks "
          f"[at {time.time() - start:.0f} s]")
    check_large_clusters(ht, gf, conn_kernels, rows, err, launches, card, start)
    print(f"  (large cluster block {time.time() - t_large:.1f} s)")
    t_global = time.time()
    print(f"== 4. scenes no layout of shared memory holds, on CUDA: the global K4 / K5, past a "
          f"block's 227 KB and past 2048 slots [at {time.time() - start:.0f} s]")
    check_global(ht, gf, conn_kernels, rows, err, launches, card, start)
    print(f"  (global block {time.time() - t_global:.1f} s)")
    t_sglobal = time.time()
    print(f"== 4. straight scenes one block cannot hold, on CUDA: the global K1, K2a, K3 and "
          f"K2b, past 1024 slots and past a block's 227 KB [at {time.time() - start:.0f} s]")
    check_straight_global(ht, ss, sf, rows, err, launches, card, start, timed)
    print(f"  (straight global block {time.time() - t_sglobal:.1f} s)")
    t_custom = time.time()
    print(f"== 4. roads the fixed tables refused, on CUDA: poly lanes, 5 successor edges, "
          f"an 18-slot route, 5 and 10 predecessor edges, 17 and 31 target speeds, 72 "
          f"general and 17 straight lanes; the kSized K4 / K5, narrow, wide and cluster "
          f"[at {time.time() - start:.0f} s]")
    check_custom_roads(ht, ss, sf, gf, conn_kernels, rows, err, launches, card, start, timed)
    print(f"  (custom roads block {time.time() - t_custom:.1f} s)")
    t_objects = time.time()
    print(f"== 4. obstacles, landmarks and plain Vehicle rows on a straight road, on CUDA: K1's "
          f"objects instantiations, make('highway-v0', lean=False) [at {time.time() - start:.0f} s]")
    check_objects(ht, ss, sf, rows, err, launches, card, start, timed)
    print(f"  (objects block {time.time() - t_objects:.1f} s)")

    # the single-env seeded path: every id at B=1, each with the counts set
    # to 0 just before it.  It runs last: after it, torch.profiler on the
    # H100 machine counts 3 to 7 fewer kernels a step (PERF.md §7), which
    # the graph paths' exact kernels-a-replay checks would take for a wrong
    # graph and which would shift phase 5's device counts
    t_single = time.time()
    print(f"== 6. single-env seeded path: every registered id on CUDA, B=1, seeded reset "
          f"and {SINGLE_STEPS} steps of step_batched, kernels against plain versions")
    single = drive_single_env(ht, ss, sf, gf, conn_kernels, card)
    print(f"  B=1 launches over the {len(ht.registered_ids())} ids: {single} "
          f"(single-env phase {time.time() - t_single:.1f} s)")

    print(f"(phases 1-6: {time.time() - start:.0f} s)")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[key],
        "max_abs_err": err[key],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": lib_ms,
    } for key, (name, source, replaces, ms, plain_ms, bms, by, lib_ms) in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
