"""Multi-device scaling: the env batch split by rows over cards and processes.

PyTorch counterpart of ``highwayenv_tpu/parallel/sharding.py``.  The JAX
package shards one batch over a 1-D device mesh and lets XLA run the step
SPMD; here a ``Mesh`` lists this process's devices, each local device holds
one shard (an ``EnvState`` of its rows) and its own env, and the rollouts
step every shard in turn, queueing step t on every shard before step t+1 on
any, so that the cards overlap.  Across processes the shards' metrics (and,
under ``fresh_pool``, their done counts) meet in one ``all_gather`` of
``torch.distributed``: NCCL when the shards are on CUDA, gloo when they are
on the CPU; a group of the other backend is refused, never worked around.

Layout.  A mesh has S = world size x local devices shards, every process
the same number of devices.  Global shard s = rank x local + i is local
shard i of process ``rank`` and holds the global rows [s B / S, (s + 1) B /
S) of a batch of B; a process holds only its own shards' rows.

Randomness.  The port has no per-env keys: each shard draws from its own
``torch.Generator`` (``shard_generators``), seeded from the seed and the
shard's global index.  A shard's draws, and so its results, depend on that
index, its rows and the seed, and not on how the shards are spread over
processes and cards (the layout-invariance check,
``tools/multiproc_rollout.py``).  A sharded run equals the unsharded one
shard by shard, not as a whole, where the JAX package's per-row keys make
the two bitwise equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from highwayenv_tpu_torch.envs.base import map_fields, map_obs, resolve_device
from highwayenv_tpu_torch.parallel.rollout import (
    PolicyStep,
    check_options,
    obs_sum,
    random_actions,
    take_scenes,
)

#: the seed of ``fresh_pool``'s pool generators (the JAX package folds
#: 0x5EED into the step key for its pool)
POOL_SEED = 0x5EED


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices, one shard each, in a mesh of ``world_size``
    processes with as many devices each.  ``distributed`` when a
    ``torch.distributed`` group joins the processes (even of one)."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    distributed: bool = False

    @property
    def local_shards(self) -> int:
        return len(self.devices)

    @property
    def num_shards(self) -> int:
        """S, the shards of the whole mesh."""
        return self.world_size * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's local shard 0."""
        return self.rank * len(self.devices)

    @property
    def collective_device(self) -> torch.device:
        """Where the collectives' tensors live: the first card under NCCL,
        the CPU under gloo."""
        return self.devices[0]


def default_devices() -> list[torch.device]:
    """Every visible CUDA device.  Raises without CUDA: CPU shards are
    asked for by name (``make_mesh(["cpu"] * 4)``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass the devices, e.g. make_mesh(['cpu'] * 4)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None) -> Mesh:
    """The mesh of this process's ``devices`` (default ``default_devices()``;
    a device may repeat, for several shards on one card), the rank and world
    size of the initialized ``torch.distributed`` group (else 0 and 1).

    Under several processes each passes its own devices: by default every
    process would take every visible card.  Checks that every process has
    as many devices (one collective) and that the group's backend is NCCL
    for CUDA shards and gloo for CPU shards."""
    devices = tuple(resolve_device(d) for d in (
        default_devices() if devices is None else devices))
    if not devices:
        raise ValueError("make_mesh: no devices")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"make_mesh: the shards are on one kind of device, CUDA or "
                         f"the CPU; got {[str(d) for d in devices]}")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devices)
    want = "nccl" if devices[0].type == "cuda" else "gloo"
    backend = dist.get_backend()
    if backend != want:
        raise ValueError(f"make_mesh: {devices[0].type} shards need a {want} process "
                         f"group; this one is {backend}")
    mesh = Mesh(devices, dist.get_rank(), dist.get_world_size(), True)
    counts = _all_gather(mesh, torch.tensor([len(devices)], device=mesh.collective_device))
    if bool((counts != len(devices)).any()):
        raise ValueError(f"make_mesh: every process holds as many devices; got "
                         f"{counts.flatten().tolist()}")
    return mesh


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(world_size, *t.shape): ``t`` of every process in rank order (``t``
    alone, unsqueezed, without a process group).  Booleans travel as
    uint8."""
    if not mesh.distributed:
        return t.unsqueeze(0)
    send = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.world_size)]
    dist.all_gather(out, send)
    return torch.stack(out).to(t.dtype)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of EnvStates (or VehicleStates) or of
    observations (a tensor, a dict or a tuple of them)."""
    if dataclasses.is_dataclass(trees[0]):
        return map_fields(fn, *trees)
    return map_obs(fn, *trees)


def shard_batch(tree, mesh: Mesh) -> list:
    """This process's shards of a global batch: one EnvState (or
    observation) of B / S rows for each local device, moved there.

    ``tree`` is the whole batch of B rows (every process passes the same),
    not this process's rows: local shard i takes the global rows of global
    shard s = ``mesh.first_shard`` + i, [s B / S, (s + 1) B / S).  Slicing
    a process-local batch as if it were global was the JAX package's
    round-5 fault (``tests/test_multihost.py``)."""
    sizes = []
    _tree_map(lambda t: sizes.append(t.shape[0]), tree)
    B = sizes[0]
    if B % mesh.num_shards:
        raise ValueError(f"a batch of {B} does not split over {mesh.num_shards} shards")
    b = B // mesh.num_shards
    return [
        _tree_map(lambda t, lo=(mesh.first_shard + i) * b: t[lo:lo + b].to(dev, copy=True),
                  tree)
        for i, dev in enumerate(mesh.devices)
    ]


def gather_batch(shards: list, mesh: Mesh, device=None):
    """The inverse of ``shard_batch``: the global batch, every shard's rows
    in global order, on ``device`` (default the first local device).
    Across processes one ``all_gather`` a tensor, so every rank gets the
    whole batch."""
    device = mesh.devices[0] if device is None else torch.device(device)
    dest = device if not mesh.distributed else mesh.collective_device
    local = _tree_map(lambda *ts: torch.cat([t.to(dest) for t in ts]), *shards)
    if not mesh.distributed:
        return local
    return _tree_map(lambda t: _all_gather(mesh, t).flatten(0, 1).to(device), local)


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (an EnvState or observation) on each local
    device."""
    return [_tree_map(lambda t: t.to(dev, copy=True), tree) for dev in mesh.devices]


def shard_seed(seed: int, shard: int) -> int:
    """The seed of global shard ``shard``: the first 64-bit word of
    ``numpy.random.SeedSequence(seed, spawn_key=(shard,))``, which is
    ``SeedSequence(seed).spawn(S)[shard]`` for any S > shard."""
    state = np.random.SeedSequence(seed, spawn_key=(shard,)).generate_state(1, np.uint64)
    return int(state[0])


def shard_generators(seed: int, mesh: Mesh) -> list[torch.Generator]:
    """One generator per local shard, on its device, seeded with
    ``shard_seed(seed, global shard index)``."""
    return [torch.Generator(device=dev).manual_seed(shard_seed(seed, mesh.first_shard + i))
            for i, dev in enumerate(mesh.devices)]


def shard_envs(env, mesh: Mesh) -> list:
    """An env for each local shard: ``env`` on its own device, and on every
    other device one env of its class, config and frame path (shards on one
    device share it)."""
    made = {env.device: env}
    for dev in mesh.devices:
        if dev not in made:
            other = type(env)(config=env.config, device=dev, sorted_frames=env.sorted_frames,
                              lean=env.lean)
            other.linear_rows = env.linear_rows
            made[dev] = other
    return [made[dev] for dev in mesh.devices]


def _rows_per_shard(shards: list, mesh: Mesh) -> int:
    if len(shards) != mesh.local_shards:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.local_shards} local "
                         "devices")
    sizes = {s.time.shape[0] for s in shards}
    if len(sizes) != 1:
        raise ValueError(f"the shards differ in size: {sorted(sizes)}")
    for s, dev in zip(shards, mesh.devices):
        if s.time.device != torch.empty(0, device=dev).device:  # "cpu:0" holds "cpu"'s
            raise ValueError(f"a shard on {s.time.device} where the mesh has {dev}")
    return sizes.pop()


def _step_sums(reward, done, obs) -> torch.Tensor:
    """(3,) float64: a shard's reward sum, done count and observation sum
    of one step."""
    return torch.stack([reward.sum().double(), done.sum().double(), obs_sum(obs).double()])


def _global_metrics(mesh: Mesh, sums: list, batch: int) -> dict:
    """The metrics of the global batch of ``batch`` rows from each local
    shard's (horizon, 3) step sums: gathered in global shard order and
    added up in that order on every rank, so that they are bit-equal on
    every rank and under every layout of the same shards."""
    local = torch.stack([s.to(mesh.collective_device) for s in sums])
    every = _all_gather(mesh, local).flatten(0, 1)  # (S, horizon, 3)
    total = every[0]
    for part in every[1:]:
        total = total + part
    return {
        "mean_reward": (total[:, 0] / batch).mean(),
        "done_rate": (total[:, 1] / batch).mean(),
        "obs_checksum": total[:, 2].sum(),
    }


def _done_offsets(mesh: Mesh, dones: list) -> list:
    """For each local shard, the done rows of the shards before it in
    global order (one ``all_gather`` of the local counts), on its device."""
    counts = torch.stack([d.sum().to(mesh.collective_device) for d in dones])
    every = _all_gather(mesh, counts).flatten()  # (S,)
    before = torch.cumsum(every, 0) - every
    return [before[mesh.first_shard + i].to(dev) for i, dev in enumerate(mesh.devices)]


def sharded_rollout_fn(env, mesh: Mesh, horizon: int, fresh_pool: int | None = None,
                       compact_reset: int | None = None, graph: bool = False):
    """A random-policy rollout over the mesh's shards:
    ``rollout(shards, generators) -> (shards, metrics)``.

    ``shards`` are this process's EnvStates (``shard_batch``, or each
    shard reset from its own generator), ``generators`` their generators
    (``shard_generators``).  Each shard runs the body of
    ``parallel/rollout.py::rollout`` (``PolicyStep``) on its device's env:
    ``step_autoreset_batched``, with ``compact_reset=P`` as
    ``reset_slots``, or with ``graph=True`` one replay of a ``CapturedStep``
    a step (a call whose shards are the returned ones, with the same
    generators, replays the same graphs; CUDA shards only).  So shard s
    equals ``rollout(env, its rows, horizon, its generator)`` bit for bit.

    ``fresh_pool=P`` keeps the JAX contract over the whole mesh: the done
    envs of a step, in global row order, take the scenes ``min(k, P - 1)``
    of one pool of P fresh scenes, the same on every shard.  Each device
    draws the pool from a generator of its own seeded with ``POOL_SEED``
    alike (carried on from call to call), and each shard starts at the done
    count of the shards before it (one ``all_gather`` a step).  It draws
    other scenes than ``rollout(..., fresh_pool=P)``, whose pool comes from
    the step's generator.

    ``metrics``: ``mean_reward`` and ``done_rate`` (the mean over steps of
    the global batch's means) and ``obs_checksum`` (the sum of every
    observation), 0-dim float64 on the first local device, equal on every
    rank."""
    check_options(fresh_pool, compact_reset, graph)
    if graph and mesh.devices[0].type != "cuda":
        raise ValueError("graph=True captures CUDA graphs; the mesh is on the CPU: "
                         "step CPU shards eagerly")
    envs = shard_envs(env, mesh)
    pool_envs = {}
    for e in envs:
        pool_envs.setdefault(e.device, e)
    pool_generators = {dev: torch.Generator(device=dev).manual_seed(POOL_SEED)
                       for dev in pool_envs} if fresh_pool else {}
    captured: list[PolicyStep] = []

    def rollout(shards: list, generators: list):
        b = _rows_per_shard(shards, mesh)
        if graph and len(captured) == len(shards) and all(
                st.states is s and st.generator is g
                for st, s, g in zip(captured, shards, generators)):
            steps = captured  # the carry of the last call: replay its graphs
        else:
            steps = [PolicyStep(e, s, g, fresh_pool, compact_reset, graph)
                     for e, s, g in zip(envs, shards, generators, strict=True)]
            if graph:
                captured[:] = steps
        sums = [[] for _ in steps]
        for _ in range(horizon):
            for st in steps:  # step t queued on every shard first
                st.launch()
            pools = offsets = None
            if fresh_pool:
                pools = {dev: e._reset(fresh_pool, pool_generators[dev])
                         for dev, e in pool_envs.items()}
                offsets = _done_offsets(mesh, [st.done() for st in steps])
            for i, st in enumerate(steps):
                if fresh_pool:
                    out = st.finish(pools[st.env.device], offsets[i])
                else:
                    out = st.finish()
                obs, _, reward, term, trunc, _ = out
                sums[i].append(_step_sums(reward, term | trunc, obs))
        metrics = _global_metrics(mesh, [torch.stack(s) for s in sums], b * mesh.num_shards)
        return [st.states for st in steps], metrics

    return rollout


@dataclasses.dataclass
class Pool:
    """The reset bank of ``pooled_rollout_fn`` on each local shard:
    ``pool_size`` scenes' observations and states, and the generator that
    regenerates them, seeded alike on every shard, so the banks stay equal."""

    obs: list
    states: list
    generators: list


def pooled_rollout_fn(env, mesh: Mesh, horizon: int, pool_size: int = 64):
    """A random-policy rollout whose done envs draw a reset from a bank:
    ``(rollout, init_pool)``, ``rollout(shards, pool, generators) ->
    (shards, pool, metrics)`` and ``init_pool(seed) -> Pool``.

    The bank holds ``pool_size`` (obs, state) resets, replicated on every
    shard.  Each step, on every shard: a random action per env and
    ``step_batched`` (the JAX package vmaps its single-env step; the port
    has none), a bank index per env drawn from the shard's generator, the
    done rows replaced by their entries; then one entry, drawn from the
    bank's generator, regenerated by a one-scene ``_reset``, the same on
    every shard.  It replaces the in-step autoreset's B resets (on
    intersection-v0 a 45-frame warm-up of the whole batch) with one.  Two
    envs done on one step may draw the same entry.  The JAX package
    re-keys each drawn state; here an env's later draws come from its
    shard's generator, so there is nothing to re-key.  Eager only."""
    envs = shard_envs(env, mesh)

    def init_pool(seed: int) -> Pool:
        gens = [torch.Generator(device=dev).manual_seed(seed) for dev in mesh.devices]
        banks = [e._reset(pool_size, g) for e, g in zip(envs, gens)]
        return Pool([o for o, _ in banks], [s for _, s in banks], gens)

    def rollout(shards: list, pool: Pool, generators: list):
        b = _rows_per_shard(shards, mesh)
        shards, bank_obs, bank = list(shards), list(pool.obs), list(pool.states)
        sums = [[] for _ in shards]
        for _ in range(horizon):
            outs = [e.step_batched(s, random_actions(e, b, g, s.time.device), g)
                    for e, s, g in zip(envs, shards, generators, strict=True)]
            for i, (e, g, out) in enumerate(zip(envs, generators, outs)):
                obs, stepped, reward, term, trunc, _ = out
                done = term | trunc
                dev = stepped.time.device
                idx = torch.randint(0, pool_size, (b,), generator=g, device=dev)
                shards[i], obs = take_scenes(done, (bank_obs[i], bank[i]), idx, stepped, obs)
                sums[i].append(_step_sums(reward, done, obs))
                pg = pool.generators[i]
                slot = torch.randint(0, pool_size, (1,), generator=pg, device=dev)
                fresh_obs, fresh = e._reset(1, pg)
                bank[i] = map_fields(lambda p, f: p.index_copy(0, slot, f), bank[i], fresh)
                bank_obs[i] = map_obs(lambda p, f: p.index_copy(0, slot, f),
                                      bank_obs[i], fresh_obs)
        metrics = _global_metrics(mesh, [torch.stack(s) for s in sums], b * mesh.num_shards)
        return shards, Pool(bank_obs, bank, pool.generators), metrics

    return rollout, init_pool
