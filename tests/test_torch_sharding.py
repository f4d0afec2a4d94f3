"""The port's multi-device layer (``parallel/sharding.py``), the sharded vector env and the launcher, on the CPU.

CPU shards stand in for cards (``make_mesh(["cpu"] * 4)``, as the JAX tests
use virtual CPU devices), gloo for NCCL:

  - ``shard_batch`` and ``gather_batch`` give back every field exactly, and
    a distributed mesh of one process (gloo) gathers the same;
  - ``step_batched`` over 4 shards, gathered, against the JAX package's
    jitted ``step_batched`` on its 4-device mesh, 3 policy steps from one
    port reset batch with numpy actions, each from the port's state of the
    step before, at highway-fast-v0 and roundabout-v0: discrete fields and
    flags equal, pos within 2e-4 m, other continuous state within 1e-4 of
    its magnitude, obs and reward within 1e-5 (the bounds of
    ``tests/test_torch_env.py``), with random actions but SLOWER, on the
    rows (at least half of them) where no vehicle is slower than 0.5 m/s
    (below it a one-ulp libm difference grows ~4x a frame: a recorded
    difference, held frame by frame in ``tests/test_torch_general.py``);
    and equal to
    the port's unsharded ``step_batched``, discrete fields and flags exactly,
    floats within 1e-6 of their magnitude: torch's CPU sin / cos run a
    batch's vector-width lanes and its tail apart, so a row can differ by an
    ulp with the batch it is in;
  - an env built for a mesh device that is not the env's (``cpu:0``),
    with and without ``change_vehicles``'s Linear rows, equal to the env
    bit for bit;
  - each shard of ``sharded_rollout_fn`` (default and ``compact_reset=3``)
    equal bit for bit to ``rollout`` of its rows with its generator, and
    with one shard the metrics equal to ``rollout``'s within 1e-6 (of the
    magnitude for the checksum: float64 sums of the same float32 terms);
  - ``fresh_pool``: the done rows of a step, in global row order, take the
    pool's scenes 0, 1, ... and P - 1 past P, also when one shard holds them
    all;
  - ``pooled_rollout_fn`` at intersection-v0: the banks equal on both
    shards, every reset row equal to an entry of the bank of its step;
  - the launcher, 2 processes x 2 shards against 1 x 4 and 4 x 1: the
    same final state hash and metrics on every rank of each;
  - ``GymVectorEnv(shard=True)`` equal to two unsharded runs of the halves;
  - the options that exclude each other refused.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.parallel import sharding as j_sharding
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import to_numpy_state
from highwayenv_tpu_torch.envs.base import map_fields
from highwayenv_tpu_torch.parallel import sharding
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.tools import multiproc_rollout
from highwayenv_tpu_torch.vector_env import GymVectorEnv
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
SMALL = {"vehicles_count": 5, "lanes_count": 2}
SHORT = dict(SMALL, duration=2)  # every env ends at its second step
JAX_CONFIGS = {"highway-fast-v0": SMALL, "roundabout-v0": None}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind")
HEAD_ATOL = 1e-5
SLOW = 0.5  # m/s: below it the steering law amplifies ulps (held elsewhere)


def _mesh(n):
    return sharding.make_mesh(["cpu"] * n)


def _clone(states):
    return map_fields(torch.clone, states)


def _same_state(a, b, where):
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(a.vehicles, f.name), getattr(b.vehicles, f.name)), \
            f"{where}: {f.name}"
    assert torch.equal(a.time, b.time) and torch.equal(a.steps, b.steps), where


def _gen_clones(gens):
    out = []
    for g in gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        out.append(c)
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_batch_round_trip(n):
    env = ht.make("highway-fast-v0", SMALL, device="cpu")
    obs, states = env.reset(B, env.generator(0))
    mesh = _mesh(n)
    shards = sharding.shard_batch(states, mesh)
    assert len(shards) == n and all(s.time.shape == (B // n,) for s in shards)
    # shard s holds the rows [s B / S, (s + 1) B / S)
    assert torch.equal(shards[-1].vehicles.pos, states.vehicles.pos[B - B // n:])
    _same_state(sharding.gather_batch(shards, mesh), states, f"{n} shards")
    back = sharding.gather_batch(sharding.shard_batch(obs, mesh), mesh)
    assert torch.equal(back, obs)
    for copy in sharding.replicate(states, mesh):
        _same_state(copy, states, "replicate")
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch(states, _mesh(3))


def test_one_process_group_gathers_alike(tmp_path):
    """A gloo group of one process: the collectives run and give what the
    mesh without a group gives."""
    import torch.distributed as dist

    env = ht.make("highway-fast-v0", SHORT, device="cpu")
    _, states = env.reset(B, env.generator(1))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = sharding.make_mesh(["cpu", "cpu"])
        assert mesh.distributed and mesh.num_shards == 2
        shards = sharding.shard_batch(states, mesh)
        _same_state(sharding.gather_batch(shards, mesh), states, "gloo gather")
        got = sharding.sharded_rollout_fn(env, mesh, 3, fresh_pool=3)(
            shards, sharding.shard_generators(5, mesh))
    finally:
        dist.destroy_process_group()
    local = _mesh(2)
    want = sharding.sharded_rollout_fn(env, local, 3, fresh_pool=3)(
        sharding.shard_batch(states, local), sharding.shard_generators(5, local))
    for a, b in zip(got[0], want[0]):
        _same_state(a, b, "gloo rollout")
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh()
    with pytest.raises(ValueError, match="no devices"):
        sharding.make_mesh([])
    with pytest.raises(ValueError, match="one kind of device"):
        sharding.make_mesh(["cpu", "meta"])


def _jax_state(states):
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(0), d["time"].shape[0]),
    )


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("env_id", sorted(JAX_CONFIGS))
def test_sharded_step_batched_matches_jax_mesh(env_id):
    """Three steps of the port's 4 shards; each step also taken from the
    same gathered state by the port's unsharded ``step_batched`` and by the
    JAX package's on its 4-device mesh."""
    ej, et = hj.make(env_id, JAX_CONFIGS[env_id]), ht.make(env_id, JAX_CONFIGS[env_id],
                                                           device="cpu")
    _, states = et.reset(B, et.generator(2))
    mesh = _mesh(4)
    gens = sharding.shard_generators(0, mesh)
    envs = sharding.shard_envs(et, mesh)
    jmesh = j_sharding.make_mesh(jax.devices()[:4])
    jstep = jax.jit(ej.step_batched)
    shards = sharding.shard_batch(states, mesh)
    # random meta-actions but SLOWER, so that the egos stay off a standstill
    choices = [k for k, name in et.action_type.actions.items() if name != "SLOWER"]
    acts = np.random.default_rng(7).choice(choices, (3, B)).astype(np.int32)
    for t in range(3):
        a = torch.from_numpy(acts[t])
        before = sharding.gather_batch(shards, mesh)
        outs = [e.step_batched(s, part, g) for e, s, part, g in
                zip(envs, shards, a.chunk(4), gens)]
        shards = [o[1] for o in outs]
        obs_t, st_t, rew_t, term_t, trunc_t = (
            sharding.gather_batch([o[k] for o in outs], mesh) for k in range(5))
        # the port's unsharded step: discrete fields and flags equal, floats
        # within 1e-6 of their magnitude (torch's CPU libm runs a batch's
        # vector-width lanes and its tail apart, so a row's sin / cos can
        # differ by an ulp with the size of its batch)
        w_obs, whole, w_rew, w_term, w_trunc, _ = et.step_batched(before, a, et.generator(0))
        where = f"{env_id} step {t} unsharded"
        assert torch.equal(term_t, w_term) and torch.equal(trunc_t, w_trunc), where
        for name, x, y in [("obs", obs_t, w_obs), ("reward", rew_t, w_rew),
                           ("time", st_t.time, whole.time), ("steps", st_t.steps, whole.steps)] + [
                (f.name, getattr(st_t.vehicles, f.name), getattr(whole.vehicles, f.name))
                for f in dataclasses.fields(VehicleState)]:
            if x.dtype.is_floating_point:
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6, msg=f"{where} {name}")
            else:
                assert torch.equal(x, y), f"{where} {name}"
        # the JAX package's sharded step.  Its floats are held on the rows
        # where no vehicle moves slower than SLOW before or after the step:
        # below it the steering law divides by the speed and a one-ulp libm
        # difference grows ~4x a frame (ROADMAP's recorded difference, held
        # frame by frame in test_torch_general.py); its discrete fields and
        # flags on every row
        obs_j, sj, rew_j, term_j, trunc_j, _ = jstep(
            j_sharding.shard_batch(_jax_state(before), jmesh),
            j_sharding.shard_batch(jnp.asarray(acts[t]), jmesh))
        where = f"{env_id} step {t}"
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), where)
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), where)
        np.testing.assert_array_equal(st_t.steps.numpy(), np.asarray(sj.steps), where)
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(st_t.vehicles, name).numpy(),
                                          np.asarray(getattr(sj.vehicles, name)),
                                          f"{where} {name}")
        moving = ~((before.vehicles.speed.abs() < SLOW).any(1)
                   | (st_t.vehicles.speed.abs() < SLOW).any(1)).numpy()
        assert moving.sum() >= B // 2, f"{where}: {int(moving.sum())} rows compared"
        _close(obs_t.numpy()[moving], np.asarray(obs_j)[moving], HEAD_ATOL, f"{where} obs")
        _close(rew_t.numpy()[moving], np.asarray(rew_j)[moving], HEAD_ATOL, f"{where} reward")
        _close(st_t.time, sj.time, 1e-6, f"{where} time")
        for name in ("pos", "heading", "speed", "target_speed", "timer", "steering", "accel"):
            want = np.asarray(getattr(sj.vehicles, name))[moving]
            tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(want).max()))
            _close(getattr(st_t.vehicles, name).numpy()[moving], want, tol, f"{where} {name}")


@pytest.mark.parametrize("linear", [False, True], ids=["idm", "change-vehicles"])
def test_shard_envs_builds_the_env_on_another_device(linear):
    """A mesh device that is not the env's (``cpu:0`` against ``cpu``)
    gets an env of its own, built from the env's class, config and frame
    path, with the ``linear_rows`` a preprocessor set: its autoreset steps,
    and the sharded rollout over it, equal the env's bit for bit."""
    from highwayenv_tpu_torch.envs import preprocessors

    env = ht.make("highway-fast-v0", SHORT, device="cpu")
    _, states = env.reset(B, env.generator(6))
    if linear:
        states = preprocessors.change_vehicles(
            env, states, "highway_env.vehicle.behavior.LinearVehicle")
        assert env.linear_rows
    mesh = sharding.make_mesh([torch.device("cpu", 0)] * 2)
    envs = sharding.shard_envs(env, mesh)
    other = envs[0]
    assert other is not env and envs[1] is other and other.device == torch.device("cpu", 0)
    assert other.linear_rows == env.linear_rows
    st_a, st_b = _clone(states), _clone(states)
    g_a, g_b = env.generator(8), other.generator(8)
    rng = np.random.default_rng(1)
    for t in range(3):
        a = torch.from_numpy(rng.integers(0, env.action_type.n, B).astype(np.int32))
        o_a, st_a, r_a, te_a, tr_a, _ = env.step_autoreset_batched(st_a, a, g_a)
        o_b, st_b, r_b, te_b, tr_b, _ = other.step_autoreset_batched(st_b, a, g_b)
        _same_state(st_b, st_a, f"step {t}")
        for x, y in ((o_b, o_a), (r_b, r_a), (te_b, te_a), (tr_b, tr_a)):
            assert torch.equal(x, y), f"step {t}"
    gens = sharding.shard_generators(12, mesh)
    refs = _gen_clones(gens)
    own = [_clone(s) for s in sharding.shard_batch(states, _mesh(2))]
    out, _ = sharding.sharded_rollout_fn(env, mesh, 3)(sharding.shard_batch(states, mesh), gens)
    for s in range(2):
        _same_state(out[s], rollout(env, own[s], 3, refs[s])[0], f"shard {s}")


@pytest.mark.parametrize("compact_reset", [None, 3])
def test_each_shard_equals_its_own_rollout(compact_reset):
    env = ht.make("highway-fast-v0", SHORT, device="cpu")
    _, states = env.reset(B, env.generator(3))
    mesh = _mesh(2)
    gens = sharding.shard_generators(11, mesh)
    refs = _gen_clones(gens)
    shards = sharding.shard_batch(states, mesh)
    own = [_clone(s) for s in shards]
    fn = sharding.sharded_rollout_fn(env, mesh, 4, compact_reset=compact_reset)
    out, metrics = fn(shards, gens)
    assert float(metrics["done_rate"]) > 0.0, "duration 2 must reset envs"
    for s in range(2):
        want, _ = rollout(env, own[s], 4, refs[s], compact_reset=compact_reset)
        _same_state(out[s], want, f"shard {s}")
        assert torch.equal(gens[s].get_state(), refs[s].get_state())
    # one shard: the metrics of rollout
    one = _mesh(1)
    g1 = sharding.shard_generators(11, one)
    ref = _gen_clones(g1)[0]
    _, m1 = sharding.sharded_rollout_fn(env, one, 4, compact_reset=compact_reset)(
        [_clone(states)], g1)
    _, m0 = rollout(env, _clone(states), 4, ref, compact_reset=compact_reset)
    for k in ("mean_reward", "done_rate"):
        assert abs(float(m1[k]) - float(m0[k])) <= 1e-6, k
    chk = float(m0["obs_checksum"])
    assert abs(float(m1["obs_checksum"]) - chk) <= 1e-6 * max(1.0, abs(chk))


def _ending(env, states, rows):
    """``states`` with ``rows`` one policy step short of ``duration``."""
    time = states.time.clone()
    time[list(rows)] = env.config["duration"] - 1.0 / env.config["policy_frequency"]
    return states.replace(time=time)


@pytest.mark.parametrize("rows, P", [((1, 4, 6, 7), 3), ((2, 3), 4), ((0, 5), 2)],
                         ids=["spread-past-P", "one-shard", "two-shards"])
def test_fresh_pool_prefix_over_the_mesh(rows, P):
    """One step: done row k in global order takes pool scene min(k, P - 1);
    the pool is ``_reset(P)`` of the generator seeded ``POOL_SEED``."""
    env = ht.make("highway-fast-v0", dict(SMALL, duration=20), device="cpu")
    _, states = env.reset(B, env.generator(4))
    states = _ending(env, states, rows)
    mesh = _mesh(4)
    fn = sharding.sharded_rollout_fn(env, mesh, 1, fresh_pool=P)
    out, metrics = fn(sharding.shard_batch(states, mesh), sharding.shard_generators(0, mesh))
    assert float(metrics["done_rate"]) == len(rows) / B
    got = sharding.gather_batch(out, mesh)
    _, pool = env._reset(P, torch.Generator().manual_seed(sharding.POOL_SEED))
    pos = pool.vehicles.pos.reshape(P, -1)
    assert float(torch.cdist(pos, pos).add(torch.eye(P) * 1e9).min()) > 1e-3, \
        "the pool's scenes differ"
    for k, row in enumerate(rows):
        want = min(k, P - 1)
        for f in dataclasses.fields(VehicleState):
            assert torch.equal(getattr(got.vehicles, f.name)[row],
                               getattr(pool.vehicles, f.name)[want]), (row, f.name)
        assert float(got.time[row]) == 0.0
    kept = [r for r in range(B) if r not in rows]
    assert bool((got.time[kept] > 0).all())


def test_pooled_rollout_draws_from_equal_banks():
    env = ht.make("intersection-v0", device="cpu")
    _, states = env.reset(B, env.generator(5))
    crashed = states.vehicles.crashed.clone()
    crashed[[0, 3, 5], env.ego_slots[0]] = True  # these end at the first step
    states = states.replace(vehicles=states.vehicles.replace(crashed=crashed))
    mesh = _mesh(2)
    roll, init_pool = sharding.pooled_rollout_fn(env, mesh, 1, pool_size=4)
    pool = init_pool(9)
    shards, gens = sharding.shard_batch(states, mesh), sharding.shard_generators(2, mesh)
    reset_rows = 0
    for call in range(3):
        for s in (0, 1):
            assert torch.equal(pool.obs[s], pool.obs[0])
            _same_state(pool.states[s], pool.states[0], f"bank, call {call}")
        before = pool
        shards, pool, metrics = roll(shards, pool, gens)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        for s, shard in enumerate(shards):
            for r in torch.nonzero(shard.time == 0).flatten().tolist():
                bank = before.states[s]
                hits = [i for i in range(4) if all(
                    torch.equal(getattr(shard.vehicles, f.name)[r],
                                getattr(bank.vehicles, f.name)[i])
                    for f in dataclasses.fields(VehicleState))]
                assert hits, f"call {call} shard {s} row {r}: no bank entry"
                reset_rows += 1
        if call == 0:
            got = sharding.gather_batch(shards, mesh)
            assert bool((got.time[[0, 3, 5]] == 0).all()), "time restarts"
    assert reset_rows >= 3


@pytest.mark.parametrize("shards", [4, 8])
def test_shard_seed_is_the_spawned_child(shards):
    """Shard s's seed is child s of ``SeedSequence(seed).spawn(S)``, for
    any S: it depends on the seed and s alone."""
    for s, child in enumerate(np.random.SeedSequence(7).spawn(shards)):
        assert sharding.shard_seed(7, s) == int(child.generate_state(1, np.uint64)[0])
    mesh = _mesh(2)
    draws = [torch.rand(3, generator=g) for g in sharding.shard_generators(7, mesh)]
    assert not torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("extra", [[], ["--fresh-pool", "3"]], ids=["default", "fresh-pool"])
def test_launcher_layouts_agree(tmp_path, extra):
    config = '{"vehicles_count": 5, "lanes_count": 2, "duration": 2}'
    lines = {}
    for procs, shards in ((2, 2), (1, 4), (4, 1)):
        cmd = [sys.executable, multiproc_rollout.__file__, "--processes", str(procs),
               "--shards", str(shards), "--device", "cpu", "--env", "highway-fast-v0",
               "--config", config, "--batch", "8", "--horizon", "4",
               "--init", f"file://{tmp_path}/store-{procs}x{shards}", "--timeout", "100",
               *extra]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stdout + run.stderr
        found = [multiproc_rollout.LINE.match(line) for line in run.stdout.splitlines()]
        found = [m.group(2) for m in found if m]
        assert len(found) == procs and len(set(found)) == 1, run.stdout
        lines[(procs, shards)] = found[0]
    assert lines[(2, 2)] == lines[(1, 4)] == lines[(4, 1)], lines
    assert "done_rate=0.0 " not in lines[(1, 4)]


def test_sharded_vector_env_equals_the_halves(monkeypatch):
    monkeypatch.setattr(sharding, "default_devices", lambda: [torch.device("cpu")] * 2)
    envs = GymVectorEnv("highway-fast-v0", 8, config=SHORT, device="cpu", shard=True)
    assert envs._mesh is not None and envs._mesh.num_shards == 2
    obs, _ = envs.reset(seed=3)
    env = ht.make("highway-fast-v0", SHORT, device="cpu")
    mesh = _mesh(2)
    gens = sharding.shard_generators(3, mesh)
    halves = [env.reset_batch(4, g) for g in gens]
    np.testing.assert_array_equal(obs, torch.cat([o for o, _ in halves]).numpy())
    states = [s for _, s in halves]
    rng = np.random.default_rng(0)
    ended = 0
    for t in range(3):
        a = rng.integers(0, 5, 8).astype(np.int32)
        o, r, term, trunc, _ = envs.step(a)
        outs = [env.step_autoreset_batched(s, torch.from_numpy(part), g)
                for s, part, g in zip(states, np.split(a, 2), gens)]
        states = [out[1] for out in outs]
        np.testing.assert_array_equal(o, torch.cat([out[0] for out in outs]).numpy())
        np.testing.assert_array_equal(r, torch.cat([out[2] for out in outs]).numpy())
        np.testing.assert_array_equal(term, torch.cat([out[3] for out in outs]).numpy())
        np.testing.assert_array_equal(trunc, torch.cat([out[4] for out in outs]).numpy())
        ended += int((trunc | term).sum())
    assert ended, "duration 2 must end episodes"
    for got, want in zip(envs.states, states):
        _same_state(got, want, "vector env shard")
    with pytest.raises(ValueError, match="does not split"):
        GymVectorEnv("highway-fast-v0", 5, config=SMALL, device="cpu", shard=True)
    plain = GymVectorEnv("highway-fast-v0", 8, config=SMALL, device="cpu")
    plain.reset(seed=0)
    assert plain._mesh is None and isinstance(plain.states.time, torch.Tensor)


def test_exclusive_options_are_refused():
    env = ht.make("highway-fast-v0", SMALL, device="cpu")
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="pass one"):
        sharding.sharded_rollout_fn(env, mesh, 2, fresh_pool=2, compact_reset=2)
    with pytest.raises(ValueError, match="fresh_pool"):
        sharding.sharded_rollout_fn(env, mesh, 2, fresh_pool=2, graph=True)
    with pytest.raises(ValueError, match="CPU"):
        sharding.sharded_rollout_fn(env, mesh, 2, graph=True)
    with pytest.raises(TypeError):
        sharding.pooled_rollout_fn(env, mesh, 2, graph=True)
