"""The port's compact autoreset, step_batched and reset-amortizing rollouts,
on the CPU.

``step_autoreset_batched(..., reset_slots=P)`` against the full autoreset
step, port against port, at highway-fast-v0, merge-v0, roundabout-v0 and
intersection-v0 (B=16, 3 steps from a batch in which every other ego has
crashed, so the first step ends 8 episodes): with P = 4 that step takes a
further pass, with P = B it takes one.  Discrete fields, terminated and
truncated match exactly and the generator ends in the same state; continuous
fields, observations and rewards agree within 4 ulp at the field's
magnitude, since the CPU's vectorized libm may round a row placed among P
rows differently from the same row among B (on the card chip_smoke.py holds
them bit-exact).  A compact reset with no done row is the identity.  The
rollout's ``compact_reset`` equals its default, ``fresh_pool`` hands the
pool's scenes to the done rows in prefix order, and the two options refuse
each other.

``step_batched`` and ``_finish_step`` against the JAX package's on the same
bridged state at highway-fast-v0 and roundabout-v0 (there the head of
``step_batched`` on the port's own frames), to the bounds of
test_torch_env.py: booleans exact, pos 2e-4 m, other continuous fields 1e-4
of their magnitude, obs and reward 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs.base import map_fields
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 16
ENV_IDS = ["highway-fast-v0", "merge-v0", "roundabout-v0", "intersection-v0"]
ULPS = 4
JAX_B = 8
HEAD_ATOL = 1e-5
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")

_ENVS: dict = {}


def _env(env_id):
    if env_id not in _ENVS:
        _ENVS[env_id] = ht.make(env_id, device="cpu")
    return _ENVS[env_id]


def _crashed_start(et, seed=0):
    """A reset batch in which every other ego has crashed: 8 of 16 episodes
    end at the next step."""
    _, st = et.reset(B, et.generator(seed))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, et.ego_slots[0]] = True
    return st.replace(vehicles=st.vehicles.replace(crashed=crashed))


def _same(a, b, where):
    """Exact for integers and booleans, within ULPS at the magnitude for
    floats."""
    a, b = a.numpy(), b.numpy()
    if not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=ULPS * scale, err_msg=where)


def _same_tree(a, b, where):
    if dataclasses.is_dataclass(a):
        map_fields(lambda x, y: _same(x, y, where), a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where} {k}")
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same_tree(x, y, where)
    else:
        _same(a, b, where)


@pytest.mark.parametrize("slots", [4, B])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_compact_autoreset_matches_the_full_step(env_id, slots):
    et = _env(env_id)
    full = compact = _crashed_start(et)
    g_full, g_compact = et.generator(5), et.generator(5)
    for t in range(3):
        acts = torch.randint(0, et.action_type.n, (B,), generator=g_full,
                             dtype=torch.int32)
        assert torch.equal(acts, torch.randint(0, et.action_type.n, (B,),
                                               generator=g_compact, dtype=torch.int32))
        out_f = et.step_autoreset_batched(full, acts, g_full)
        out_c = et.step_autoreset_batched(compact, acts, g_compact, reset_slots=slots)
        done = out_f[3] | out_f[4]
        if t == 0:
            assert int(done.sum()) == 8  # beyond P = 4: a further pass
        for name, a, b in zip(("obs", "state", "reward", "terminated", "truncated",
                               "info"), out_c, out_f):
            _same_tree(a, b, f"{env_id} P={slots} step {t} {name}")
        full, compact = out_f[1], out_c[1]
    assert torch.equal(g_full.get_state(), g_compact.get_state())


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_compact_reset_without_done_rows_is_the_identity(env_id):
    et = _env(env_id)
    st = _crashed_start(et)
    gen, clone = et.generator(7), et.generator(7)
    out = et._compact_autoreset(st, torch.zeros(B, dtype=torch.bool), 4, gen)
    map_fields(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()), out, st)
    # the draws of all B rows are made all the same
    et._reset_draws(B, clone)
    assert torch.equal(gen.get_state(), clone.get_state())


@pytest.mark.parametrize("env_id", ["highway-fast-v0", "intersection-v0"])
def test_rollout_compact_reset_equals_the_default(env_id):
    et = _env(env_id)
    st = _crashed_start(et)
    g_full, g_compact = et.generator(3), et.generator(3)
    st_f, m_f = rollout(et, st, 2, g_full)
    st_c, m_c = rollout(et, st, 2, g_compact, compact_reset=4)
    _same_tree(st_c, st_f, f"{env_id} rollout state")
    for name in m_f:
        _same(m_c[name], m_f[name], f"{env_id} rollout {name}")
    assert torch.equal(g_full.get_state(), g_compact.get_state())


def test_fresh_pool_and_compact_reset_refuse_each_other():
    et = _env("highway-fast-v0")
    _, st = et.reset(4, et.generator(0))
    with pytest.raises(ValueError, match="pass one"):
        rollout(et, st, 1, et.generator(0), fresh_pool=2, compact_reset=2)
    with pytest.raises(ValueError, match="not captured"):
        rollout(et, st, 1, et.generator(0), fresh_pool=2, graph=True)


@pytest.mark.parametrize("env_id", ["highway-fast-v0", "intersection-v0"])
def test_fresh_pool_gives_done_rows_the_pool_in_prefix_order(env_id):
    et = _env(env_id)
    st = _crashed_start(et)
    pool_size = 3
    gen, clone = et.generator(9), et.generator(9)
    out, _ = rollout(et, st, 1, gen, fresh_pool=pool_size)

    acts = torch.randint(0, et.action_type.n, (B,), generator=clone, dtype=torch.int32)
    _, stepped, _, term, trunc, _ = et.step_batched(st, acts, clone)
    _, pool = et._reset(pool_size, clone)
    assert torch.equal(gen.get_state(), clone.get_state())
    done = (term | trunc).numpy()
    assert done.sum() == 8
    k = 0
    for b in range(B):
        want = stepped if not done[b] else pool
        row = b if not done[b] else min(k, pool_size - 1)
        k += int(done[b])
        map_fields(lambda x, y: np.testing.assert_array_equal(x[b].numpy(), y[row].numpy()),
                   out, want)


# --------------------------------------------------------------------------- #
# step_batched and _finish_step against the JAX package
# --------------------------------------------------------------------------- #

_JAX: dict = {}


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _jax_setup(env_id):
    """JAX env and a JAX reset batch with every other ego crashed (their
    episodes end, and step_batched keeps them as they are)."""
    if env_id not in _JAX:
        ej = hj.make(env_id)
        keys = jax.random.split(jax.random.PRNGKey(3), JAX_B)
        _, states = jax.jit(jax.vmap(ej._reset))(keys)
        crashed = np.asarray(states.vehicles.crashed).copy()
        crashed[::2, 0] = True
        states = states.replace(
            vehicles=states.vehicles.replace(crashed=jnp.asarray(crashed)))
        _JAX[env_id] = (ej, states)
    return _JAX[env_id]


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _check_head(out_t, out_j, where):
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = out_t
    obs_j, st_j, rew_j, term_j, trunc_j, info_j = out_j
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
    assert term_t[::2].all()
    _close(obs_t, obs_j, HEAD_ATOL, f"{where} obs")
    _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
    _close(info_t["speed"], info_j["speed"], 1e-4 * 40.0, f"{where} info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"{where} info rewards {name}")
    np.testing.assert_array_equal(st_t.steps.numpy(), np.asarray(st_j.steps))
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(getattr(st_t.vehicles, name).numpy(),
                                      np.asarray(getattr(st_j.vehicles, name)),
                                      err_msg=f"{where} {name}")
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(st_j.vehicles, name))
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(st_t.vehicles, name).numpy(), b, tol, f"{where} {name}")


def test_step_batched_matches_jax():
    """highway-fast-v0, frames and head against the JAX step_batched."""
    ej, sj = _jax_setup("highway-fast-v0")
    et = _env("highway-fast-v0")
    acts = np.random.default_rng(11).integers(0, et.action_type.n, JAX_B).astype(np.int32)
    out_j = jax.jit(ej.step_batched)(sj, jnp.asarray(acts))
    gen = et.generator(0)
    out_t = et.step_batched(from_numpy_state(_numpy_state(sj)), torch.from_numpy(acts), gen)
    _check_head(out_t, out_j, "highway-fast-v0 step_batched")
    # no reset: the generator is untouched (the env has no population hook)
    assert torch.equal(gen.get_state(), et.generator(0).get_state())


def test_step_batched_head_matches_jax_on_the_ports_frames():
    """roundabout-v0: the JAX general step compiles for half a minute on the
    CPU, and test_torch_general_envs.py holds the port's frames to it
    already; here the head of the port's step_batched is held to the JAX
    ``_finish_step`` applied to the port's own simulated state."""
    ej, sj = _jax_setup("roundabout-v0")
    et = _env("roundabout-v0")
    acts = np.random.default_rng(11).integers(0, et.action_type.n, JAX_B).astype(np.int32)
    st = from_numpy_state(_numpy_state(sj))
    sim = et._simulate_batched(st, torch.from_numpy(acts))
    sim_j = jax.tree.map(jnp.asarray, sj.replace(
        vehicles=sj.vehicles.replace(**{
            f.name: jnp.asarray(getattr(sim.vehicles, f.name).numpy())
            for f in dataclasses.fields(VehicleState)
        }),
        time=jnp.asarray(sim.time.numpy()), steps=jnp.asarray(sim.steps.numpy()),
    ))
    out_j = jax.jit(jax.vmap(ej._finish_step))(sim_j, jnp.asarray(acts))
    out_t = et.step_batched(st, torch.from_numpy(acts), et.generator(0))
    _check_head(out_t, out_j, "roundabout-v0 step_batched")


@pytest.mark.parametrize("env_id", ["highway-fast-v0", "roundabout-v0"])
def test_finish_step_matches_jax(env_id):
    ej, sj = _jax_setup(env_id)
    et = _env(env_id)
    acts = np.random.default_rng(12).integers(0, et.action_type.n, JAX_B).astype(np.int32)
    out_j = jax.jit(jax.vmap(ej._finish_step))(sj, jnp.asarray(acts))
    out_t = et._finish_step(from_numpy_state(_numpy_state(sj)), torch.from_numpy(acts))
    _check_head(out_t, out_j, f"{env_id} _finish_step")
