"""The PyTorch port's scaffold against the JAX package: import hygiene,
device and registry contract, the state bridge, math helpers, straight road
tables.  CPU only; inputs from numpy seeds or JAX resets carried across."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops import collision as j_collision
from highwayenv_tpu.ops import straight_fast as j_straight_fast
from highwayenv_tpu.utils import math as j_math
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import collision as t_collision
from highwayenv_tpu_torch.ops import straight_fast as t_straight_fast
from highwayenv_tpu_torch.utils import math as t_math
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_state_dict(state) -> dict:
    """JAX EnvState -> the bridge's numpy dict."""
    return {
        "vehicles": {
            f.name: np.asarray(getattr(state.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(state.time),
        "steps": np.asarray(state.steps),
        "key": np.asarray(state.key),
    }


def jax_reset(env_id: str, batch: int, seed: int):
    env = hj.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return jax.vmap(env._reset)(keys)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, highwayenv_tpu_torch; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'highwayenv_tpu')]; "
        "assert not bad, bad"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_make_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ht.make("highway-v0")
    env = ht.make("highway-v0", device="cpu")
    assert env.device.type == "cpu"
    assert env.geo.start.device.type == "cpu"


def test_unknown_or_unported_id_raises_keyerror():
    assert ht.registered_ids() == [
        "exit-v0", "exit-v1", "highway-fast-v0", "highway-v0",
        "intersection-multi-agent-v0", "intersection-multi-agent-v1",
        "intersection-multi-agent-v2", "intersection-v0",
        "intersection-v1", "intersection-v2", "lane-keeping-v0", "merge-generic-v0",
        "merge-generic-v1", "merge-v0", "merge-v1",
        "parking-ActionRepeat-v0", "parking-parked-v0", "parking-v0",
        "racetrack-large-v0", "racetrack-large-v1", "racetrack-oval-v0",
        "racetrack-oval-v1", "racetrack-v0", "racetrack-v1", "roundabout-generic-v0",
        "roundabout-generic-v1", "roundabout-v0", "roundabout-v1", "two-way-v0",
        "u-turn-v0", "u-turn-v1",
    ]
    assert ht.registered_ids() == hj.registered_ids()
    with pytest.raises(KeyError, match="not ported"):
        ht.make("no-such-env-v0", device="cpu")
    # the 31st id, intersection-multi-agent-v1, makes and steps
    env = ht.make("intersection-multi-agent-v1", device="cpu")
    gen = env.generator(0)
    _, states = env.reset(2, gen)
    obs, _, reward, _, _, _ = env.step_autoreset_batched(
        states, torch.ones((2, 2), dtype=torch.int32), gen)
    assert isinstance(obs, tuple) and reward.shape == (2,)


@pytest.mark.parametrize(
    "env_id,config",
    [
        ("exit-v0", {"controlled_vehicles": 2}),
    ],
)
def test_unported_configurations_raise_at_make(env_id, config):
    with pytest.raises(NotImplementedError, match="not ported"):
        ht.make(env_id, config, device="cpu")


@pytest.mark.parametrize(
    "env_id,config",
    [
        ("highway-v0", {"sequential_decisions": True}),
        ("highway-v0", {"observation": {"type": "GrayscaleObservation",
                                        "observation_shape": (128, 64), "stack_size": 4,
                                        "weights": [0.2989, 0.5870, 0.1140]}}),
    ],
)
def test_configurations_ported_since_make_and_step(env_id, config):
    """Once refused at make: the reference's decision order and the
    grayscale observation make, reset and step."""
    env = ht.make(env_id, config, device="cpu")
    gen = env.generator(0)
    _, states = env.reset(2, gen)
    obs, states, reward, _, _, _ = env.step_autoreset_batched(
        states, torch.ones(2, dtype=torch.int32), gen)
    assert obs.shape[0] == 2 and bool(torch.isfinite(reward).all())
    assert bool(torch.isfinite(states.vehicles.pos).all())


def test_route_choice_preprocessor_returns_the_chosen_route():
    """The ego's route after ``set_route_at_intersection`` is the chosen one
    of the routes followable at its next intersection, from the cursor."""
    from highwayenv_tpu_torch.envs import preprocessors
    from highwayenv_tpu_torch.ops.uncertainty import route_of_slot, routes_at_intersection

    env = ht.make("intersection-v0", device="cpu")
    _, state = env.reset(2, env.generator(0))
    ego = env.ego_slots[0]
    for row in range(2):
        routes = routes_at_intersection(env.net, route_of_slot(env, state, ego, row))
        assert len(routes) == 3
        for k, want in enumerate(routes):
            out = preprocessors.set_route_at_intersection(env, state, ego, k)
            assert route_of_slot(env, out, ego, row) == want
            assert int(out.vehicles.route_ptr[row, ego]) == 0


def test_bridge_round_trip_is_bitwise():
    _, state = jax_reset("highway-v0", 4, 0)
    d = jax_state_dict(state)
    back = to_numpy_state(from_numpy_state(d))
    for name, a in d["vehicles"].items():
        b = back["vehicles"][name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("time", "steps"):
        assert d[name].dtype == back[name].dtype
        np.testing.assert_array_equal(d[name], back[name])
    assert from_numpy_state(d).vehicles.crashed.dtype == torch.bool
    assert from_numpy_state(d).vehicles.lane.dtype == torch.int32


def test_scalar_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-20, 20, 1000), rng.uniform(-0.02, 0.02, 100),
        [0.0, -0.0, np.pi, -np.pi, 3 * np.pi, 0.01, -0.01],
    ]).astype(np.float32)
    np.testing.assert_allclose(
        t_math.wrap_to_pi(torch.from_numpy(x)).numpy(),
        np.asarray(j_math.wrap_to_pi(jnp.asarray(x))), rtol=0, atol=2e-6,
    )
    np.testing.assert_array_equal(
        t_math.not_zero(torch.from_numpy(x)).numpy(),
        np.asarray(j_math.not_zero(jnp.asarray(x))),
    )
    np.testing.assert_allclose(
        t_math.lmap(torch.from_numpy(x), (-5.0, 15.0), (0.0, 1.0)).numpy(),
        np.asarray(j_math.lmap(jnp.asarray(x), (-5.0, 15.0), (0.0, 1.0))),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(
        t_math.do_every(1.0, torch.from_numpy(x)).numpy(),
        np.asarray(j_math.do_every(1.0, jnp.asarray(x))),
    )


def _random_rect_pairs(n: int, seed: int):
    """Rectangle pairs at highway scale, half of them overlapping."""
    rng = np.random.default_rng(seed)
    f = lambda *a: rng.uniform(*a, n).astype(np.float32)  # noqa: E731
    ax, ay = f(0, 1000), f(-2, 14)
    near = rng.random(n) < 0.5
    bx = np.where(near, ax + f(-6, 6), f(0, 1000)).astype(np.float32)
    by = np.where(near, ay + f(-3, 3), f(-2, 14)).astype(np.float32)
    return [
        ax, ay, f(2, 6), f(1, 3), f(-0.6, 0.6),
        bx, by, f(2, 6), f(1, 3), f(-0.6, 0.6),
        f(-3, 3), f(-1, 1),
    ]


def test_folded_sat_matches_jax():
    """Same folded SAT on both sides: booleans equal; the translation to a
    few ulp of the 1000 m positions it is computed from (the depths are
    differences of projections at that magnitude, and libm cos/sin differ
    by ~1 ulp)."""
    args = _random_rect_pairs(4000, 1)
    t_out = t_math.rects_intersecting_xy_folded(*map(torch.from_numpy, args))
    j_out = j_math.rects_intersecting_xy_folded(*map(jnp.asarray, args))
    assert 0 < int(t_out[1].sum()) < len(args[0])
    for k in (0, 1):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    for k in (2, 3):
        np.testing.assert_allclose(
            t_out[k].numpy(), np.asarray(j_out[k]), rtol=0, atol=2e-4
        )


def test_rects_intersecting_matches_jax_8_axis_form():
    ax, ay, la, wa, ha, bx, by, lb, wb, hb, rx, ry = _random_rect_pairs(4000, 2)
    ca, cb = np.stack([ax, ay], -1), np.stack([bx, by], -1)
    da = np.stack([rx, ry], -1)
    t_out = t_math.rects_intersecting(
        *map(torch.from_numpy, (ca, la, wa, ha, cb, lb, wb, hb, da))
    )
    j_out = j_math.rects_intersecting(
        *map(jnp.asarray, (ca, la, wa, ha, cb, lb, wb, hb, da))
    )
    for k in (0, 1):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    will = t_out[1].numpy()
    np.testing.assert_allclose(
        t_out[2].numpy()[will], np.asarray(j_out[2])[will], rtol=0, atol=2e-4
    )


def test_handle_collisions_matches_jax_on_a_crowded_scene():
    """Collision pass alone on a compressed highway-v0 scene: flags exact,
    impacts to ulp level (sphere pre-check as dx^2 + dy^2 against JAX's
    |p|^2 expansion, and the relative sweep rounded once)."""
    _, state = jax_reset("highway-v0", 4, 5)
    pos = np.asarray(state.vehicles.pos).copy()
    pos[..., 0] *= 0.15
    veh_j = state.vehicles.replace(pos=jnp.asarray(pos))
    d = jax_state_dict(state.replace(vehicles=veh_j))
    out_j = jax.jit(jax.vmap(lambda v: j_collision.handle_collisions(v, 1 / 15)))(veh_j)
    out_t = t_collision.handle_collisions(from_numpy_state(d).vehicles, 1 / 15)
    assert int(out_t.crashed.sum()) > 0 and int(out_t.impact_pending.sum()) > 0
    for name in ("crashed", "hit", "impact_pending"):
        np.testing.assert_array_equal(
            getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)), name
        )
    np.testing.assert_allclose(
        out_t.impact.numpy(), np.asarray(out_j.impact), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("env_id", ["highway-v0", "highway-fast-v0"])
def test_straight_network_tables_and_geo_match_jax(env_id):
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    for name in et.geo._fields:
        a = getattr(et.geo, name).numpy()
        b = np.asarray(getattr(ej.geo, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    gj = j_straight_fast.try_compile(ej.net)
    gt = t_straight_fast.try_compile(et.net)
    for name in gt._fields:
        a, b = getattr(gt, name), getattr(gj, name)
        assert type(a) is type(b), name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
