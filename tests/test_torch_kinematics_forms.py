"""Kinematics' destination features and shuffled order against the JAX
package, on the CPU.

``cos_d`` / ``sin_d`` (the unit vector to the end of each row's route) with
``observe_intentions`` at intersection-v0 and roundabout-v0, from a port
reset batch and its next steps, within 1e-5 of the JAX observation of the
same states; zero on highway-v0, where no vehicle has a route, and without
``observe_intentions``.

``order="shuffled"``: the port draws one permutation of the rows after the
ego's an env and an observation from the step's generator, the JAX package
from its state's key, so the two agree in distribution, not in bits.  Held
here: the ego row is the sorted order's, the other rows are a permutation
of the sorted order's rows, the permutations differ across envs and steps,
one generator state gives one permutation, and the sorted order draws
nothing.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
ATOL = 1e-5
FEATURES = ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h", "cos_d", "sin_d"]


def _jax_state(states) -> JaxEnvState:
    veh = JaxVehicleState(**{f.name: jnp.asarray(getattr(states.vehicles, f.name).numpy())
                             for f in dataclasses.fields(VehicleState)})
    return JaxEnvState(vehicles=veh, time=jnp.asarray(states.time.numpy()),
                       steps=jnp.asarray(states.steps.numpy()),
                       key=jax.random.split(jax.random.PRNGKey(0), states.time.shape[0]))


def _obs_config(intentions: bool, **extra) -> dict:
    return {"observation": {"type": "Kinematics", "features": FEATURES,
                            "observe_intentions": intentions, **extra}}


@pytest.mark.parametrize("env_id", ["intersection-v0", "roundabout-v0"])
def test_torch_destination_features_match_jax(env_id):
    cfg = dict(_obs_config(True), **({"spawn_probability": 0.0}
                                     if env_id.startswith("intersection") else {}))
    et, ej = ht.make(env_id, cfg, device="cpu"), hj.make(env_id, cfg)
    observe_j = jax.vmap(ej._observe)
    gen = et.generator(1)
    _, st = et.reset(B, gen)
    cd = FEATURES.index("cos_d")
    for step in range(3):
        obs_t = et._observe(st)
        obs_j = np.asarray(observe_j(_jax_state(st)))
        np.testing.assert_allclose(obs_t.numpy(), obs_j, rtol=0, atol=ATOL,
                                   err_msg=f"{env_id} step {step}")
        d = obs_t[..., cd : cd + 2]
        norm = d.norm(dim=-1)
        present = obs_t[..., 0] > 0
        # a unit vector on every present row with a route, the ego's included
        assert bool((norm[:, 0] - 1).abs().max() < 1e-5), env_id
        assert bool(((norm - 1).abs() < 1e-5)[present].float().mean() > 0.5), env_id
        st = et.step_autoreset_batched(st, random_actions(et, B, gen), gen)[1]
    # without observe_intentions the columns are zero
    quiet = ht.make(env_id, dict(cfg, **_obs_config(False)), device="cpu")
    assert float(quiet._observe(st)[..., cd : cd + 2].abs().max()) == 0.0


def test_torch_destination_features_zero_on_highway():
    et = ht.make("highway-v0", _obs_config(True), device="cpu")
    ej = hj.make("highway-v0", _obs_config(True))
    _, st = et.reset(B, et.generator(0))
    obs_t = et._observe(st)
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(jax.vmap(ej._observe)(_jax_state(st))),
                               rtol=0, atol=ATOL)
    cd = FEATURES.index("cos_d")
    assert float(obs_t[..., cd : cd + 2].abs().max()) == 0.0


def _rows(x: torch.Tensor) -> list:
    """The rows of an (N, F) observation as a sorted list of tuples."""
    return sorted(map(tuple, x.tolist()))


def test_torch_shuffled_order_permutes_the_sorted_rows():
    shuffled = {"observation": {"type": "Kinematics", "vehicles_count": 8,
                                "order": "shuffled"}}
    es = ht.make("highway-fast-v0", shuffled, device="cpu")
    eo = ht.make("highway-fast-v0", dict(shuffled, observation=dict(
        shuffled["observation"], order="sorted")), device="cpu")
    assert es.observation_type.needs_generator and not eo.observation_type.needs_generator
    gs, go = es.generator(3), eo.generator(3)
    obs_s, st_s = es.reset(B, gs)
    obs_o, st_o = eo.reset(B, go)
    # the permutation is drawn after the scenes: the same states
    assert torch.equal(st_s.vehicles.pos, st_o.vehicles.pos)
    perms = set()
    for step in range(3):
        assert torch.equal(obs_s[:, 0], obs_o[:, 0]), step
        for b in range(B):
            assert _rows(obs_s[b, 1:]) == _rows(obs_o[b, 1:]), (step, b)
            sorted_rows = [tuple(r) for r in obs_o[b, 1:].tolist()]
            assert len(set(sorted_rows)) == len(sorted_rows), (step, b)
            perms.add(tuple(sorted_rows.index(tuple(r)) for r in obs_s[b, 1:].tolist()))
        acts = random_actions(es, B, es.generator(10 + step))
        state_gen_s, state_gen_o = gs.get_state(), go.get_state()
        obs_s, st_s = es.step_batched(st_s, acts, gs)[:2]
        obs_o, st_o = eo.step_batched(st_o, acts, go)[:2]
        # one permutation an env a step: the shuffled step drew, the sorted
        # one did not
        assert not torch.equal(gs.get_state(), state_gen_s)
        assert torch.equal(go.get_state(), state_gen_o)
        assert torch.equal(st_s.vehicles.pos, st_o.vehicles.pos)
    # the orders differ across envs and steps: 24 draws of 7! orders
    assert len(perms) > 20
    # one generator state, one permutation; another, another
    a = es._observe(st_s, es.generator(7))
    assert torch.equal(a, es._observe(st_s, es.generator(7)))
    assert not torch.equal(a, es._observe(st_s, es.generator(8)))
    # no generator: the sorted rows
    assert torch.equal(es._observe(st_s), eo._observe(st_o))
    # under MultiAgentObservation the sub-observation gets no draw, as in
    # the JAX package: the sorted rows
    multi = ht.make("highway-fast-v0", {"observation": {
        "type": "MultiAgentObservation", "observation_config": shuffled["observation"]}},
        device="cpu")
    g = multi.generator(0)
    state = g.get_state()
    assert torch.equal(multi._observe(st_o, g)[0], eo._observe(st_o))
    assert torch.equal(g.get_state(), state)


def test_torch_shuffled_order_through_the_autoreset_and_seeded_reset():
    cfg = {"observation": {"type": "Kinematics", "order": "shuffled"}}
    et = ht.make("highway-fast-v0", cfg, device="cpu")
    _, st = et.reset(B, et.generator(0))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 0] = True
    st = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    acts = random_actions(et, B, et.generator(1))
    g1, g2 = et.generator(2), et.generator(2)
    out1 = et.step_autoreset_batched(st, acts, g1)
    out2 = et.step_autoreset_batched(st, acts, g2)
    assert torch.equal(out1[0], out2[0]) and torch.equal(g1.get_state(), g2.get_state())
    assert (out1[3] | out1[4]).tolist() == [True, False] * (B // 2)
    # the compact autoreset draws the placed rows' permutations: the same
    # states as the full path, rows of the same observations
    out3 = et.step_autoreset_batched(st, acts, et.generator(2), reset_slots=2)
    assert torch.equal(out3[1].vehicles.pos, out1[1].vehicles.pos)
    for b in range(B):
        assert _rows(out3[0][b]) == _rows(out1[0][b])
    # the seeded reset observes with the generator reseeded from its rng
    o1 = et.reset_seeded(seed=4)[0]
    o2 = et.reset_seeded(seed=4)[0]
    assert torch.equal(o1, o2) and o1.shape == (1, 5, 5)
