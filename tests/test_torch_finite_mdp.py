"""The finite-MDP export and the perception query against the JAX package,
on the CPU.

``to_finite_mdp`` at highway-v0, highway-fast-v0 and exit-v0 (whose 6- and
7-lane edges tell the two lane-axis rules apart) from a port reset batch
and its next steps: the transition table, the terminal states and the
current state equal, the rewards within 1e-6, under both rules: a B=1
state against the JAX package's call on one concrete state (the ego's
current edge), a batch against its call under ``vmap`` (the widest edge).
``close_objects_to`` at highway-v0 and roundabout-v0: indices and validity
equal, sorted and in slot order, with and without a count, vehicles only,
not seeing behind.
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
from highwayenv_tpu_torch.envs.base import take_rows
from highwayenv_tpu_torch.ops.finite_mdp import transition_tensor
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 4
REWARD_ATOL = 1e-6


def _jax_state(states) -> JaxEnvState:
    veh = JaxVehicleState(**{f.name: jnp.asarray(getattr(states.vehicles, f.name).numpy())
                             for f in dataclasses.fields(VehicleState)})
    return JaxEnvState(vehicles=veh, time=jnp.asarray(states.time.numpy()),
                       steps=jnp.asarray(states.steps.numpy()),
                       key=jax.random.split(jax.random.PRNGKey(0), states.time.shape[0]))


def _row(state: JaxEnvState, b: int) -> JaxEnvState:
    return jax.tree_util.tree_map(lambda x: x[b], state)


def _states(et, steps: int = 2):
    gen = et.generator(2)
    _, st = et.reset(B, gen)
    out = [st]
    for _ in range(steps):
        st = et.step_autoreset_batched(st, random_actions(et, B, gen), gen)[1]
        out.append(st)
    return out


def _same_mdp(mt, mj, where: str, batched: bool) -> None:
    """The port's MDP of a batch (or of one env, its row 0) against the JAX
    package's (vmapped: its static parts come back with the batch axis)."""
    shape, transition = mj.original_shape, np.asarray(mj.transition)
    if batched:
        shape, transition = tuple(int(np.asarray(x)[0]) for x in shape), transition[0]
    assert tuple(mt.original_shape) == tuple(shape), where
    np.testing.assert_array_equal(mt.transition.numpy(), transition, err_msg=where)
    for name in ("terminal", "state", "reward"):
        got = getattr(mt, name).numpy()
        got = got if batched else got[0]
        if name == "reward":
            np.testing.assert_allclose(got, np.asarray(mj.reward), rtol=0,
                                       atol=REWARD_ATOL, err_msg=where)
        else:
            np.testing.assert_array_equal(got, np.asarray(getattr(mj, name)),
                                          err_msg=f"{where} {name}")


@pytest.mark.parametrize("env_id", ["highway-v0", "highway-fast-v0", "exit-v0"])
def test_torch_finite_mdp_matches_jax(env_id):
    et, ej = ht.make(env_id, device="cpu"), hj.make(env_id)
    batched_j = jax.vmap(ej.to_finite_mdp)
    collided = 0
    for k, st in enumerate(_states(et)):
        sj = _jax_state(st)
        # a batch: the widest edge's lanes
        mt = et.to_finite_mdp(st)
        _same_mdp(mt, batched_j(sj), f"{env_id} state {k} batched", True)
        S = int(np.prod(mt.original_shape))
        assert mt.reward.shape == (B, S, 5) and mt.terminal.shape == (B, S)
        # terminal before the horizon's end: a cell of the grid that a
        # vehicle reaches
        collided += int(mt.terminal.view(B, *mt.original_shape)[..., :-1].sum())
        # B=1: the ego's current edge's lanes
        for b in range(B):
            _same_mdp(et.to_finite_mdp(take_rows(st, torch.tensor([b]))),
                      ej.to_finite_mdp(_row(sj, b)), f"{env_id} state {k} env {b}", False)
    assert collided > 0, env_id


def test_torch_transition_table():
    """FASTER and SLOWER act at time 0 only, lane changes clip at the edge."""
    shape = (3, 2, 4)
    t = transition_tensor(shape)
    assert t.shape == (24, 5)
    idx = np.ravel_multi_index
    assert t[idx((1, 0, 0), shape), 3] == idx((2, 0, 1), shape)
    assert t[idx((1, 0, 1), shape), 3] == idx((1, 0, 2), shape)
    assert t[idx((1, 0, 0), shape), 0] == idx((1, 0, 1), shape)
    assert t[idx((1, 1, 3), shape), 2] == idx((1, 1, 3), shape)


@pytest.mark.parametrize("env_id", ["highway-v0", "roundabout-v0"])
def test_torch_close_objects_to_matches_jax(env_id):
    et, ej = ht.make(env_id, device="cpu"), hj.make(env_id)
    st = _states(et, steps=1)[-1]
    sj = _jax_state(st)
    ego = et.ego_slots[0]
    kinds = [dict(), dict(count=4), dict(sort=False), dict(see_behind=False, count=6),
             dict(vehicles_only=True), dict(count=3, sort=False, see_behind=False)]
    found = 0
    for slot in (ego, et.num_slots - 1):
        for distance in (30.0, 150.0):
            for kw in kinds:
                idx_t, ok_t = et.close_objects_to(st, slot, distance, **kw)
                idx_j, ok_j = jax.vmap(
                    lambda s: ej.close_objects_to(s, slot, distance, **kw))(sj)
                where = f"{env_id} slot {slot} distance {distance} {kw}"
                np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j), err_msg=where)
                # the valid entries' indices; past them the order of the
                # invalid slots is the stable sort's on equal keys
                np.testing.assert_array_equal(np.where(ok_t.numpy(), idx_t.numpy(), -1),
                                              np.where(ok_j, idx_j, -1), err_msg=where)
                np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j), err_msg=where)
                found += int(ok_t.sum())
    assert found > 0
