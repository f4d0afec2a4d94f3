"""The seeded intersection reset against the JAX package's, on the CPU.

intersection-v0, -v1 (the dynamical ContinuousAction ego, which the
reference gives no target speed or route) and -multi-agent-v1 (two egos)
at seeds 0 and 3.  The reference's draw order: the initial spawns (phase
A), the 3 s warm-up (no draws), the challenger placed after reading the
warmed-up positions, the egos.  Phase A's host records are bit-equal to
the JAX package's.  The warm-up runs on the port's plain frames here and
on the JAX package's XLA frames, so after it the positions agree within
the general path's bound: the discrete fields exactly, every float field
(pos, speed and heading among them) within 5e-4, the frame counter at 45,
and the replay generators at the same draw.
"""

import dataclasses

import numpy as np
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu.seeding as sj
import highwayenv_tpu_torch as ht
import highwayenv_tpu_torch.seeding as st
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

IDS = ["intersection-v0", "intersection-v1", "intersection-multi-agent-v1"]
SEEDS = (0, 3)
ATOL = 5e-4


def _phase_a(seeding, env, rng):
    """The initial spawns' host records, as both replays draw them."""
    n = env.config["initial_vehicle_count"]
    vehicles = []
    for t in range(n - 1):
        seeding._spawn_vehicle_intersection(
            env, rng, vehicles, longitudinal=float(np.linspace(0, 80, n)[t]))
    return vehicles


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("env_id", IDS)
def test_torch_seeded_intersection_matches_jax(env_id, seed):
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    assert st.supports_seeded_reset(et) and sj.supports_seeded_reset(ej)
    # phase A: the same records, bit for bit
    rj, rt = sj.np_random(seed), st.np_random(seed)
    rec_j, rec_t = _phase_a(sj, ej, rj), _phase_a(st, et, rt)
    assert len(rec_t) == len(rec_j) > 0
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a.position, b.position)
        assert (a.kind, a.speed, a.heading, a.delta, a.timer, a.lane_index, a.route) == (
            b.kind, b.speed, b.heading, b.delta, b.timer, b.lane_index, b.route)
    assert rt.random() == rj.random()

    # the whole reset: phase A, the warm-up, the challenger and the egos
    rj, rt = sj.np_random(seed), st.np_random(seed)
    state_j = sj.seeded_reset_state(ej, rj)
    obs_t, state_t = et.reset_seeded(rng=rt)
    assert rt.random() == rj.random()
    assert int(state_t.steps[0]) == int(state_j.steps) == 45
    veh_t, veh_j = state_t.vehicles, state_j.vehicles
    egos = list(et.ego_slots)
    assert (veh_t.kind[0, egos] == 1).all()
    assert int((veh_t.kind[0] != 0).sum()) > len(egos)  # NPCs survive the 20 m drop
    for f in dataclasses.fields(VehicleState):
        a = getattr(veh_t, f.name)[0].numpy()
        b = np.asarray(getattr(veh_j, f.name))
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    obs = obs_t if isinstance(obs_t, tuple) else (obs_t,)
    assert all(o.shape[0] == 1 and bool(torch.isfinite(o).all()) for o in obs)
