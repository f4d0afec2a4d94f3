"""intersection-v0 with duration 30 (V=42, the wide K5) against the JAX package, on the CPU.

With ``duration`` 30 the env holds 9 initial NPCs, the challenger, 31 spawn
slots and the ego (slot 41), V=42, which ``make`` refused before the wide
K5 (``csrc/general_frames_wide.cu``, one env a block of 128 threads).  On
CPU tensors the wide wrapper runs ``frames_general_plain``, the version the
kernel is held to on the card; it is held here to the JAX package's XLA
frames (the JAX kernels' gate stops at 32 slots), from one jitted JAX reset
batch (``spawn_probability`` 0, so that the step's population hook places
nothing and its done rows can be held to the port's own reset, as in
``test_torch_intersection.py``):

  - 4 policy steps of the regulated frames (``jax.vmap(env._simulate)``
    with traced frame counters), rows starting at distinct tick phases,
    each step from the JAX state of the step before, on the reset batch as
    it is and with its NPCs moved up by 27 slots, so that the scene's
    slots span the first two 32-slot words (slots 27 to 36);
  - one ``step_autoreset_batched``: ``test_torch_wide_intersection_step.py``
    (a file of its own, so that the two JAX compiles run in parallel).

Tolerances: the discrete fields (``lane``, ``target_lane``, ``route_ptr``,
``crashed``, ``hit``, ``impact_pending``, ``kind``, ``is_yielding``,
``yield_timer``) equal; pos, speed, heading and target speed 5e-4; the
other continuous state 1e-4 of its magnitude; obs and reward 1e-5.
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
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_PAD, VehicleState

torch.set_num_threads(1)

B = 4
STEPS = 4
SHIFT = 27  # NPC slot k moves to slot k + SHIFT
CONFIG = {"duration": 30, "spawn_probability": 0.0}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4, "target_speed": 5e-4}
HEAD_ATOL = 1e-5

_SETUP: dict = {}


def _setup():
    """JAX env, port env, one jitted JAX reset batch and the jitted JAX
    frames of a policy step, once per test process."""
    if not _SETUP:
        ej = hj.make("intersection-v0", CONFIG)
        et = ht.make("intersection-v0", CONFIG, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(11), B))

        def sim(st, acts):
            return jax.vmap(ej._simulate)(st, jax.vmap(ej._action_to_slots)(acts))

        _SETUP.update(ej=ej, et=et, states=states, sim=jax.jit(sim))
    return _SETUP


def _moved_up(states, shift: int):
    """The batch with NPC slot k moved to slot (k + shift) % n_npc; the ego
    stays in its slot."""
    n = _setup()["ej"]._n_npc
    V = states.vehicles.kind.shape[1]
    order = np.concatenate([(np.arange(n) - shift) % n, np.arange(n, V)])
    return states.replace(vehicles=jax.tree.map(lambda x: x[:, order], states.vehicles))


def _numpy_state(states) -> dict:
    return {"vehicles": {f.name: np.array(getattr(states.vehicles, f.name))
                         for f in dataclasses.fields(VehicleState)},
            "time": np.array(states.time), "steps": np.array(states.steps)}


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _assert_vehicles(port, ref, where, rows=slice(None)):
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(port, name).numpy()[rows],
                                      np.asarray(getattr(ref, name))[rows],
                                      err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        b = np.asarray(getattr(ref, name))[rows]
        tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
        _close(getattr(port, name).numpy()[rows], b, tol, f"{where}: {name}")


def test_the_scene_is_wide_and_routes_to_the_wide_k5():
    s = _setup()
    ej, et = s["ej"], s["et"]
    assert et.num_slots == ej.num_slots == 42 and et.ego_slots == (41,)
    assert general_frames.frames_kernel_for(et._general, True, et.num_slots) is (
        general_frames.frames_regulated_wide_kernel)
    kind = np.asarray(_moved_up(s["states"], SHIFT).vehicles.kind)
    assert (kind[:, 41] == KIND_EGO).all()
    live = np.nonzero((kind[:, :41] != KIND_PAD).any(axis=0))[0]
    assert live.min() < 32 < live.max(), live  # the NPCs span two mask words


@pytest.mark.parametrize("shift", [0, SHIFT], ids=["as-reset", "moved-up"])
def test_wide_regulated_frames_match_jax_at_mixed_phases(shift):
    """4 policy steps, each taken by both from the same JAX state; row b
    starts at frame counter 45 + 16 b, so the rows start at distinct tick
    phases of the 7-frame period."""
    s = _setup()
    et, sim = s["et"], s["sim"]
    sj = _moved_up(s["states"], shift)
    steps = np.asarray(sj.steps) + np.arange(B, dtype=np.int32) * (et.frames_per_step + 1)
    assert len(set(steps % et._regulation_period)) == B
    rng = np.random.default_rng(4)
    moved = 0.0
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        sj = sj.replace(steps=jnp.asarray(steps))
        veh_t = from_numpy_state(_numpy_state(sj)).vehicles
        out_t = general_frames.simulate_general(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)), et.frames_per_step,
            steps0=torch.from_numpy(steps))
        sj = sim(sj, jnp.asarray(acts))
        _assert_vehicles(out_t, sj.vehicles, f"step {t}")
        moved += float((out_t.pos - veh_t.pos).norm(dim=-1)[:, shift:shift + 10].sum())
        steps = steps + et.frames_per_step
    assert moved > 0.0

