"""ContinuousAction and DiscreteAction in the port against the JAX package,
and highway-v0 under a ContinuousAction, on the CPU.

The action module: the clip and the lmap onto the acceleration and steering
ranges, the longitudinal-only and lateral-only forms, the row-major grid
order of DiscreteAction, equal Gymnasium spaces, and ``dynamical=True``,
a flag of the general frames that a straight road refuses at make.  The
stored controls of a ContinuousAction are exact: the lmap is the same
float32 arithmetic; DiscreteAction's grid points agree within 2 ulp.

highway-v0 with ``{"action": {"type": "ContinuousAction"}}``: one
``step_autoreset_batched`` from a JAX reset batch with the same float
actions, through the port's sorted path (K2a, K3, K2b and masked K1) and its
dense path (K1), each on CPU tensors running the kernels' plain versions with
the raw-control branch, against the JAX step (the XLA straight frame on the
CPU).  Tolerances as in test_torch_env.py: discrete fields exact, pos 2e-4
m, other continuous state 1e-4 of its magnitude, obs and reward 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.actions import continuous as j_continuous
from highwayenv_tpu.vehicle.state import empty_state as j_empty_state
from highwayenv_tpu_torch.actions import continuous as t_continuous
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import straight_frames, straight_sorted
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState, empty_state

torch.set_num_threads(1)

B = 8
V = 4
FORMS = {
    "both": {},
    "lateral": {"longitudinal": False},
    "longitudinal": {"lateral": False},
    "ranges": {"acceleration_range": (-3.0, 2.0), "steering_range": (-0.3, 0.5)},
    "no_clip": {"clip": False},
}
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5


def _states(rng):
    """A (B, V) port state and the same JAX one (unbatched fields stacked),
    with stored accel / steering the actions overwrite on the egos only."""
    accel = rng.normal(size=(B, V)).astype(np.float32)
    steering = rng.normal(size=(B, V)).astype(np.float32)
    ego = rng.random((B, V)) < 0.5
    st = empty_state(B, V).replace(accel=torch.from_numpy(accel),
                                   steering=torch.from_numpy(steering))
    sj = j_empty_state(V).replace(accel=jnp.asarray(accel), steering=jnp.asarray(steering))
    return st, sj, ego


@pytest.mark.parametrize("form", FORMS)
def test_continuous_controls_match_jax(form):
    kw = FORMS[form]
    at_t, at_j = t_continuous.ContinuousAction(**kw), j_continuous.ContinuousAction(**kw)
    assert at_t.size == at_j.size and at_t.action_shape == at_j.action_shape
    assert at_t.space() == at_j.space()
    assert at_t.stores_raw_controls and at_j.stores_raw_controls
    rng = np.random.default_rng(1)
    st, sj, ego = _states(rng)
    # actions inside and outside [-1, 1], and both ends exactly
    acts = rng.uniform(-1.5, 1.5, (B, V, at_t.size)).astype(np.float32)
    acts[0, :2] = [[-1.0] * at_t.size, [1.0] * at_t.size]
    out_t = at_t.apply(None, st, torch.from_numpy(ego), torch.from_numpy(acts))
    out_j = at_j.apply(None, sj, jnp.asarray(ego), jnp.asarray(acts))
    for name in ("accel", "steering"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)
    acc, steer = at_t.controls_from_action(torch.from_numpy(acts))
    # within the ranges, as float32 rounds their ends
    acc_range = np.float32(at_t.acceleration_range)
    steer_range = np.float32(at_t.steering_range)
    if at_t.clip:
        assert acc_range[0] <= float(acc.min()) and float(acc.max()) <= acc_range[1]
        assert steer_range[0] <= float(steer.min()) and float(steer.max()) <= steer_range[1]
    if not at_t.lateral:
        assert not steer.any()
    if not at_t.longitudinal:
        assert not acc.any()


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7])
@pytest.mark.parametrize("form", ["both", "lateral", "longitudinal"])
def test_discrete_action_grid_order_matches_jax(form, n):
    kw = dict(FORMS[form], actions_per_axis=n)
    at_t, at_j = t_continuous.DiscreteAction(**kw), j_continuous.DiscreteAction(**kw)
    assert at_t.space() == at_j.space() and at_t.action_shape == at_j.action_shape == ()
    assert at_t.n == at_t.space().n == n ** at_t.size
    rng = np.random.default_rng(2)
    st, sj, ego = _states(rng)
    acts = np.resize(np.arange(at_t.n, dtype=np.int32), (B, V))
    out_t = at_t.apply(None, st, torch.from_numpy(ego), torch.from_numpy(acts))
    out_j = at_j.apply(None, sj, jnp.asarray(ego), jnp.asarray(acts))
    # the points within 2 ulp of the ranges' ends: the port rounds each
    # linspace point once, where the JAX CPU build of jnp.linspace forms
    # i / (n - 1) by a reciprocal and contracts the sum into an FMA (at n = 7
    # its middle point is 2**-26, not 0)
    for name in ("accel", "steering"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)), rtol=0,
                                   atol=2.4e-7 * 5.0, err_msg=name)
    ego_t = torch.from_numpy(ego)
    np.testing.assert_array_equal(out_t.accel[~ego_t].numpy(), st.accel[~ego_t].numpy())
    # row-major: the first axis (acceleration) varies slowest
    if at_t.size == 2:
        acc, steer = at_t.controls_from_action(
            torch.stack([at_t.grid("cpu")[torch.arange(at_t.n) // n],
                         at_t.grid("cpu")[torch.arange(at_t.n) % n]], dim=-1))
        assert acc[0] == acc[n - 1] == at_t.acceleration_range[0]
        assert steer[0] == at_t.steering_range[0] and steer[1] > steer[0]


def test_action_types_through_make_and_the_dynamical_refusal():
    for kind, cls in (("ContinuousAction", t_continuous.ContinuousAction),
                      ("DiscreteAction", t_continuous.DiscreteAction)):
        et = ht.make("highway-v0", {"action": {"type": kind}}, device="cpu")
        ej = hj.make("highway-v0", {"action": {"type": kind}})
        assert type(et.action_type) is cls
        assert et.action_space == ej.action_space
    # dynamical: a flag the general frames read; the straight road refuses it
    assert t_continuous.ContinuousAction(dynamical=True).dynamical
    with pytest.raises(NotImplementedError, match="a dynamical action on a straight road"):
        ht.make("highway-v0", {"action": {"type": "DiscreteAction", "dynamical": True}},
                device="cpu")
    with pytest.raises(ValueError, match="longitudinal and/or lateral"):
        t_continuous.ContinuousAction(longitudinal=False, lateral=False)


def test_action_to_slots_matches_jax():
    config = {"action": {"type": "ContinuousAction"}}
    et, ej = ht.make("highway-v0", config, device="cpu"), hj.make("highway-v0", config)
    acts = np.random.default_rng(3).uniform(-1, 1, (B, 2)).astype(np.float32)
    slots_t = et._action_to_slots(torch.from_numpy(acts))
    slots_j = jax.vmap(ej._action_to_slots)(jnp.asarray(acts))
    assert slots_t.dtype == torch.float32 and slots_t.shape == (B, et.num_slots, 2)
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))


# --------------------------------------------------------------------------- #
# highway-v0 under a ContinuousAction: the straight raw-control branch
# --------------------------------------------------------------------------- #

_SETUP: dict = {}


def _setup():
    if not _SETUP:
        config = {"action": {"type": "ContinuousAction"}}
        ej = hj.make("highway-v0", config)
        _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(3), B))
        _SETUP.update(ej=ej, config=config, states=states,
                      step=jax.jit(ej.step_autoreset_batched))
    return _SETUP


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


@pytest.mark.parametrize("sorted_frames", [True, False], ids=["sorted", "dense"])
def test_highway_continuous_step_matches_jax(sorted_frames):
    s = _setup()
    et = ht.make("highway-v0", s["config"], device="cpu", sorted_frames=sorted_frames)
    # rows 0, 2, 4, 6 with a crashed ego: they end this step
    crashed = np.asarray(s["states"].vehicles.crashed).copy()
    crashed[::2, 0] = True
    sj = s["states"].replace(vehicles=s["states"].vehicles.replace(crashed=jnp.asarray(crashed)))
    acts = np.random.default_rng(11).uniform(-1.2, 1.2, (B, 2)).astype(np.float32)
    obs_j, st_j, rew_j, term_j, trunc_j, info_j = s["step"](sj, jnp.asarray(acts))

    k = (straight_frames.frames_kernel, straight_sorted.sort_kernel,
         straight_sorted.frames_sorted_kernel, straight_sorted.unsort_kernel)
    before = [w.launches for w in k]
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        from_numpy_state(_numpy_state(sj)), torch.from_numpy(acts), et.generator(5)
    )
    assert [w.launches for w in k] == before  # CPU tensors: the plain versions

    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    assert done[::2].all()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")
    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    vt, vj = st_t.vehicles, st_j.vehicles
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(getattr(vt, name).numpy()[keep],
                                      np.asarray(getattr(vj, name))[keep], err_msg=name)
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(vj, name))[keep]
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(vt, name).numpy()[keep], b, tol, name)
    # the egos kept their stored commands: lmap of the clipped actions
    a = np.clip(acts, -1, 1)
    _close(vt.accel[:, 0].numpy()[keep], 5.0 * a[keep, 0], 1e-5, "ego accel")
    _close(vt.steering[:, 0].numpy()[keep], np.float32(np.pi / 4) * a[keep, 1], 1e-6,
           "ego steering")
    assert (vt.kind[:, 0] == KIND_EGO).all()
