"""The port's route tools, multiple-model tracker and route-choice
preprocessor against the JAX package's, on the CPU.

The JAX host tools read an unbatched state; the port's read row ``row`` of a
batched one.  Each is held against the JAX tool applied to row b of the same
state, bridged through ``bridge.py``:

- ``route_of_slot``, ``routes_at_intersection``, ``neighbour_slots``,
  ``acceleration_features`` and ``steering_features`` at intersection-v0,
  every row and every vehicle slot, exactly;
- ``MultipleModelTracker`` over 6 steps of a port intersection-v0 rollout:
  route, hypotheses and their (features, outputs) data equal at each step,
  and ``assume_model_is_valid``'s observer;
- ``set_route_at_intersection`` for every option, per row, equal to the JAX
  function on that row; ``"random"`` draws one option a row from the given
  generator (the same law as the JAX package's fresh ``default_rng``, not
  the same bits); the rerouted batch then steps;
- the recorded difference: the port's ``neighbour_slots`` skips landmarks,
  as the reference does, where the JAX package's counts them (it tests kind
  7, and ``KIND_LANDMARK`` is 6), shown on parking-v0 with the goal on the
  lane ahead of the ego.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs import preprocessors as j_pre
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.ops import uncertainty as j_unc
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.envs import preprocessors as t_pre
from highwayenv_tpu_torch.ops import uncertainty as t_unc
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, KIND_LANDMARK

torch.set_num_threads(1)

B = 4
TRACK_STEPS = 6
ROUTE_FIELDS = ("route_base", "route_n", "route_id", "route_ptr", "route_len")
OPTIONS = [0, 1, 2, 5]

_SETUP: dict = {}


def _setup():
    """The JAX intersection-v0 (its network only: no JAX reset or step is
    compiled) and the port's, with a port reset batch."""
    if not _SETUP:
        ej = hj.make("intersection-v0")
        et = ht.make("intersection-v0", device="cpu")
        gen = et.generator(3)
        _, st = et.reset(B, gen)
        _SETUP.update(ej=ej, et=et, st=st, gen=gen)
    return _SETUP


def _jax_row(states, b: int) -> JaxEnvState:
    """Row b of a port state as the JAX package's unbatched state."""
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v[b]) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"][b]), steps=jnp.asarray(d["steps"][b]),
        key=jax.random.PRNGKey(b),
    )


def _vehicle_slots(states, b):
    kind = states.vehicles.kind[b].numpy()
    return [int(j) for j in np.nonzero((kind == KIND_IDM) | (kind == KIND_EGO))[0]]


def test_route_and_feature_tools_match_jax_per_row():
    s = _setup()
    ej, et, st = s["ej"], s["et"], s["st"]
    checked = 0
    for b in range(B):
        js = _jax_row(st, b)
        lanes = st.vehicles.lane[b].numpy()
        targets = st.vehicles.target_lane[b].numpy()
        for slot in _vehicle_slots(st, b):
            route = t_unc.route_of_slot(et, st, slot, row=b)
            assert route == j_unc.route_of_slot(ej, js, slot)
            assert (t_unc.routes_at_intersection(et.net, route)
                    == j_unc.routes_at_intersection(ej.net, route))
            for g in {int(lanes[slot]), int(targets[slot])}:
                index = et.net.lane_index_from_global(g)
                assert (t_unc.neighbour_slots(et, st, slot, index, row=b)
                        == j_unc.neighbour_slots(ej, js, slot, index))
                np.testing.assert_array_equal(
                    t_unc.acceleration_features(et, st, slot, index, row=b),
                    j_unc.acceleration_features(ej, js, slot, index))
                np.testing.assert_array_equal(
                    t_unc.steering_features(et, st, slot, index, row=b),
                    j_unc.steering_features(ej, js, slot, index))
            checked += len(route) > 1
    assert checked >= B  # routes with more than one segment were met


def _tracked(states, b):
    veh = states.vehicles
    ok = (veh.kind[b] == KIND_IDM) & (veh.route_len[b] > 1)
    return int(torch.nonzero(ok)[0])


def _same_data(got, want, where):
    assert [r for r, _ in got] == [r for r, _ in want], where
    for (_, dg), (_, dw) in zip(got, want):
        assert dg.keys() == dw.keys(), where
        for key in dg:
            assert dg[key]["outputs"] == dw[key]["outputs"], f"{where} {key}"
            assert len(dg[key]["features"]) == len(dw[key]["features"])
            for fg, fw in zip(dg[key]["features"], dw[key]["features"]):
                np.testing.assert_array_equal(fg, fw, err_msg=f"{where} {key}")


def test_multiple_model_hypotheses_match_jax_over_a_rollout():
    s = _setup()
    ej, et = s["ej"], s["et"]
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    row = 1
    slot = _tracked(st, row)
    route = t_unc.route_of_slot(et, st, slot, row=row)
    ours = t_unc.MultipleModelTracker(et, slot, route=route, row=row)
    theirs = j_unc.MultipleModelTracker(ej, slot, route=route)
    grew = 0
    for t in range(TRACK_STEPS):
        ours.act(st)
        theirs.act(_jax_row(st, row))
        assert ours.route == theirs.route, f"step {t}"
        _same_data(ours.data, theirs.data, f"step {t}")
        grew = max(grew, len(ours.data))
        st = et.step_batched(st, random_actions(et, B, gen), gen)[1]
    assert grew >= 1 and all(d["lateral"]["features"] for _, d in ours.data)
    for index in (0, 5):
        ob, r, d = ours.assume_model_is_valid(st, index)
        jb, jr, jd = theirs.assume_model_is_valid(_jax_row(st, row), index)
        assert (ob.target_lane, r) == (jb.target_lane, jr)
        assert ob.target_speed == jb.target_speed
        for name in ("position", "speed", "heading"):
            np.testing.assert_array_equal(getattr(ob.interval, name), getattr(jb.interval, name))
    # the data-driven polytope of a hypothesis' lateral data
    a0, da = t_unc.polytope_from_estimation(d.get("lateral", {}), t_unc.STEERING_RANGE,
                                            t_unc.IntervalObserver._lateral_structure)
    ja0, jda = j_unc.polytope_from_estimation(jd.get("lateral", {}), j_unc.STEERING_RANGE,
                                              j_unc.IntervalObserver._lateral_structure)
    np.testing.assert_array_equal(a0, ja0)
    assert len(da) == len(jda) and all(np.array_equal(x, y) for x, y in zip(da, jda))


def _route_cols(states, slot, b):
    return {f: getattr(states.vehicles, f)[b, slot].numpy() for f in ROUTE_FIELDS}


@pytest.mark.parametrize("slot", [0, 2, 24], ids=["npc0", "npc2", "ego"])
def test_route_choice_per_row_matches_jax(slot):
    s = _setup()
    ej, et, st = s["ej"], s["et"], s["st"]
    rows = [_jax_row(st, b) for b in range(B)]
    changed = 0
    for to in OPTIONS:
        out = t_pre.set_route_at_intersection(et, st, slot, to)
        for b in range(B):
            want = j_pre.set_route_at_intersection(ej, rows[b], slot, to).vehicles
            got = _route_cols(out, slot, b)
            for f in ROUTE_FIELDS:
                np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f))[slot],
                                              err_msg=f"option {to} row {b} {f}")
            changed += not np.array_equal(got["route_base"],
                                          st.vehicles.route_base[b, slot].numpy())
        # every other slot and field untouched
        for f in dataclasses.fields(out.vehicles):
            a, c = getattr(out.vehicles, f.name), getattr(st.vehicles, f.name)
            keep = torch.ones(a.shape[1], dtype=torch.bool)
            if f.name in ROUTE_FIELDS:
                keep[slot] = False
            assert torch.equal(a[:, keep], c[:, keep]), f.name
    assert changed > 0
    # the rerouted batch steps
    gen = et.generator(9)
    out = t_pre.set_route_at_intersection(et, st, slot, 1)
    for _ in range(2):
        out = et.step_batched(out, random_actions(et, B, gen), gen)[1]
    assert bool(torch.isfinite(out.vehicles.pos).all())


def test_random_route_choice_draws_each_option_by_row():
    """``"random"``: each row's result is the JAX function's on that row
    with some option, and over many draws the options come about equally
    often."""
    s = _setup()
    ej, et, st = s["ej"], s["et"], s["st"]
    slot = 24
    n = [len(j_unc.routes_at_intersection(ej.net, j_unc.route_of_slot(ej, _jax_row(st, b), slot)))
         for b in range(B)]
    assert min(n) >= 2
    per_option = {b: [_route_cols(from_numpy_state(to_numpy_state(
        t_pre.set_route_at_intersection(et, st, slot, k))), slot, b)["route_base"].tolist()
        for k in range(n[b])] for b in range(B)}
    counts = np.zeros(max(n), int)
    gen = torch.Generator().manual_seed(11)
    for _ in range(60):
        out = t_pre.set_route_at_intersection(et, st, slot, "random", generator=gen)
        for b in range(B):
            k = per_option[b].index(_route_cols(out, slot, b)["route_base"].tolist())
            counts[k] += 1
    # 240 draws over 3 options: each within 4.5 standard deviations of 80
    assert len(counts) == 3 and np.all(np.abs(counts - 80) < 4.5 * np.sqrt(240 * 2 / 9)), counts
    # without a generator it draws from a fresh one
    out = t_pre.set_route_at_intersection(et, st, slot, "random")
    assert int(out.vehicles.route_ptr[0, slot]) == 0


def test_neighbour_slots_skip_landmarks_unlike_the_jax_package():
    """parking-v0 with the ego placed on the goal's lane, 4 m before it: the
    JAX tool returns the goal landmark as the ego's front neighbour (and its
    acceleration features brake for it), the port's returns none, as the
    reference's ``Road.neighbour_vehicles`` skips landmarks."""
    ej, et = hj.make("parking-v0"), ht.make("parking-v0", device="cpu")
    _, st = et.reset(1, et.generator(0))
    veh = st.vehicles
    goal = int(torch.nonzero(veh.kind[0] == KIND_LANDMARK)[0])
    index = et.net.lane_index_from_global(int(veh.lane[0, goal]))
    spec = et.net.get_lane(index)
    s_goal, _ = spec.local_coordinates(veh.pos[0, goal].numpy().astype(float))
    pos = veh.pos.clone()
    pos[0, 0] = torch.as_tensor(spec.position(s_goal - 4.0, 0.0), dtype=torch.float32)
    st = st.replace(vehicles=veh.replace(pos=pos))
    js = _jax_row(st, 0)
    assert j_unc.neighbour_slots(ej, js, 0, index) == (goal, None)
    assert t_unc.neighbour_slots(et, st, 0, index) == (None, None)
    assert j_unc.acceleration_features(ej, js, 0, index)[2] < 0
    assert t_unc.acceleration_features(et, st, 0, index)[2] == 0
