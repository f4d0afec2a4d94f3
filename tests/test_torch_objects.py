"""Obstacles, landmarks and plain ``Vehicle`` rows on a straight road, in
the port against the JAX package, on the CPU.

An env made with ``lean=False`` (the JAX package's ``pallas_lean =
False``) steps its frames through ``straight_frames.simulate_bm`` with
``objects=True``: on CPU tensors ``frames_plain``, the plain version of
K1's objects instantiation, which chip_smoke.py holds the kernel to on the
card.  It is compared over 3 policy steps, on the scenes of
``highwayenv_tpu_torch/tools/object_scenes.py``, with both JAX paths: the
non-lean K1 (``pallas_simulate_bm`` in interpret mode, on a JAX env whose
``pallas_lean`` is set before its first call: the JAX frame cache keys on
the env, not on the flag) and the XLA frame scan of
``BaseEnv._simulate_batched``.  The env's ``step_batched`` and
``step_autoreset_batched`` are held to the JAX ``step_batched``.  A lean
env refuses such rows on both its paths; a scene of plain ``Vehicle`` rows
is lean and still steps on the sorted path.

Tolerances are those of tests/test_torch_straight_frames.py, discrete
fields exact, other continuous fields 1e-4 of the field's magnitude, obs
and reward 1e-5, but for pos: 2e-4 m plus ``POS_ULPS`` float32 ulps of the
coordinate's magnitude.  A crashed vehicle stuck on an obstacle takes the
full SAT translation every frame, computed from absolute coordinates (the
projections cancel to the overlap, about 1 m, from positions of hundreds
of metres), so the JAX package's own two paths already differ there by
about an ulp of the coordinate a frame: 2.4e-4 m at x = 526 m (4 ulps)
after a step, between its interpret-mode K1 and its XLA frames alike.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops.straight_pallas_bm import pallas_simulate_bm
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import straight_frames, straight_sorted
from highwayenv_tpu_torch.tools import object_scenes
from highwayenv_tpu_torch.vehicle.controller import MAX_STEERING_ANGLE
from highwayenv_tpu_torch.vehicle.state import (
    KIND_LANDMARK,
    KIND_OBSTACLE,
    KIND_PLAIN,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
STEPS = 3
ENV_ID = "highway-v0"
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending", "speed_index", "kind")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
HEAD_ATOL = 1e-5
#: float32 ulps of a coordinate's magnitude that pos may differ by, beyond
#: 2e-4 m: one a frame of a 15-frame step (module docstring)
POS_ULPS = 16

_SETUP: dict = {}


def _setup():
    """The non-lean JAX env, its jitted interpret-mode K1, XLA frames and
    ``step_batched``, and a reset batch; built once per test process."""
    if not _SETUP:
        # an instance of its own: the suite's conftest memoizes hj.make, and
        # the flag must not reach other tests' envs
        base = hj.make(ENV_ID)
        ej = type(base)(config=base.config)
        ej.pallas_lean = False  # before the first call: the frame cache ignores it
        _, states = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(1), B))

        def pal(veh, acts):
            sa = jax.vmap(ej._action_to_slots)(acts)
            return pallas_simulate_bm(ej, veh, sa, ej.frames_per_step, block=B, interpret=True)

        _SETUP.update(ej=ej, states=states, pal=jax.jit(pal),
                      xla=jax.jit(ej._simulate_batched), step=jax.jit(ej.step_batched))
    return _SETUP


def _numpy_state(states) -> dict:
    return {
        "vehicles": {f.name: np.asarray(getattr(states.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _scene(name, rows_from=None):
    """The JAX reset batch rewritten into scene ``name``; with
    ``rows_from``, the second half of the rows from that scene instead."""
    states = _setup()["states"]
    veh = states.vehicles
    fields = {k: np.asarray(getattr(veh, k)) for k in object_scenes.FIELDS}
    arrays = object_scenes.object_scene(fields, name)
    if rows_from is not None:
        other = object_scenes.object_scene(fields, rows_from)
        for k in arrays:
            arrays[k][B // 2:] = other[k][B // 2:]
    return states.replace(vehicles=veh.replace(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def _assert_close(port, ref, where, clip_steering=False, rows=None):
    rows = slice(None) if rows is None else rows
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(port, name).numpy()[rows],
                                      np.asarray(getattr(ref, name))[rows],
                                      err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        a = getattr(port, name).numpy().astype(np.float64)[rows]
        b = np.asarray(getattr(ref, name)).astype(np.float64)[rows]
        if name == "steering" and clip_steering:
            # the XLA straight frame stores the ego's P-cascade steering
            # unclipped (highwayenv_tpu/ops/straight_fast.py:410)
            b = np.clip(b, -MAX_STEERING_ANGLE, MAX_STEERING_ANGLE)
        if name == "pos":
            np.testing.assert_allclose(a, b, rtol=POS_ULPS * float(np.finfo(np.float32).eps),
                                       atol=2e-4, err_msg=f"{where}: {name}")
            continue
        tol = 1e-4 * max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def _port(sj):
    return from_numpy_state(_numpy_state(sj))


@pytest.mark.parametrize("scene", object_scenes.SCENES)
def test_objects_frames_match_jax_non_lean_and_xla(scene):
    """3 policy steps of the ``lean=False`` env's frames against the JAX
    non-lean K1 (interpret) and the XLA frames: obstacles stay put, a
    landmark overlapped by a vehicle is hit, vehicles crash into obstacles
    and take the full translation."""
    s = _setup()
    et = ht.make(ENV_ID, device="cpu", lean=False)
    sj = _scene(scene)
    veh_t, veh_p, st_x = _port(sj).vehicles, sj.vehicles, sj
    kind = veh_t.kind.clone()
    obstacle, landmark = kind == KIND_OBSTACLE, kind == KIND_LANDMARK
    still = veh_t.pos[obstacle | landmark].clone()
    k1 = straight_frames.frames_kernel
    before = k1.launches
    rng = np.random.default_rng(7)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        veh_t = straight_frames.simulate_bm(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)), et.frames_per_step)
        veh_p = s["pal"](veh_p, jnp.asarray(acts))
        st_x = s["xla"](st_x, jnp.asarray(acts))
        _assert_close(veh_t, veh_p, f"{scene} step {t} vs the non-lean K1 (interpret)")
        _assert_close(veh_t, st_x.vehicles, f"{scene} step {t} vs XLA", clip_steering=True)
    assert k1.launches == before  # CPU tensors: the plain version
    assert torch.equal(veh_t.pos[obstacle | landmark], still)
    if scene in ("obstacle", "pileup"):
        assert bool(veh_t.crashed[obstacle].any())  # a vehicle ran into an obstacle
    if scene in ("landmark", "pileup"):
        assert bool(veh_t.hit[landmark].any()) and not bool(veh_t.hit[~landmark].any())
    if scene == "plain":
        assert bool((veh_t.kind == KIND_PLAIN).any()) and not bool(veh_t.hit.any())


@pytest.mark.parametrize("autoreset", [False, True], ids=["step_batched", "autoreset"])
def test_lean_false_env_steps_match_jax(autoreset):
    """``make(..., lean=False)``'s ``step_batched`` / ``step_autoreset_batched``
    against the JAX ``step_batched`` over 3 steps, from a batch of pile-up
    rows (whose egos crash) and landmark rows (whose egos run over a
    landmark): obs, reward, terminated, truncated and the state, over the
    rows no step has ended (the autoreset places new scenes there, from the
    port's generator)."""
    s = _setup()
    et = ht.make(ENV_ID, device="cpu", lean=False)
    assert not et.lean and ht.make(ENV_ID, device="cpu").lean
    sj = _scene("pileup", rows_from="landmark")
    st = _port(sj)
    rng = np.random.default_rng(11)
    gen = et.generator(0)
    live = np.ones(B, bool)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        call = et.step_autoreset_batched if autoreset else et.step_batched
        obs_t, st, rew_t, term_t, trunc_t, _ = call(st, torch.from_numpy(acts), gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = s["step"](sj, jnp.asarray(acts))
        where = f"{'autoreset' if autoreset else 'step_batched'} step {t}"
        np.testing.assert_array_equal(term_t.numpy()[live], np.asarray(term_j)[live],
                                      err_msg=where)
        np.testing.assert_array_equal(trunc_t.numpy()[live], np.asarray(trunc_j)[live],
                                      err_msg=where)
        np.testing.assert_allclose(rew_t.numpy()[live], np.asarray(rew_j)[live], rtol=0,
                                   atol=HEAD_ATOL, err_msg=f"{where}: reward")
        if autoreset:  # rows never done: the reset rows go their own way
            live &= ~(term_t | trunc_t).numpy()
        np.testing.assert_allclose(obs_t.numpy()[live], np.asarray(obs_j)[live], rtol=0,
                                   atol=HEAD_ATOL, err_msg=f"{where}: obs")
        _assert_close(st.vehicles, sj.vehicles, where, clip_steering=True, rows=live)
    if autoreset:  # some rows were reset, some went on
        assert live.any() and not live.all()
    assert bool(st.vehicles.hit.any())


@pytest.mark.parametrize("kind", [KIND_OBSTACLE, KIND_LANDMARK], ids=["obstacle", "landmark"])
def test_lean_steps_refuse_object_rows(kind):
    """A lean env (the default) refuses an obstacle or landmark row on its
    sorted and its dense step, and each lean wrapper refuses it, rather than
    answer by the vehicles-only collision rule (``report`` below prints
    that answer against the XLA frames)."""
    states = _port(_setup()["states"])
    veh = states.vehicles
    k = veh.kind.clone()
    k[:, 5] = kind
    states = states.replace(vehicles=veh.replace(kind=k))
    acts = torch.ones(B, dtype=torch.int32)
    for sorted_frames in (True, False):
        et = ht.make(ENV_ID, device="cpu", sorted_frames=sorted_frames)
        with pytest.raises(ValueError, match="lean=False"):
            et.step_batched(states, acts, et.generator(0))
    et = ht.make(ENV_ID, device="cpu")
    fs, p, dt, frames = et._straight, et.idm_params, et.dt, et.frames_per_step
    v = states.vehicles
    srt, idx = straight_sorted.sort_kernel(v, fs)
    with pytest.raises(ValueError, match="lean=False"):
        straight_sorted.frames_sorted_kernel(srt, idx, fs, p, dt, frames)
    with pytest.raises(ValueError, match="lean=False"):
        straight_frames.frames_kernel(v, fs, p, dt, frames)
    mask = torch.ones(B, dtype=torch.bool)
    with pytest.raises(ValueError, match="lean=False"):
        straight_frames.frames_kernel(v, fs, p, dt, frames, mask=mask, out=v)
    out = straight_frames.frames_kernel(v, fs, p, dt, frames, objects=True)
    assert torch.equal(out.pos[:, 5], v.pos[:, 5])  # the object stays put


def test_plain_vehicle_rows_are_lean():
    """Plain ``Vehicle`` rows are vehicles: a lean env steps them on its
    sorted path, and agrees with the JAX ``step_batched`` over 3 steps."""
    s = _setup()
    et = ht.make(ENV_ID, device="cpu")
    assert et.sorted_frames and et.lean
    sj = _scene("plain")
    st = _port(sj)
    assert bool((st.vehicles.kind == KIND_PLAIN).any())
    k = (straight_sorted.sort_kernel, straight_sorted.frames_sorted_kernel,
         straight_sorted.unsort_kernel)
    before = [w.launches for w in k]
    rng = np.random.default_rng(5)
    gen = et.generator(0)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        obs_t, st, rew_t, term_t, trunc_t, _ = et.step_batched(st, torch.from_numpy(acts), gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = s["step"](sj, jnp.asarray(acts))
        where = f"plain rows, sorted step {t}"
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
        np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), rtol=0, atol=HEAD_ATOL,
                                   err_msg=f"{where}: reward")
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0, atol=HEAD_ATOL,
                                   err_msg=f"{where}: obs")
        _assert_close(st.vehicles, sj.vehicles, where, clip_steering=True)
    assert [w.launches for w in k] == before  # CPU tensors: the plain versions


def test_object_scenes_carry_to_the_port():
    """``object_state`` of a port state equals the bridged JAX scene, and
    every scene holds the rows it names."""
    assert getattr(hj.make(ENV_ID), "pallas_lean", True)  # the shared env stays lean
    states = _port(_setup()["states"])
    for name in object_scenes.SCENES:
        got = object_scenes.object_state(states.vehicles, name)
        want = _port(_scene(name)).vehicles
        for k in object_scenes.FIELDS:
            assert torch.equal(getattr(got, k), getattr(want, k)), (name, k)
    kinds = {n: set(torch.unique(object_scenes.object_state(states.vehicles, n).kind).tolist())
             for n in object_scenes.SCENES}
    assert KIND_OBSTACLE in kinds["obstacle"] and KIND_LANDMARK in kinds["landmark"]
    assert KIND_PLAIN in kinds["plain"]
    assert {KIND_OBSTACLE, KIND_LANDMARK, KIND_PLAIN} <= kinds["pileup"]


def report():
    """Print what the lean steps answer on a scene with every kind of
    object row (the obstacle, landmark and plain scenes at once), one
    policy step against the JAX XLA frames: the port's sorted step as it
    ran before it refused such rows (its plain versions, which check
    nothing), the JAX package's lean K1 (interpret), and the port's
    ``lean=False`` step."""
    s = _setup()
    states = s["states"]
    veh = states.vehicles
    fields = {k: np.asarray(getattr(veh, k)) for k in object_scenes.FIELDS}
    for name in ("obstacle", "landmark", "plain"):
        fields = object_scenes.object_scene(fields, name)
    sj = states.replace(vehicles=veh.replace(**{k: jnp.asarray(v) for k, v in fields.items()}))
    acts = np.ones(B, np.int32)
    ref = s["xla"](sj, jnp.asarray(acts)).vehicles
    et = ht.make(ENV_ID, device="cpu", lean=False)
    v = et.action_type.apply(et.geo, _port(sj).vehicles, _port(sj).vehicles.kind == 1,
                             et._action_to_slots(torch.from_numpy(acts)))
    fs, p, dt, frames = et._straight, et.idm_params, et.dt, et.frames_per_step
    srt, idx = straight_sorted.sort_plain(v, fs)
    band, flags = straight_sorted.frames_sorted_plain(srt, idx, fs, p, dt, frames)
    lean_sorted = straight_frames._masked_plain(
        v, fs, p, dt, frames, flags.any(dim=1), straight_sorted.unsort_plain(band, idx, v))
    ej = hj.make(ENV_ID)  # pallas_lean left true: the JAX lean K1 (report runs alone)
    lean_jax = pallas_simulate_bm(ej, sj.vehicles, jax.vmap(ej._action_to_slots)(
        jnp.asarray(acts)), frames, block=B, interpret=True)
    port = straight_frames.simulate_bm(et, _port(sj).vehicles,
                                       et._action_to_slots(torch.from_numpy(acts)), frames)
    obst = fields["kind"] == KIND_OBSTACLE
    for label, out in (("the port's lean sorted step (plain versions)", lean_sorted),
                       ("the JAX lean K1 (interpret)", lean_jax),
                       ("the port's lean=False step", port)):
        pos = np.asarray(out.pos, np.float64)
        gap = np.abs(pos - np.asarray(ref.pos, np.float64)).max()
        imp = np.abs(np.asarray(out.impact, np.float64) - np.asarray(ref.impact)).max()
        moved = np.abs(pos[obst] - fields["pos"][obst]).max()
        same = {n: bool((np.asarray(getattr(out, n)) == np.asarray(getattr(ref, n))).all())
                for n in ("crashed", "hit", "impact_pending")}
        print(f"{label} against XLA after one step: pos {gap:.4g} m, impact {imp:.4g}; "
              f"obstacles moved {moved:.4g} m; equal {same}")


if __name__ == "__main__":
    # python tests/test_torch_objects.py (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    report()
