"""The port's GrayscaleObservation against the JAX package's, on the CPU.

``highwayenv_tpu_torch/observations/grayscale.py`` rasterizes the frame in
the step, from the state, as the JAX package's does, and keeps the DQN
frame stack in ``EnvState.obs_stack``.  Config: HighwayEnv's documented
example (observation_shape (128, 64), stack_size 4, the RGB weights, scaling
1.75).

  - frames: the port's ``frame`` and the JAX package's (jitted, vmapped) on
    the same states, bridged (a reset batch of 4 and two random steps), at
    highway-fast-v0, intersection-v0 and racetrack-v0 (curved chords,
    rotated ContinuousAction egos with tires), and at highway-v0 and
    parking-v0 at the env's scaling 5.5 (tires; the parking ego's colour):
    at least 99.9% of each frame's pixels equal and every pixel within 1
    gray level.  Found when written: every frame equal, pixel for pixel;
    the port reproduces XLA's float32 contractions (``fma``) and its
    correctly rounded cos / sin (``cos_sin``), without which 1 to 2 chord
    pixels a frame differed by 155 levels on curved lanes;
  - the stack: zeros then the reset's frame, then rolled by one a step
    (the JAX package's tests/envs/test_grayscale.py);
  - the autoreset step's head (the frame pushed, the done rows replaced by
    fresh stacks) against the JAX package's on the same simulated state
    over 3 steps, full and compact (P=1): the rows that go on equal
    exactly; a reset row holds three zero frames and the frame of its new
    scene, equal to the JAX package's frame of that scene;
  - where pygame imports, the port's rasterizer against the port's pygame
    backend (``GymEnv``, seeded reset and 5 steps) within the JAX package's
    own bounds (tests/parity/test_grayscale_divergence.py): at most 1.5% of
    the pixels off by more than 8 levels, PSNR at least 28 dB (found when
    written, the worst frame: highway-v0 0.51% and 31.33 dB,
    intersection-v0 1.03% and 29.72 dB, racetrack-v0 0.94% and 28.83 dB);
  - every registered id where the JAX package makes and steps it (all but
    lane-keeping-v0) makes, resets and steps a batch of 2 with the
    observation, the stack's shape and dtype as the space says.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.parallel.rollout import random_actions

torch.set_num_threads(1)

OBS = {
    "type": "GrayscaleObservation",
    "observation_shape": (128, 64),
    "stack_size": 4,
    "weights": [0.2989, 0.5870, 0.1140],
    "scaling": 1.75,
}
CFG = {"observation": OBS}
B = 4
MIN_EQUAL = 0.999
MAX_LEVELS = 1


def _jax_frames(ej):
    ot = ej.observation_type
    return jax.jit(jax.vmap(lambda v: ot.frame(ej.geo, v, ej.ego_slots[0])))


def _jax_vehicles(states):
    d = to_numpy_state(states)["vehicles"]
    return JaxVehicleState(**{k: jnp.asarray(v) for k, v in d.items()})


def _held(got, want, where) -> None:
    """At least MIN_EQUAL of each frame's pixels equal, none off by more
    than MAX_LEVELS gray levels."""
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, where
    diff = np.abs(got - want).reshape(got.shape[0], -1)
    equal = (diff == 0).mean(axis=1)
    assert equal.min() >= MIN_EQUAL, f"{where}: {equal.min():.5f} of the pixels equal"
    assert diff.max() <= MAX_LEVELS, f"{where}: a pixel {diff.max()} levels off"


@pytest.mark.parametrize("env_id,scaling", [
    ("highway-fast-v0", 1.75), ("intersection-v0", 1.75), ("racetrack-v0", 1.75),
    ("highway-v0", 5.5), ("parking-v0", 5.5),
])
def test_frames_match_jax(env_id, scaling):
    cfg = {"observation": {**OBS, "scaling": scaling}}
    et, ej = ht.make(env_id, cfg, device="cpu"), hj.make(env_id, cfg)
    frames_j = _jax_frames(ej)
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    for step in range(3):
        got = et.observation_type.frame(et.geo, st.vehicles, et.ego_slots[0])
        assert got.shape == (B, 128, 64) and got.dtype == torch.uint8
        _held(got.numpy(), frames_j(_jax_vehicles(st)), f"{env_id} step {step}")
        # the pushed frame is the stack's last
        assert torch.equal(st.obs_stack[:, -1], got)
        _, st, *_ = et.step_autoreset_batched(st, random_actions(et, B, gen), gen)


def test_torch_grayscale_stack_semantics():
    """The JAX package's test_grayscale_stack_semantics on the port: the
    stack starts zeroed, the reset pushes one frame, each step rolls it."""
    env = ht.make("highway-fast-v0", CFG, device="cpu")
    assert env.observation_space.shape == (4, 128, 64)
    gen = env.generator(0)
    obs, st = env.reset(1, gen)
    assert obs.shape == (1, 4, 128, 64) and obs.dtype == torch.uint8
    assert int(obs[0, :3].sum()) == 0 and int(obs[0, 3].sum()) > 0
    act = torch.full((1,), 3, dtype=torch.int32)
    o1, st, *_ = env.step_batched(st, act, gen)
    o2, st, *_ = env.step_batched(st, act, gen)
    assert torch.equal(o2[0, 2], o1[0, 3]) and torch.equal(o2[0, :2], o1[0, 1:3])
    frame = o2[0, 3].numpy()
    assert frame.max() > 200  # white lane markings
    assert frame.min() < 100  # the grey ground (99)
    w = np.array(OBS["weights"])
    vals = set(np.unique(frame).tolist())
    # the MDP ego green, the IDM traffic blue
    assert int(np.dot((50, 200, 0), w)) in vals and int(np.dot((100, 200, 255), w)) in vals


def _crashed_start(et, seed):
    """A reset batch in which every other ego has crashed: those episodes end
    at the next step."""
    _, st = et.reset(B, et.generator(seed))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, et.ego_slots[0]] = True
    return st.replace(vehicles=st.vehicles.replace(crashed=crashed))


@pytest.mark.parametrize("reset_slots", [None, 1])
def test_autoreset_stack_matches_jax(reset_slots):
    """The head of ``step_autoreset_batched`` on the port's simulated
    state against the JAX package's on the same state (``_finish_head``,
    then its full or compact autoreset and ``_observe``): done rows take
    the JAX package's reset scenes from its keys and the port's from its
    generator, so they are held by their structure."""
    et, ej = ht.make("highway-fast-v0", CFG, device="cpu"), hj.make("highway-fast-v0", CFG)
    frames_j = _jax_frames(ej)
    gen = et.generator(9)
    st = _crashed_start(et, 9)
    for step in range(3):
        acts = random_actions(et, B, gen)
        sim = et._simulate_batched(st, acts)
        d = to_numpy_state(sim)
        sim_j = JaxEnvState(
            vehicles=_jax_vehicles(sim), time=jnp.asarray(d["time"]),
            steps=jnp.asarray(d["steps"]), key=jax.random.split(jax.random.PRNGKey(step), B),
            obs_stack=jnp.asarray(d["obs_stack"]))
        acts_j = jnp.asarray(acts.numpy())
        st_j, _, term_j, trunc_j, _ = jax.vmap(ej._finish_head)(sim_j, acts_j)
        done_j = np.asarray(term_j | trunc_j)
        if reset_slots is None:
            out_t, _ = et._finish_autoreset(sim, acts, gen)
        else:
            out_t = et._autoreset_rest(*et._finish_autoreset(sim, acts, gen, reset_slots))
        obs_t, st, _, term_t, trunc_t, _ = out_t
        done = (term_t | trunc_t).numpy()
        np.testing.assert_array_equal(done, done_j)
        if step == 0:
            assert done[::2].all()
        obs_t = obs_t.numpy()
        assert np.array_equal(obs_t, st.obs_stack.numpy())
        keep = ~done
        where = f"step {step}"
        np.testing.assert_array_equal(obs_t[keep], np.asarray(st_j.obs_stack)[keep],
                                      err_msg=f"{where} rows that go on")
        if done.any():
            assert not obs_t[done, :3].any(), f"{where}: a reset stack starts zeroed"
            fresh = frames_j(_jax_vehicles(st))
            np.testing.assert_array_equal(obs_t[done, 3], np.asarray(fresh)[done],
                                          err_msg=f"{where} the reset rows' frame")


def _divergence(env_id):
    from highwayenv_tpu_torch.gym_env import GymEnv

    a = GymEnv(env_id, {"observation": {**OBS, "backend": "rasterizer"}}, device="cpu")
    b = GymEnv(env_id, {"observation": {**OBS, "backend": "pygame"}}, device="cpu")
    oa, _ = a.reset(seed=0)
    ob, _ = b.reset(seed=0)
    worst_frac, worst_psnr = 0.0, np.inf
    for step in range(6):
        if step:
            oa, *_ = a.step(1)
            ob, *_ = b.step(1)
        assert oa.shape == ob.shape == (4, 128, 64) and ob.dtype == np.uint8
        diff = np.abs(oa[-1].astype(float) - ob[-1].astype(float))
        mse = (diff ** 2).mean()
        worst_frac = max(worst_frac, (diff > 8).mean())
        worst_psnr = min(worst_psnr, 10 * np.log10(255 ** 2 / mse) if mse > 0 else np.inf)
    return worst_frac, worst_psnr


@pytest.mark.parametrize("env_id", ["highway-v0", "intersection-v0", "racetrack-v0"])
def test_rasterizer_against_the_pygame_backend(env_id, monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pytest.importorskip("pygame")
    frac, psnr = _divergence(env_id)
    assert frac <= 0.015, f"{env_id}: {frac:.4f} of the pixels off by more than 8"
    assert psnr >= 28.0, f"{env_id}: PSNR {psnr:.1f} dB"


#: every id but lane-keeping-v0, whose JAX env observes through the
#: AttributesObservation's ``observe_env`` alone and fails with a grayscale one
GRAY_IDS = [i for i in ht.registered_ids() if i != "lane-keeping-v0"]


@pytest.mark.parametrize("env_id", GRAY_IDS)
def test_every_id_makes_and_steps(env_id):
    et = ht.make(env_id, CFG, device="cpu")
    gen = et.generator(2)
    obs, st = et.reset(2, gen)
    assert obs.shape == (2, 4, 128, 64) and obs.dtype == torch.uint8
    obs, st, reward, *_ = et.step_autoreset_batched(st, random_actions(et, 2, gen), gen)
    assert obs.shape == (2,) + et.observation_space.shape
    assert torch.equal(obs, st.obs_stack) and bool(torch.isfinite(reward).all())
    # the bridge carries the stack both ways
    assert torch.equal(from_numpy_state(to_numpy_state(st)).obs_stack, st.obs_stack)
