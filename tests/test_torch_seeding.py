"""The port's seeded reset against the JAX package's, on the CPU.

``highwayenv_tpu_torch/seeding.py`` replays the reference's NumPy draw
order on the host as ``highwayenv_tpu/seeding.py`` does.  For every
registered id but the intersection's (``test_torch_seeding_intersection.py``)
and seeds 0, 3 and 11: the host spawn records equal the JAX package's (count,
order, kinds, lane indices, routes; positions and speeds bit-equal in
float64), the (B=1) seeded state equals the JAX package's bit for bit on
every field, the seeded observation is within 1e-5, the generators stand at
the same draw after it, and two resets from one chained generator equal
the JAX package's two.  Lane-keeping runs with its observation noise off:
the JAX package draws it from its state's key, the port from the
``torch.Generator`` that ``generator_from`` derives.  Then ``np_random``
against Gymnasium's draw for draw, ``generator_from`` consuming no draw, and
the racetrack oval's random layout, which neither package replays.
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

SEEDS = (0, 3, 11)
IDS = [i for i in hj.registered_ids() if not i.startswith("intersection")]
#: lane-keeping's observation noise off (its draws differ by design)
QUIET = {"lane-keeping-v0": {"state_noise": 0.0, "derivative_noise": 0.0}}
OBS_ATOL = 1e-5
RECORD_FIELDS = [f.name for f in dataclasses.fields(st.HostVehicle)]


def _envs(env_id):
    config = QUIET.get(env_id)
    return hj.make(env_id, config), ht.make(env_id, config, device="cpu")


def _same_records(rec_t, rec_j, where: str) -> None:
    assert len(rec_t) == len(rec_j), where
    for k, (a, b) in enumerate(zip(rec_t, rec_j)):
        for name in RECORD_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if name == "position":
                assert x.dtype == y.dtype == np.float64 and np.array_equal(x, y), (where, k)
            else:
                assert x == y and type(x) is type(y), (where, k, name, x, y)


def _same_state(state_t, state_j, where: str) -> None:
    """Every field of the port's (B=1) state bit-equal to the JAX state's."""
    for f in dataclasses.fields(VehicleState):
        a = getattr(state_t.vehicles, f.name)[0].numpy()
        b = np.asarray(getattr(state_j.vehicles, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f.name)
    assert float(state_t.time[0]) == float(state_j.time) == 0.0, where
    assert int(state_t.steps[0]) == int(state_j.steps), where


def _close_obs(obs_t, obs_j, where: str) -> None:
    """The port's (B=1) observation within OBS_ATOL of the JAX one: a
    tensor, a dict key by key, a tuple element by element."""
    if isinstance(obs_t, dict):
        assert obs_t.keys() == obs_j.keys(), where
        for k in obs_t:
            _close_obs(obs_t[k], obs_j[k], f"{where} {k}")
    elif isinstance(obs_t, tuple):
        assert len(obs_t) == len(obs_j), where
        for k, (a, b) in enumerate(zip(obs_t, obs_j)):
            _close_obs(a, b, f"{where} {k}")
    else:
        np.testing.assert_allclose(obs_t[0].numpy(), np.asarray(obs_j), rtol=0,
                                   atol=OBS_ATOL, err_msg=where)


@pytest.mark.parametrize("env_id", IDS)
def test_torch_seeded_reset_matches_jax(env_id):
    ej, et = _envs(env_id)
    assert st.supports_seeded_reset(et) and sj.supports_seeded_reset(ej)
    for seed in SEEDS:
        where = f"{env_id} seed {seed}"
        # the host spawn records, then the generators' positions after them
        rj, rt = sj.np_random(seed), st.np_random(seed)
        _same_records(st._builder_for(et)(et, rt), sj._builder_for(ej)(ej, rj), where)
        assert rt.random() == rj.random(), where
        # the state and the observation, then two resets from one chain
        rj, rt = sj.np_random(seed), st.np_random(seed)
        for k in range(2):
            obs_j, state_j = sj.seeded_reset(ej, rj)
            obs_t, state_t = et.reset_seeded(rng=rt)
            _same_state(state_t, state_j, f"{where} reset {k}")
            _close_obs(obs_t, obs_j, f"{where} reset {k}")
            assert obs_t is not None and state_t.time.shape == (1,)
        assert rt.random() == rj.random(), where


def test_torch_np_random_matches_gymnasium():
    from gymnasium.utils import seeding as gym_seeding

    for seed in (0, 3, 11, 2**31 + 5):
        ours, theirs = st.np_random(seed), gym_seeding.np_random(seed)[0]
        assert ours.bit_generator.state == theirs.bit_generator.state
        np.testing.assert_array_equal(ours.random(64), theirs.random(64))
        np.testing.assert_array_equal(ours.integers(0, 7, 32), theirs.integers(0, 7, 32))
        np.testing.assert_array_equal(ours.normal(size=16), theirs.normal(size=16))
    for bad in (-1, 1.5, "3"):
        with pytest.raises(ValueError):
            st.np_random(bad)


def test_torch_generator_from_consumes_no_draw():
    rng, twin = st.np_random(7), st.np_random(7)
    rng.random(5), twin.random(5)
    g = st.generator_from(rng, "cpu")
    assert rng.random() == twin.random()
    # the same generator state gives the same torch generator; reseeding a
    # given generator gives that one
    a = st.generator_from(st.np_random(7), "cpu")
    b = st.generator_from(st.np_random(7), "cpu", generator=torch.Generator())
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert g.initial_seed() < 2**31 - 1
    # lane-keeping's reset noise comes from it: one seed, one noise
    env = ht.make("lane-keeping-v0", device="cpu")
    s1 = env.reset_seeded(seed=4)[1]
    s2 = env.reset_seeded(seed=4)[1]
    s3 = env.reset_seeded(seed=5)[1]
    assert torch.equal(s1.noise, s2.noise) and not torch.equal(s1.noise, s3.noise)
    assert float(s1.noise.abs().max()) <= 0.05


def _layout_seed(wide: bool) -> int:
    """The first seed whose generator draws an oval of 5 or 6 lanes
    (``wide``), or of at most 4, from ``integers(2, 7)``."""
    return next(s for s in range(100)
                if (int(np.random.default_rng(s).integers(2, 7)) >= 5) == wide)


def test_torch_oval_random_layout_not_replayed(monkeypatch):
    """Both packages draw the oval's random layout from an unseeded
    ``np.random.default_rng()``; the test seeds it for its duration, so
    both outcomes of the lane count are pinned: at most 4 lanes, and 5 or
    6 lanes (40 or 48 lanes in all, within the kernels' lane tables of 64),
    make in both packages and neither replays them."""
    real_rng = np.random.default_rng
    narrow, wide = _layout_seed(False), _layout_seed(True)
    cases = ((0, 3, 0), (100, 0, narrow), (100, 0, wide))
    for length, no_lanes, seed in cases:
        monkeypatch.setattr(np.random, "default_rng", lambda *_, s=seed: real_rng(s))
        config = {"length": length, "no_lanes": no_lanes}
        # the class itself: conftest.py memoizes ``hj.make`` across tests
        cls, kwargs = hj._REGISTRY["racetrack-oval-v0"]
        ej = cls(config={**kwargs.get("config", {}), **config})
        assert not sj.supports_seeded_reset(ej)
        if ej._oval_lanes >= 5:
            assert no_lanes == 0 and ej.geo.num_lanes == 8 * ej._oval_lanes > 32
        et = ht.make("racetrack-oval-v0", config, device="cpu")
        assert (et._oval_lanes, et._oval_length) == (ej._oval_lanes, ej._oval_length)
        assert et.geo.num_lanes == ej.geo.num_lanes
        assert not st.supports_seeded_reset(et)
        with pytest.raises(NotImplementedError):
            et.reset_seeded(seed=0)
