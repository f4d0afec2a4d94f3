"""Poly lanes and the network's serialization in the port against the JAX
package, on the CPU.

- ``PolyLaneFixedWidth`` and ``PolyLane`` (host specs, float64 numpy) equal
  the JAX package's on 3 seeded polylines, at points before the start, along
  the lane and past its end;
- the port's sample bank (``geo.poly``) equals the JAX package's ``poly_*``
  tables, and the torch lane ops (``local_coordinates``, ``position``,
  ``heading_at``, ``width_at``, ``on_lane``) agree with the JAX ones within
  1e-5 of the value's magnitude, the winning pose index of the Frenet
  projection equal to the one the JAX rule picks;
- on a network of straight, circular and poly lanes, the analytic lanes'
  tables and results are bit-equal to those of the same network without the
  poly lane, and a network without one keeps no bank;
- ``to_config`` equals the JAX package's dict for every lane class, and
  ``from_config(to_config())`` rebuilds equal tables;
- ``make`` takes a network with a poly lane on both frame paths (the frame
  kernels and the sequential mode's plain frames), and it steps
  (``test_torch_custom_roads.py`` holds such a road to the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highwayenv_tpu.road import lane as j_lane
from highwayenv_tpu.road import network as j_net
from highwayenv_tpu_torch.envs.merge import MergeEnv
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.road import network as t_net

torch.set_num_threads(1)

SEEDS = [0, 1, 2]
TOL = 1e-5
N_POINTS = 512
BANK = ("slot", "pos", "normal", "n", "cp_s", "cp_x", "cp_y", "cp_n", "width")


def _polyline(seed):
    """Control points heading roughly along x with seeded turns, and two
    boundary curves at seeded half-widths on either side."""
    rng = np.random.default_rng(seed)
    n = 5 + seed
    x = np.cumsum(rng.uniform(6.0, 15.0, size=n)) - 6.0
    y = np.cumsum(rng.normal(scale=3.0, size=n))
    pts = np.stack([x, y], 1)
    half = rng.uniform(1.8, 3.0, size=n)[:, None]
    left = pts + half * np.array([0.0, 1.0])
    right = pts - half * np.array([0.0, 1.0])
    return pts.tolist(), left.tolist(), right.tolist()


def _specs(mod, seed):
    pts, left, right = _polyline(seed)
    return (mod.PolyLaneFixedWidth(pts, width=3.5 + 0.25 * seed, speed_limit=15.0),
            mod.PolyLane(pts, left, right, line_types=[2, 1]))


def _queries(lane, rng):
    """Positions around the lane: before its start, along it at seeded
    lateral offsets, past its end."""
    s = np.concatenate([rng.uniform(-8.0, 0.0, N_POINTS // 8),
                        rng.uniform(0.0, lane.length, 3 * N_POINTS // 4),
                        rng.uniform(lane.length, lane.length + 8.0, N_POINTS // 8)])
    lat = rng.uniform(-4.0, 4.0, s.shape[0])
    return s, np.stack([lane.position(si, li) for si, li in zip(s, lat)])


def _close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=where)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_specs_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    for ours, theirs in zip(_specs(t_net, seed), _specs(j_net, seed)):
        assert ours.length == theirs.length and ours.width == theirs.width
        np.testing.assert_array_equal(ours.width_samples(), theirs.width_samples())
        s, pos = _queries(theirs, rng)
        for si, p in zip(s[::16], pos[::16]):
            assert ours.local_coordinates(p) == theirs.local_coordinates(p)
            assert ours.heading_at(si) == theirs.heading_at(si)
            np.testing.assert_array_equal(ours.position(si, 1.25), theirs.position(si, 1.25))


def _jax_pose_index(geo, lane: int, pos):
    """The pose index the JAX package's ``_poly_frenet`` picks (its rule on
    its own tables): the highest index >= 1 with a non-negative projection,
    else 0."""
    p = int(np.asarray(geo.poly_slot)[lane])
    samples = jnp.asarray(np.asarray(geo.poly_pos)[p])
    normals = jnp.asarray(np.asarray(geo.poly_normal)[p])
    delta = jnp.asarray(pos, jnp.float32)[:, None, :] - samples
    proj = jnp.einsum("sd,...sd->...s", normals, delta, precision="highest")
    idxs = jnp.arange(samples.shape[0])
    valid = (idxs >= 1) & (idxs < int(np.asarray(geo.poly_n)[p])) & (proj >= 0)
    return np.asarray(jnp.max(jnp.where(valid, idxs, 0), axis=-1))


def _both_networks(seed):
    jn, tn = j_net.RoadNetworkBuilder(), t_net.RoadNetworkBuilder()
    for k, (a, b) in enumerate(zip(_specs(j_net, seed), _specs(t_net, seed))):
        jn.add_lane("p", f"q{k}", a)
        tn.add_lane("p", f"q{k}", b)
    return jn, tn


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_ops_match_jax(seed):
    jn, tn = _both_networks(seed)
    jg, tg = jn.build(), tn.build("cpu")
    for name in BANK:
        got = getattr(tg.poly, name).numpy()
        want = np.asarray(getattr(jg, "poly_" + name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    rng = np.random.default_rng(20 + seed)
    for lane, spec in enumerate(tn.lanes_on_edge("p", "q0") + tn.lanes_on_edge("p", "q1")):
        s_q, pos = _queries(spec, rng)
        pos32 = pos.astype(np.float32)
        lt = torch.full((pos.shape[0],), lane, dtype=torch.int32)
        lj = jnp.full((pos.shape[0],), lane, jnp.int32)
        s, lat = t_lane.local_coordinates(tg, lt, torch.from_numpy(pos32))
        js, jlat = j_lane.local_coordinates(jg, lj, jnp.asarray(pos32))
        where = f"seed {seed} lane {lane}"
        np.testing.assert_array_equal(
            t_lane.poly_pose_index(tg, lt, torch.from_numpy(pos32)).numpy(),
            _jax_pose_index(jg, lane, pos32), err_msg=f"{where} pose index")
        _close(s, js, f"{where} s")
        _close(lat, jlat, f"{where} lat")
        sq = torch.from_numpy(s_q.astype(np.float32))
        la = torch.from_numpy(np.linspace(-3, 3, s_q.shape[0]).astype(np.float32))
        _close(t_lane.position(tg, lt, sq, la),
               j_lane.position(jg, lj, jnp.asarray(sq.numpy()), jnp.asarray(la.numpy())),
               f"{where} position")
        _close(t_lane.heading_at(tg, lt, sq), j_lane.heading_at(jg, lj, jnp.asarray(sq.numpy())),
               f"{where} heading")
        _close(t_lane.width_at(tg, lt, sq), j_lane.width_at(jg, lj, jnp.asarray(sq.numpy())),
               f"{where} width")
        np.testing.assert_array_equal(
            t_lane.on_lane(tg, lt, s, lat).numpy(),
            np.asarray(j_lane.on_lane(jg, lj, jnp.asarray(s.numpy()), jnp.asarray(lat.numpy()))),
            err_msg=f"{where} on_lane")
    # both ends are reached: points before the start and past the end
    assert bool((s < 0).any()) and bool((s > spec.length).any())


def _mixed(with_poly: bool):
    net = t_net.RoadNetworkBuilder()
    net.add_lane("a", "b", t_net.StraightLane([0.0, 0.0], [100.0, 0.0]))
    net.add_lane("a", "b", t_net.StraightLane([0.0, 4.0], [100.0, 4.0]))
    net.add_lane("b", "c", t_net.CircularLane([100.0, 30.0], 30.0, -np.pi / 2, 0.0))
    net.add_lane("c", "d", t_net.SineLane([130.0, 30.0], [130.0, 130.0], 2.0, 0.1, 0.0))
    if with_poly:
        net.add_lane("d", "e", _specs(t_net, 0)[0])
    return net.build("cpu")


def test_analytic_lanes_unchanged_beside_a_poly_lane():
    with_poly, without = _mixed(True), _mixed(False)
    assert without.poly is None and with_poly.poly is not None
    assert not with_poly.all_straight and not without.all_straight
    L = without.num_lanes
    for name, a in zip(without._fields, without):
        b = getattr(with_poly, name)
        if name in ("succ_edge_base", "succ_edge_n", "conn_lanes", "conn_offsets",
                    "to_node", "from_node"):
            continue  # the poly edge is a successor of "c" -> "d"
        assert torch.equal(b[:L], a), name
    rng = np.random.default_rng(3)
    lane = torch.from_numpy(rng.integers(0, L, 256).astype(np.int32))
    pos = torch.from_numpy(rng.uniform([-10, -10], [150, 140], (256, 2)).astype(np.float32))
    for geo_a, geo_b in ((without, with_poly),):
        sa, la = t_lane.local_coordinates(geo_a, lane, pos)
        sb, lb = t_lane.local_coordinates(geo_b, lane, pos)
        assert torch.equal(sa, sb) and torch.equal(la, lb)
        assert torch.equal(t_lane.position(geo_a, lane, sa, la), t_lane.position(geo_b, lane, sa, la))
        assert torch.equal(t_lane.heading_at(geo_a, lane, sa), t_lane.heading_at(geo_b, lane, sa))
        assert torch.equal(t_lane.width_at(geo_a, lane, sa), t_lane.width_at(geo_b, lane, sa))
        assert torch.equal(t_lane.on_lane(geo_a, lane, sa, la), t_lane.on_lane(geo_b, lane, sa, la))
        ta, tb = t_lane.projection_table(geo_a, pos[None]), t_lane.projection_table(geo_b, pos[None])
        assert torch.equal(ta[0], tb[0][:, :L]) and torch.equal(ta[1], tb[1][:, :L])


def _all_classes(mod):
    """One lane of every class, edges grouped by their from-node."""
    net = mod.RoadNetworkBuilder()
    net.add_lane("a", "b", mod.StraightLane([0.0, 0.0], [50.0, 0.0], line_types=[3, 0],
                                            speed_limit=None, priority=2))
    net.add_lane("a", "b", mod.SineLane([0.0, 4.0], [50.0, 4.0], 1.5, 0.2, 0.3, forbidden=True))
    net.add_lane("b", "c", mod.CircularLane([50.0, 20.0], 20.0, -np.pi / 2, 0.0, clockwise=True,
                                            width=3.5))
    fixed, poly = _specs(mod, 1)
    net.add_lane("c", "d", fixed)
    net.add_lane("c", "e", poly)
    return net


def test_to_config_matches_jax_and_round_trips():
    ours, theirs = _all_classes(t_net), _all_classes(j_net)
    cfg = ours.to_config()
    assert cfg == theirs.to_config()
    names = [lc.get("class_path") or lc.get("class_name")
             for to in cfg.values() for lanes in to.values() for lc in lanes]
    assert names == ["highway_env.road.lane.StraightLane", "highway_env.road.lane.SineLane",
                     "highway_env.road.lane.CircularLane", "PolyLaneFixedWidth", "PolyLane"]
    back = t_net.RoadNetworkBuilder.from_config(cfg)
    assert back.to_config() == cfg
    g0, g1 = ours.build("cpu"), back.build("cpu")
    for name, a in zip(g0._fields, g0):
        assert torch.equal(getattr(g1, name), a), name
    for name in BANK:
        assert torch.equal(getattr(g1.poly, name), getattr(g0.poly, name)), name
    # the JAX package reads the port's config back into the same lanes
    jback = j_net.RoadNetworkBuilder.from_config(cfg)
    assert jback.to_config() == cfg
    with pytest.raises(ValueError, match="Unknown lane class"):
        t_net.lane_from_config({"class_name": "NoSuchLane", "config": {}})


class PolyMerge(MergeEnv):
    """merge-v0 with a poly lane after its end."""

    def _build_scene(self):
        super()._build_scene()
        self.net.add_lane("d", "e", _specs(t_net, 0)[0])
        self.geo = self.net.build(device=self.device)


@pytest.mark.parametrize("config", [None, {"sequential_decisions": True}],
                         ids=["kernel", "sequential"])
def test_make_takes_poly_lanes(config):
    env = PolyMerge(config=config, device="cpu")
    assert env.geo.poly is not None and MergeEnv(config=config, device="cpu").geo.poly is None
    assert env._general.sequential == (config is not None)
    # the kernels' tables (the kSized layout) carry the poly lane's bank row
    S = env.geo.succ_edge_base.shape[1]
    assert general_frames.launch_tables(S, None, True) == (S, 0, True)
    _, li = general_frames.lane_tables(env.geo, "cpu")
    assert li.shape[1] == general_frames.lane_i_words(S, True)
    poly = (env.geo.kind == t_lane.POLY).nonzero()[:, 0]
    assert li[poly, general_frames.LANE_I_SUCC + 2 * S + 1].tolist() == [0]
    assert (li[:, -1] >= 0).sum() == 1
    gen = env.generator(0)
    _, st = env.reset(2, gen)
    _, st, reward, *_ = env.step_batched(st, random_actions(env, 2, gen), gen)
    assert bool(torch.isfinite(st.vehicles.pos).all()) and bool(torch.isfinite(reward).all())
