"""Batched env core: policy-step simulation, heads and autoreset.

PyTorch counterpart of the main-path subset of
``highwayenv_tpu/envs/base.py``.  Every state is a batch: an ``EnvState``
holds (B, ...) tensors and every method works on the whole batch, where the
JAX package writes single-env functions and vmaps them.  Randomness comes
from an explicit ``torch.Generator`` argument instead of a per-env PRNG key
carried in the state.

A policy step is ``sim_freq // policy_freq`` frames.  ``_simulate_batched``
runs them, as the JAX package does:

  - on a straight parallel-lane network (highway) through
    ``ops/straight_sorted.simulate_bm_sorted`` (sort, banded frames, unsort
    and the dense frame kernel on the envs whose band flags fired: four CUDA
    kernels on the card), or with ``sorted_frames=False`` through
    ``ops/straight_frames.simulate_bm`` (the dense frame kernel alone, the
    JAX package's ``HT_NO_SORTED=1``); an env made with ``lean=False`` (the
    JAX package's ``pallas_lean = False``: obstacle and landmark rows
    possible) always steps the dense frame kernel's objects instantiation,
    since the sorted kernels take vehicles only;
  - on any other analytic-lane network the general gate admits
    (roundabout, merge, racetrack) through
    ``ops/general_frames.simulate_general`` (one launch of the general
    frame kernel, the ego meta-action inside, or a ContinuousAction's
    controls stored before it and kept by the frames);
    on a regulated road (intersection) the same with the right-of-way pass
    on each env's tick frames, which ``simulate_general`` reads from the
    envs' frame counters (one launch of the regulated kernel).

``_simulate`` runs them through the plain torch loops on any device:
``simulate_frames_reference`` or ``simulate_general_reference``.

Under a Linear-family ``other_vehicles_type`` (``NPC_PRESETS``) every
placed scene's IDM NPCs become Linear NPCs of the preset
(``_apply_npc_type`` in ``_place_state``, so the full and the compact
autoreset alike), and ``linear_rows`` sends the frames to the kernels'
Linear rows' instantiation.

The batched API of the JAX package's ``BaseEnv``: ``reset_batch``,
``step_batched`` (no autoreset) and ``step_autoreset_batched``, whose
``reset_slots=P`` replaces the done rows with the same scenes as the full
autoreset while placing only them, P at a time.  A reset is split into its
draws (``_reset_draws``, every generator call) and their placement
(``_place_vehicles``, row-local), which is what makes that exact.  The
autoreset step is written as a part with no host sync
(``_autoreset_first``), which ``parallel/graph.py`` captures as a CUDA
graph, and the rest (``_autoreset_rest``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple

import torch

from highwayenv_tpu_torch.ops import general_frames, straight_fast, straight_frames
from highwayenv_tpu_torch.ops.straight_frames import frames_plain, simulate_bm
from highwayenv_tpu_torch.ops.straight_sorted import simulate_bm_sorted
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road import regulation
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LINEAR,
    VehicleState,
)

#: NPC class presets of ``other_vehicles_type``: the LinearVehicle
#: acceleration parameters and the MOBIL gain of each class (reference
#: vehicle/behavior.py ``LinearVehicle``, ``AggressiveVehicle``,
#: ``DefensiveVehicle``; the JAX package's ``BaseEnv._NPC_PRESETS``)
NPC_PRESETS = {
    "LinearVehicle": ((0.3, 0.3, 2.0), 0.2),
    "AggressiveVehicle": ((0.8 / (0.25 * 30), 0.8 / (0.75 * 30), 0.5), 1.0),
    "DefensiveVehicle": ((1.2 / (0.25 * 30), 1.2 / (0.75 * 30), 2.0), 1.0),
}


def with_preset(veh: VehicleState, mask: torch.Tensor, name: str) -> VehicleState:
    """``veh`` with the rows of the (B, V) ``mask`` made Linear NPCs of the
    preset ``name``: kind, acceleration parameters and MOBIL gain; the
    steering parameters keep their values."""
    accel_params, gain = NPC_PRESETS[name]
    params = veh.accel_params.clone()
    for k, x in enumerate(accel_params):
        params[..., k] = torch.where(mask, x, params[..., k])
    return veh.replace(
        kind=torch.where(mask, KIND_LINEAR, veh.kind).to(torch.int32),
        accel_params=params,
        mobil_gain=torch.where(mask, gain, veh.mobil_gain),
    )


@dataclasses.dataclass
class EnvState:
    vehicles: VehicleState
    time: torch.Tensor  # (B,) f32, simulation time [s]
    steps: torch.Tensor  # (B,) i32, simulation frames executed
    #: (B, stack, W, H) uint8, the GrayscaleObservation's frame stack (None
    #: under any other observation)
    obs_stack: torch.Tensor | None = None

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Refuses CUDA when it is absent: the CPU runs
    only when the caller asks for it.  A CUDA device without an index is
    named (the current one): tensors made on a bare ``"cuda"`` go to
    whichever card is current when they are made, which with several cards
    is not always the env's."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def map_fields(fn, *states):
    """``fn`` applied tensor by tensor over EnvStates (or VehicleStates) of
    one structure: a state of its results.  A field that is None (the frame
    stack of an env without one) stays None."""
    out = {}
    for f in dataclasses.fields(states[0]):
        values = [getattr(s, f.name) for s in states]
        if values[0] is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(values[0]):
            out[f.name] = map_fields(fn, *values)
        else:
            out[f.name] = fn(*values)
    return type(states[0])(**out)


def _rows(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (B,) or (P,) row mask shaped to broadcast over ``t``."""
    return mask.view(mask.shape + (1,) * (t.dim() - 1))


def map_obs(fn, *obs):
    """``fn`` over observations of one structure: a tensor, a dict of them
    (KinematicsGoal) key by key, or a tuple of them (one per ego of a
    multi-agent observation) element by element."""
    if isinstance(obs[0], dict):
        return {k: map_obs(fn, *(o[k] for o in obs)) for k in obs[0]}
    if isinstance(obs[0], tuple):
        return tuple(map_obs(fn, *parts) for parts in zip(*obs, strict=True))
    return fn(*obs)


def where_done(done: torch.Tensor, new, old):
    """Row select over every tensor of two EnvStates (or VehicleStates)."""
    return map_fields(lambda a, b: torch.where(_rows(done, b), a, b), new, old)


def take_rows(state, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of an EnvState (or VehicleState)."""
    return map_fields(lambda t: t[idx], state)


def scatter_rows(old, idx: torch.Tensor, valid: torch.Tensor, new):
    """``old`` (an EnvState or VehicleState) with row ``idx[p]`` replaced by
    row p of ``new`` where ``valid[p]``; ``idx`` holds distinct rows."""
    return map_fields(
        lambda a, b: a.index_copy(0, idx, torch.where(_rows(valid, a), b, a[idx])),
        old, new,
    )


def simulate_frames_reference(
    env, veh: VehicleState, slot_actions: torch.Tensor, frames: int
) -> VehicleState:
    """Policy-step simulation in plain torch on any device: the ego
    meta-action (or the stored raw controls of a ContinuousAction), then
    ``frames`` frames of ``frames_plain``.  The counterpart of the JAX
    package's XLA frame scan; the kernel path (``simulate_bm``) is held
    against it."""
    veh = env.action_type.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions)
    return frames_plain(veh, env._straight, env.idm_params, env.dt, frames,
                        raw=env.action_type.stores_raw_controls)


class BaseEnv:
    """Config surface mirrors the reference AbstractEnv.

    Batched API: ``reset(batch_size, generator) -> (obs, EnvState)`` (also
    ``reset_batch``), ``step_autoreset_batched(states, actions, generator,
    reset_slots=None)`` and ``step_batched(states, actions, generator)``,
    each ``-> (obs, EnvState, reward, terminated, truncated, info)``.
    """

    #: initial value of the frame counter
    _initial_steps = 0

    #: RegulatedRoad envs (the right-of-way pass in the frames) set this
    regulated = False

    #: envs whose several controlled vehicles are ported (highway, parking,
    #: racetrack and intersection families) set this; the others refuse
    #: ``controlled_vehicles`` > 1
    several_egos = False

    def __init__(self, config: dict | None = None, device=None,
                 sorted_frames: bool = True, lean: bool = True):
        self.device = resolve_device(device)
        #: frames on the s-sorted banded path (default) or dense
        self.sorted_frames = sorted_frames
        #: vehicles only on a straight road (the JAX package's
        #: ``pallas_lean``); False: obstacle and landmark rows possible, the
        #: frames on the dense kernel's objects instantiation.  A general
        #: env's kernels always resolve objects, so there it changes nothing
        self.lean = lean
        self.config = self.default_config()
        self.configure(config)
        self._build()

    @classmethod
    def default_config(cls) -> dict:
        """Reference envs/common/abstract.py ``default_config``."""
        return {
            "observation": {"type": "Kinematics"},
            "action": {"type": "DiscreteMetaAction"},
            "simulation_frequency": 15,
            "policy_frequency": 1,
            "other_vehicles_type": "highway_env.vehicle.behavior.IDMVehicle",
            "screen_width": 600,
            "screen_height": 150,
            "centering_position": [0.3, 0.5],
            "scaling": 5.5,
            "show_trajectories": False,
            "render_agent": True,
            "offscreen_rendering": None,
            "manual_control": False,
            "real_time_rendering": False,
            "neighbour_vehicles_connected_lanes": False,
        }

    def configure(self, config: dict | None) -> None:
        if config:
            self.config.update(copy.deepcopy(config))

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #
    def _build(self):
        self._build_scene()  # subclass: sets self.net / self.geo / slots
        self._build_spaces()
        self.idm_params = self._idm_params()
        self.dt = 1.0 / self.config["simulation_frequency"]
        self.frames_per_step = int(
            self.config["simulation_frequency"] // self.config["policy_frequency"]
        )
        # the reference's decision order runs only in the general frames
        # (plain torch), on a straight road too, as in the JAX package
        sequential = general_frames.sequential(self)
        self._straight = (
            None if self.regulated or sequential
            else straight_fast.try_compile(self.net)
        )
        # analytic networks that are not straight take the general path
        self._general = (
            general_frames.try_general(self) if self._straight is None else None
        )
        #: Linear rows possible: the frame kernels run their Linear rows'
        #: instantiation (set by a preset, or by ``preprocessors``'
        #: ``change_vehicles``); without it a Linear row stops the IDM code
        #: with an error
        self.linear_rows = self.npc_preset is not None
        unported = [
            what for what, bad in (
                ("several controlled vehicles",
                 (len(self.ego_slots) != 1
                  or self.config.get("controlled_vehicles", 1) > 1)
                 and not self.several_egos),
                # the straight frames integrate every row kinematically (so
                # does the JAX package's straight path, which never reads
                # the flag)
                ("a dynamical action on a straight road",
                 self._straight is not None and general_frames.dynamical(self.action_type)),
            ) if bad
        ]
        if self._straight is not None:
            # the slots past the global layout's STRAIGHT_GLOBAL_SLOTS (8192):
            # a scene one block cannot hold takes the global layout
            unported += straight_frames.kernel_limits(self.num_slots, self._straight)
        elif not sequential:  # the sequential mode launches no kernel
            unported += general_frames.general_unported(self)
        if unported:
            raise NotImplementedError(
                f"{type(self).__name__}: {', '.join(unported)} not ported yet"
            )

    def _build_scene(self):
        raise NotImplementedError

    def _idm_params(self) -> IDMParams:
        """The NPCs' IDM / MOBIL constants; envs with their own tuning
        override it."""
        return IDMParams()

    @property
    def _regulation_period(self) -> int:
        """Frames between right-of-way ticks on a regulated road."""
        return int(
            self.config["simulation_frequency"] // regulation.REGULATION_FREQUENCY
        )

    def _build_spaces(self):
        from highwayenv_tpu_torch.factories import action_factory, observation_factory

        self.action_type = action_factory(self.config["action"], self)
        self.observation_type = observation_factory(self, self.config["observation"])

    @property
    def action_space(self):
        return self.action_type.space()

    @property
    def observation_space(self):
        return self.observation_type.space()

    #: lane count of the ego's deterministic reset edge (PARITY #5)
    obs_edge_lanes = None

    #: route slots R of the state; envs whose vehicles follow routes set it
    route_slots = 1

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the env's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    # subclass hooks
    # ------------------------------------------------------------------ #
    @property
    def ego_slots(self) -> tuple[int, ...]:
        return (0,)

    def _reset_draws(self, batch: int, generator) -> dict[str, torch.Tensor]:
        """Every generator call of a reset of ``batch`` envs, in order:
        (B, ...) tensors by name.  Row b's draws depend only on the
        generator's state, never on another row."""
        raise NotImplementedError

    def _place_vehicles(self, draws: dict[str, torch.Tensor]) -> VehicleState:
        """The scenes of ``draws``' rows.  Row-local and draws nothing, so
        the rows of any gather of ``draws`` are placed as in the whole."""
        raise NotImplementedError

    def _reset_vehicles(self, batch: int, generator) -> VehicleState:
        return self._place_vehicles(self._reset_draws(batch, generator))

    def _rewards(self, state: EnvState, action) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def _reward(self, state: EnvState, action) -> torch.Tensor:
        raise NotImplementedError

    def _is_terminated(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def _is_truncated(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def _info(self, state: EnvState, action) -> dict[str, Any]:
        """Reference envs/common/abstract.py ``_info``."""
        ego = self.ego_slots[0]
        info = {
            "speed": state.vehicles.speed[:, ego],
            "crashed": state.vehicles.crashed[:, ego],
            "action": action,
        }
        try:
            info["rewards"] = self._rewards(state, action)
        except NotImplementedError:  # an env without reward terms (parking)
            pass
        return info

    def ego_on_road(self, state: EnvState, ego: int | None = None) -> torch.Tensor:
        """RoadObject.on_road of the ego in slot ``ego`` (default the first
        controlled slot; reference vehicle/objects.py)."""
        veh = state.vehicles
        ego = self.ego_slots[0] if ego is None else ego
        lane = veh.lane[:, ego]
        s, lat = lane_ops.local_coordinates(self.geo, lane, veh.pos[:, ego])
        return lane_ops.on_lane(self.geo, lane, s, lat)

    def close_objects_to(self, state: EnvState, slot: int, distance: float,
                         count: int | None = None, see_behind: bool = True,
                         sort: bool = True, vehicles_only: bool = False):
        """The perception query of the JAX package's ``close_objects_to``
        (reference road/road.py ``close_objects_to``), batched: the slots
        within ``distance`` of ``slot``, ordered by their distance along
        its lane (slot order with ``sort=False``), vehicles then objects
        ahead of -2 lengths.  Returns (indices (B, count), valid (B,
        count)); ``count`` defaults to every other slot."""
        veh = state.vehicles
        V = veh.num_slots
        lane = veh.lane[:, slot : slot + 1].expand_as(veh.lane)
        s_all, _ = lane_ops.local_coordinates(self.geo, lane, veh.pos)
        lane_dist = s_all - s_all[:, slot : slot + 1]
        d = veh.pos - veh.pos[:, slot : slot + 1]
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        idx = torch.arange(V, device=veh.pos.device)
        near = (idx != slot) & (dist < distance)
        behind_ok = lane_dist > -2 * 5.0  # -2 * LENGTH
        veh_ok = veh.is_vehicle & near & (behind_ok | see_behind)
        obj_ok = veh.active & ~veh.is_vehicle & near & behind_ok & (not vehicles_only)
        ok = veh_ok | obj_ok
        key = torch.where(ok, lane_dist.abs() if sort else idx.to(torch.float32),
                          torch.inf)
        order = torch.argsort(key, dim=-1, stable=True)
        sel = order[:, : (count if count is not None else V - 1)]
        return sel, torch.gather(ok, 1, sel)

    def to_finite_mdp(self, state: EnvState, horizon: float = 10.0):
        """The time-to-collision grid's finite MDP of each env
        (``ops/finite_mdp.py``; reference envs/common/finite_mdp.py).  The
        grid's lane axis follows the JAX package's two rules: a B=1 state
        takes the lane count of the ego's current edge (one host read), as
        its call on a concrete state does; a batch takes the widest edge
        (``ttc_grid_lanes`` where the env pins it), as its call under
        ``jit`` / ``vmap`` does (PARITY #13)."""
        from highwayenv_tpu_torch.ops.finite_mdp import finite_mdp

        if not hasattr(self, "connected3"):
            self.connected3 = self.net.connectivity_matrix(depth=3)
        grid_lanes = None
        if state.time.shape[0] == 1:
            lane = state.vehicles.lane[:, self.ego_slots[0]]
            grid_lanes = int(self.geo.edge_n[lane_ops._gather(self.geo, lane)][0])
        return finite_mdp(self, state, 1.0 / self.config["policy_frequency"], horizon,
                          grid_lanes=grid_lanes)

    # ------------------------------------------------------------------ #
    # policy-step simulation
    # ------------------------------------------------------------------ #
    @property
    def action_shape(self) -> tuple[int, ...]:
        """The shape of one env's action: the action type's, behind the
        agent axis (n_agents,) where the env has several egos."""
        agents = () if len(self.ego_slots) == 1 else (len(self.ego_slots),)
        return agents + tuple(self.action_type.action_shape)

    def _action_to_slots(self, actions: torch.Tensor) -> torch.Tensor:
        """Agent actions to slot actions: (B,) discrete actions -> (B, V)
        int32; (B, size) continuous actions -> (B, V, size) float32; with
        several egos (B, n_agents, ...) actions, agent k's to slot
        ``ego_slots[k]`` (the JAX package's ``_action_to_slots``)."""
        extra = tuple(self.action_type.action_shape)
        dtype = torch.float32 if extra else torch.int32
        batch = actions.shape[: actions.dim() - len(self.action_shape)]
        slots = torch.zeros(
            batch + (self.num_slots,) + extra, dtype=dtype, device=actions.device
        )
        if len(self.ego_slots) == 1:
            slots[:, self.ego_slots[0]] = actions.to(dtype)
        else:
            for k, slot in enumerate(self.ego_slots):
                slots[:, slot] = actions[:, k].to(dtype)
        return slots

    def _advance(self, states: EnvState, actions, simulate) -> EnvState:
        # a regulated road's frames tick by each env's own frame counter
        kw = {"steps0": states.steps} if self.regulated else {}
        veh = simulate(
            self, states.vehicles, self._action_to_slots(actions),
            self.frames_per_step, **kw,
        )
        # replace, not a new EnvState: an env's state may carry more fields
        return states.replace(
            vehicles=veh,
            time=states.time + 1.0 / self.config["policy_frequency"],
            steps=states.steps + self.frames_per_step,
        )

    def _simulate(self, states: EnvState, actions) -> EnvState:
        """One policy step through the plain torch frames."""
        if self._general is not None:
            return self._advance(
                states, actions, general_frames.simulate_general_reference
            )
        return self._advance(states, actions, simulate_frames_reference)

    def _simulate_batched(self, states: EnvState, actions) -> EnvState:
        """One policy step through the frame kernels (CUDA tensors) or their
        plain versions (CPU tensors): on a general network the general frame
        kernel; on a straight one the sorted path, or the dense one when the
        env was made with ``sorted_frames=False`` or ``lean=False`` (the JAX
        package sorts lean scenes alone, ``base.py:1124-1129``; the lean
        kernels refuse obstacle and landmark rows).  A ``sequential_decisions``
        env steps the plain general frames on its device (the JAX package
        turns its kernels off for it too)."""
        if self._general is not None and self._general.sequential:
            # the reference's decision order is the plain frames' alone
            return self._simulate(states, actions)
        if self._general is not None:
            return self._advance(states, actions, general_frames.simulate_general)
        return self._advance(
            states, actions,
            simulate_bm_sorted if self.sorted_frames and self.lean else simulate_bm,
        )

    # ------------------------------------------------------------------ #
    # reset, heads, autoreset
    # ------------------------------------------------------------------ #
    def _observe(self, state: EnvState, generator=None):
        """The observation of the ego, or with several egos or a
        multi-agent observation the tuple of each ego slot's (the JAX
        package's ``_observe``); an observation of the whole EnvState
        (``observes_env``: AttributesObservation) takes the state.

        An observation that draws (``needs_generator``: Kinematics'
        ``order="shuffled"``) takes one permutation an env, shared by the
        egos, drawn from ``generator``, the step's or the reset's, where the
        JAX package folds the step count into the state's key; without a
        generator it does not draw."""
        obs_type = self.observation_type
        if getattr(obs_type, "stateful_stack", False):
            # the grayscale frame stack, pushed by _push_frame
            return state.obs_stack
        if getattr(obs_type, "host_side", False):
            # a host-rendered observation (the pygame grayscale backend):
            # the single-env GymEnv fills it in; the batch carries zeros
            return torch.zeros((state.time.shape[0],) + tuple(obs_type.shape),
                               dtype=torch.uint8, device=state.time.device)
        if getattr(obs_type, "observes_env", False):
            return obs_type.observe_env(self, state)
        kw = {}
        if getattr(obs_type, "needs_generator", False) and generator is not None:
            kw["perm"] = obs_type.permutation(state.time.shape[0], generator,
                                              state.time.device)
        if len(self.ego_slots) == 1 and not getattr(obs_type, "multi_agent", False):
            return obs_type.observe(self.geo, state.vehicles, self.ego_slots[0], **kw)
        return tuple(obs_type.observe(self.geo, state.vehicles, slot, **kw)
                     for slot in self.ego_slots)

    @property
    def npc_preset(self) -> str | None:
        """The Linear-family class ``config["other_vehicles_type"]`` names,
        or None for any other class (IDM)."""
        name = self.config.get("other_vehicles_type", "").rsplit(".", 1)[-1]
        return name if name in NPC_PRESETS else None

    def _apply_npc_type(self, veh: VehicleState) -> VehicleState:
        """The scene's IDM NPCs made the ``other_vehicles_type`` preset's
        Linear NPCs (the JAX package's ``_apply_npc_type``); unchanged under
        any other class."""
        name = self.npc_preset
        return veh if name is None else with_preset(veh, veh.kind == KIND_IDM, name)

    def _push_frame(self, state: EnvState) -> EnvState:
        """The grayscale frame stack rolled with the current scene (the JAX
        package's ``_push_frame``); unchanged under any other observation.
        Every placed scene (full, compact and seeded resets) and every
        step's head push once."""
        obs_type = self.observation_type
        if not getattr(obs_type, "stateful_stack", False):
            return state
        stack = state.obs_stack
        if stack is None:
            stack = obs_type.init_stack(state.time.shape[0], state.time.device)
        return state.replace(obs_stack=obs_type.push(
            self.geo, state.vehicles, self.ego_slots[0], stack))

    def _place_state(self, draws: dict[str, torch.Tensor]) -> EnvState:
        return self._state_of(self._place_vehicles(draws), draws)

    def _state_of(self, veh: VehicleState, draws: dict[str, torch.Tensor]) -> EnvState:
        """The EnvState of placed scenes ``veh``: the preset on (every placed
        scene, full, compact or seeded reset), time 0, the frame counter at
        its start, the first frame pushed on a grayscale stack.  An env
        whose state carries more fields takes them from ``draws``
        (``_state_draws``' where the scene was replayed)."""
        veh = self._apply_npc_type(veh)
        batch = veh.kind.shape[0]
        return self._push_frame(EnvState(
            vehicles=veh,
            time=torch.zeros(batch, dtype=torch.float32, device=self.device),
            steps=torch.full(
                (batch,), self._initial_steps, dtype=torch.int32,
                device=self.device,
            ),
        ))

    def _state_draws(self, batch: int, generator) -> dict[str, torch.Tensor]:
        """The draws of the state beyond its scene, for ``_state_of``: none
        here (lane-keeping draws its observation noise)."""
        return {}

    def _reset_state(self, batch: int, generator) -> EnvState:
        return self._place_state(self._reset_draws(batch, generator))

    def _reset(self, batch: int, generator):
        """``batch`` fresh scenes drawn from ``generator``: (obs, EnvState)."""
        state = self._reset_state(batch, generator)
        return self._observe(state, generator), state

    reset = _reset

    def reset_batch(self, batch: int, generator):
        """The JAX package's ``reset_batch``: ``batch`` fresh scenes, (obs,
        EnvState), the warm-up of a regulated road on the frame kernel."""
        return self._reset(batch, generator)

    def reset_seeded(self, seed: int | None = None, rng=None, generator=None):
        """The reference's ``reset(seed)`` scene, replayed on the host with its
        NumPy draw order (``seeding.py``): (obs, EnvState) of one env (B=1).

        Pass a ``seed`` or an ``np.random.Generator`` ``rng``, whose state
        carries on across resets (the Gymnasium contract).  After the scene's
        draws ``generator`` (a ``torch.Generator`` on the env's device, or a
        new one) is reseeded from ``rng`` without consuming a draw, and the
        state's own draws come from it; the caller steps the episode on."""
        from highwayenv_tpu_torch import seeding

        rng = rng if rng is not None else seeding.np_random(seed)
        return seeding.seeded_reset(self, rng, generator)

    def _finish_head(self, state: EnvState, action):
        """The frame pushed on a grayscale stack, then reward / termination /
        info, on an already-simulated state."""
        state = self._push_frame(state)
        reward = self._reward(state, action)
        terminated = self._is_terminated(state)
        truncated = self._is_truncated(state)
        mes = self.config.get("max_episode_steps")
        if mes:
            truncated = truncated | (state.steps // self.frames_per_step >= mes)
        return state, reward, terminated, truncated, self._info(state, action)

    def _finish_step(self, state: EnvState, action, obs=None, generator=None):
        """The head with the observation (``obs`` where the step observed
        before its frames), and no reset: (obs, state, reward, terminated,
        truncated, info)."""
        state, reward, terminated, truncated, info = self._finish_head(
            state, action
        )
        obs = self._observe(state, generator) if obs is None else obs
        return obs, state, reward, terminated, truncated, info

    def _post_step_population(self, state: EnvState, generator) -> EnvState:
        """Per-step population update (spawns, clears) after the head, so
        that it reaches only the next step.  Identity here; an env that
        overrides it draws from ``generator`` before the step's resets."""
        return state

    @property
    def _has_population_hook(self) -> bool:
        return type(self)._post_step_population is not BaseEnv._post_step_population

    def _pre_step(self, states: EnvState, generator) -> EnvState:
        """The state a step observes as its observation, made from
        ``states`` before the frames (which simulate from it); it may draw
        from ``generator`` (observation noise), before any other draw of the
        step.  Not called here; an env that overrides it (lane-keeping,
        whose JAX ``_step`` observes the pre-step state) observes before
        its frames."""
        return states

    @property
    def observes_before_step(self) -> bool:
        return type(self)._pre_step is not BaseEnv._pre_step

    def _observed_before(self, states: EnvState, generator):
        """(the state to simulate, the step's observation or None): where
        the env observes before its frames, its ``_pre_step`` state and the
        observation of it."""
        if not self.observes_before_step:
            return states, None
        states = self._pre_step(states, generator)
        return states, self._observe(states, generator)

    def step_batched(self, states: EnvState, actions, generator):
        """Step without autoreset, the frames on the frame kernels: the
        head with the observation (an ``observes_before_step`` env's taken
        before the frames), then the population hook (which draws from
        ``generator`` where the env has one).  For drivers that handle
        episode ends themselves (``parallel/rollout.py``'s ``fresh_pool``,
        the single-env ``GymEnv``)."""
        states, pre_obs = self._observed_before(states, generator)
        obs, state, reward, terminated, truncated, info = self._finish_step(
            self._simulate_batched(states, actions), actions, pre_obs, generator
        )
        state = self._post_step_population(state, generator)
        return obs, state, reward, terminated, truncated, info

    def _finish_autoreset(self, state: EnvState, action, generator,
                          reset_slots: int | None = None, final_obs: bool = False,
                          obs=None):
        """Head, then done rows replaced by fresh scenes, up to the compact
        autoreset's one possible host read.  Returns the step's (obs, state,
        reward, terminated, truncated, info) and the ``PendingReset`` of a
        compact autoreset (None on the full path), which ``_autoreset_rest``
        finishes.

        A full batch of reset draws is made from ``generator`` every step,
        so a done row's scene is row ``b`` of ``_reset(B, g)`` for a clone
        ``g`` of the generator taken before the step (and before the
        frames, which draw nothing).  Envs without a population hook
        observe once, after the reset.  Envs with one (the JAX package's
        order, envs/base.py ``_finish_autoreset``): the head; the
        observation of the state before the hook; the hook, which draws
        from ``generator`` first; the reset drawn after it; where done, the
        reset state and the reset observation.  ``final_obs`` takes the
        second order on every env and keeps the observation before the
        reset in ``info["final_obs"]``: the same draws, states and
        observations.  An ``observes_before_step`` env passes the step's
        ``obs``, taken before the frames, which the reset patches in the
        same way.  The full path places all B rows of the reset; with
        ``reset_slots=P`` only the done rows are placed, P at a time
        (``_compact_first``)."""
        state, reward, terminated, truncated, info = self._finish_head(
            state, action
        )
        done = terminated | truncated
        if obs is None and (final_obs or self._has_population_hook):
            obs = self._observe(state, generator)
        state = self._post_step_population(state, generator)
        if final_obs:
            info = dict(info, final_obs=obs)
        pending = None
        if reset_slots is None:
            fresh = self._reset_state(done.shape[0], generator)
            state = where_done(done, fresh, state)
            if obs is not None:
                obs = map_obs(lambda a, b: torch.where(_rows(done, b), a, b),
                              self._observe(fresh, generator), obs)
        else:
            pending, obs = self._compact_first(state, done, reset_slots, generator, obs)
            state = pending.state
        if obs is None:
            obs = self._observe(state, generator)
        return (obs, state, reward, terminated, truncated, info), pending

    # ------------------------------------------------------------------ #
    # compact autoreset: only the done rows are placed
    # ------------------------------------------------------------------ #
    def _compact_pass(self, state: EnvState, draws, mask, reset_slots: int,
                      obs=None, generator=None):
        """Place the first ``reset_slots`` rows of ``mask`` (in row order)
        from their draws and write them into ``state`` (and their
        observations into ``obs`` when given).  Returns (state, obs, the
        rows of ``mask`` still to place).

        The P rows go into a fixed-size (P,) index without a host sync: the
        masked rows by their rank in the mask (a cumsum), then the first
        unmasked rows into the slots left, so the index holds P distinct
        rows and the scatter back writes every row once; a slot that holds
        an unmasked row writes that row's own values."""
        B, P = mask.shape[0], reset_slots
        dev = mask.device
        rank = torch.cumsum(mask.to(torch.int32), 0) - 1
        take = mask & (rank < P)
        n = take.sum()
        rest = torch.cumsum((~take).to(torch.int32), 0) - 1 + n
        slot = torch.where(take, rank, rest)
        idx = torch.empty(P + 1, dtype=torch.long, device=dev)
        # rows beyond slot P - 1 all land in the spare slot P
        idx.scatter_(0, torch.clamp(slot, max=P), torch.arange(B, device=dev))
        idx = idx[:P]
        valid = torch.arange(P, device=dev) < n
        fresh = self._place_state({k: v[idx] for k, v in draws.items()})
        state = scatter_rows(state, idx, valid, fresh)
        if obs is not None:
            obs = map_obs(
                lambda o, f: o.index_copy(0, idx, torch.where(_rows(valid, o), f, o[idx])),
                obs, self._observe(fresh, generator),
            )
        return state, obs, mask & ~take

    def _compact_first(self, state: EnvState, done, reset_slots: int, generator,
                       obs=None):
        """The compact autoreset's draws and first pass, with no host sync:
        what a captured step runs.  Returns (``PendingReset``, obs with the
        placed rows' observations when ``obs`` is given); ``_compact_rest``
        finishes it."""
        B = done.shape[0]
        P = min(int(reset_slots), B)
        if P < 1:
            raise ValueError(f"reset_slots={reset_slots}: at least 1")
        draws = self._reset_draws(B, generator)
        state, obs_out, left = self._compact_pass(state, draws, done, P, obs, generator)
        return PendingReset(state, draws, left, P, obs is None, generator), obs_out

    def _compact_rest(self, pending: "PendingReset", obs):
        """The passes after the first: one host read of the rows left, then
        ceil(left / P) passes.  Where the first pass patched no observation
        (``pending.observe``) the whole batch is observed again when a pass
        ran; otherwise ``obs`` is patched row by row.  Returns (state,
        obs)."""
        state, draws, left, P, observe, generator = pending
        n_left = int(left.sum())  # the compact path's one host read
        if n_left == 0:
            return state, obs
        for _ in range(-(-n_left // P)):
            state, patched, left = self._compact_pass(
                state, draws, left, P, None if observe else obs, generator
            )
            obs = obs if observe else patched
        return state, self._observe(state, generator) if observe else obs

    def _compact_autoreset(self, state: EnvState, done, reset_slots: int,
                           generator, obs=None):
        """Done rows replaced by fresh scenes, placed ``reset_slots`` rows
        at a time (the JAX package's ``_compact_autoreset``).

        The draws of all B rows are made, as the full path makes them, so
        the generator advances alike and a done row b gets row b of
        ``_reset(B, g)``; only the done rows are placed (and, on a regulated
        road, warmed up), P at a time.  The first pass runs without a host
        sync; the passes beyond it, which cover every done count, follow
        one host read of the rows left.  Returns the state, or (state, obs)
        with the done rows' observations replaced when ``obs`` is given."""
        pending, obs = self._compact_first(state, done, reset_slots, generator, obs)
        state, obs = self._compact_rest(pending, obs)
        return state if obs is None else (state, obs)

    # ------------------------------------------------------------------ #
    # autoreset steps
    # ------------------------------------------------------------------ #
    def _autoreset_first(self, states: EnvState, actions, generator,
                         reset_slots: int | None = None, final_obs: bool = False):
        """An autoreset step, the frames on the kernels, up to its one
        possible host read: what ``parallel/graph.py`` captures
        (``_finish_autoreset``)."""
        states, obs = self._observed_before(states, generator)
        return self._finish_autoreset(
            self._simulate_batched(states, actions), actions, generator,
            reset_slots, final_obs, obs,
        )

    def _autoreset_rest(self, out, pending: "PendingReset | None"):
        """``_finish_autoreset``'s outputs finished: the passes of a compact
        autoreset beyond the first, if rows are left."""
        if pending is None:
            return out
        state, obs = self._compact_rest(pending, out[0])
        return (obs, state) + tuple(out[2:])

    def step_autoreset(self, states: EnvState, actions, generator):
        """Autoreset step through the plain torch frames, the reference the
        kernel path is held against."""
        states, obs = self._observed_before(states, generator)
        return self._finish_autoreset(
            self._simulate(states, actions), actions, generator, obs=obs
        )[0]

    def step_autoreset_batched(self, states: EnvState, actions, generator,
                               reset_slots: int | None = None):
        """Autoreset step with the frames on the frame kernel: the main
        path.  Same results as ``step_autoreset`` up to the kernel's
        rounding.

        ``reset_slots=P`` places only the done rows, P at a time
        (``_compact_autoreset``): the same results as the full path, bit
        for bit where placing a row does not depend on the batch size (on
        the card), the generator advanced alike.  A step with more than P
        done rows reads the count left on the host once."""
        return self._autoreset_rest(
            *self._autoreset_first(states, actions, generator, reset_slots)
        )


class PendingReset(NamedTuple):
    """A compact autoreset after its first pass: the state so far, the
    draws of all B rows, the (B,) rows still to place, the slots P of a
    pass, whether the observation follows the reset (no rows patched), and
    the step's generator (a shuffled observation's draws)."""

    state: EnvState
    draws: dict
    left: torch.Tensor
    slots: int
    observe: bool
    generator: Any = None
