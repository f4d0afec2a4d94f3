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
    JAX package's ``HT_NO_SORTED=1``);
  - on any other analytic-lane network the general gate admits
    (roundabout, merge) through ``ops/general_frames.simulate_general``
    (one launch of the general frame kernel, the ego meta-action inside);
    on a regulated road (intersection) the same with the right-of-way pass
    on each env's tick frames, which ``simulate_general`` reads from the
    envs' frame counters (one launch of the regulated kernel).

``_simulate`` runs them through the plain torch loops on any device:
``simulate_frames_reference`` or ``simulate_general_reference``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from highwayenv_tpu_torch.ops import general_frames, straight_fast
from highwayenv_tpu_torch.ops.straight_frames import frames_plain, simulate_bm
from highwayenv_tpu_torch.ops.straight_sorted import simulate_bm_sorted
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road import regulation
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState


@dataclasses.dataclass
class EnvState:
    vehicles: VehicleState
    time: torch.Tensor  # (B,) f32, simulation time [s]
    steps: torch.Tensor  # (B,) i32, simulation frames executed

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Refuses CUDA when it is absent: the CPU runs
    only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def where_done(done: torch.Tensor, new, old):
    """Row select over every tensor of two EnvStates (or VehicleStates)."""
    out = {}
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if dataclasses.is_dataclass(a):
            out[f.name] = where_done(done, a, b)
        else:
            out[f.name] = torch.where(
                done.view(done.shape + (1,) * (b.dim() - 1)), a, b
            )
    return type(old)(**out)


def simulate_frames_reference(
    env, veh: VehicleState, slot_actions: torch.Tensor, frames: int
) -> VehicleState:
    """Policy-step simulation in plain torch on any device: the ego
    meta-action, then ``frames`` frames of ``frames_plain``.  The
    counterpart of the JAX package's XLA frame scan; the kernel path
    (``simulate_bm``) is held against it."""
    veh = env.action_type.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions)
    return frames_plain(veh, env._straight, env.idm_params, env.dt, frames)


class BaseEnv:
    """Config surface mirrors the reference AbstractEnv.

    Batched API: ``reset(batch_size, generator) -> (obs, EnvState)`` and
    ``step_autoreset_batched(states, actions, generator)
    -> (obs, EnvState, reward, terminated, truncated, info)``.
    """

    #: NPC class presets not ported yet (Linear family; reference
    #: vehicle/behavior.py LinearVehicle, Aggressive/DefensiveVehicle)
    _LINEAR_PRESETS = ("LinearVehicle", "AggressiveVehicle", "DefensiveVehicle")

    #: initial value of the frame counter
    _initial_steps = 0

    #: RegulatedRoad envs (the right-of-way pass in the frames) set this
    regulated = False

    def __init__(self, config: dict | None = None, device=None,
                 sorted_frames: bool = True):
        self.device = resolve_device(device)
        #: frames on the s-sorted banded path (default) or dense
        self.sorted_frames = sorted_frames
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
        self._straight = (
            None if self.regulated else straight_fast.try_compile(self.net)
        )
        # analytic networks that are not straight take the general path
        self._general = (
            general_frames.try_general(self) if self._straight is None else None
        )
        npc = self.config.get("other_vehicles_type", "").rsplit(".", 1)[-1]
        unported = [
            what for what, bad in (
                (f"other_vehicles_type={npc}", npc in self._LINEAR_PRESETS),
                ("sequential_decisions", self.config.get("sequential_decisions")),
                ("several controlled vehicles", len(self.ego_slots) != 1),
            ) if bad
        ]
        if self._straight is None:
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
        from highwayenv_tpu_torch.actions.discrete_meta import DiscreteMetaAction
        from highwayenv_tpu_torch.observations.kinematics import (
            KinematicsObservation,
        )

        act = dict(self.config["action"])
        obs = dict(self.config["observation"])
        if act.pop("type") != "DiscreteMetaAction" or obs.pop("type") != "Kinematics":
            raise NotImplementedError(
                f"action {self.config['action']['type']} / observation "
                f"{self.config['observation']['type']}: only DiscreteMetaAction "
                "and Kinematics are ported, the rest not ported yet"
            )
        self.action_type = DiscreteMetaAction(**act)
        self.observation_type = KinematicsObservation(
            reset_edge_lanes=self.obs_edge_lanes, **obs
        )

    #: lane count of the ego's deterministic reset edge (PARITY #5)
    obs_edge_lanes = None

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the env's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    # subclass hooks
    # ------------------------------------------------------------------ #
    @property
    def ego_slots(self) -> tuple[int, ...]:
        return (0,)

    def _reset_vehicles(self, batch: int, generator) -> VehicleState:
        raise NotImplementedError

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
        return {
            "speed": state.vehicles.speed[:, ego],
            "crashed": state.vehicles.crashed[:, ego],
            "action": action,
            "rewards": self._rewards(state, action),
        }

    def ego_on_road(self, state: EnvState, ego: int | None = None) -> torch.Tensor:
        """RoadObject.on_road of the ego in slot ``ego`` (default the first
        controlled slot; reference vehicle/objects.py)."""
        veh = state.vehicles
        ego = self.ego_slots[0] if ego is None else ego
        lane = veh.lane[:, ego]
        s, lat = lane_ops.local_coordinates(self.geo, lane, veh.pos[:, ego])
        return lane_ops.on_lane(self.geo, lane, s, lat)

    # ------------------------------------------------------------------ #
    # policy-step simulation
    # ------------------------------------------------------------------ #
    def _action_to_slots(self, actions: torch.Tensor) -> torch.Tensor:
        """(B,) agent actions -> (B, V) int32 slot actions."""
        slots = torch.zeros(
            actions.shape + (self.num_slots,), dtype=torch.int32,
            device=actions.device,
        )
        slots[..., self.ego_slots[0]] = actions.to(torch.int32)
        return slots

    def _advance(self, states: EnvState, actions, simulate) -> EnvState:
        # a regulated road's frames tick by each env's own frame counter
        kw = {"steps0": states.steps} if self.regulated else {}
        veh = simulate(
            self, states.vehicles, self._action_to_slots(actions),
            self.frames_per_step, **kw,
        )
        return EnvState(
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
        env was made with ``sorted_frames=False``.  The ported straight
        scenes are all lean (vehicles only), the JAX package's condition for
        sorting."""
        if self._general is not None:
            return self._advance(states, actions, general_frames.simulate_general)
        return self._advance(
            states, actions, simulate_bm_sorted if self.sorted_frames else simulate_bm
        )

    # ------------------------------------------------------------------ #
    # reset, heads, autoreset
    # ------------------------------------------------------------------ #
    def _observe(self, state: EnvState) -> torch.Tensor:
        return self.observation_type.observe(
            self.geo, state.vehicles, self.ego_slots[0]
        )

    def _reset_state(self, batch: int, generator) -> EnvState:
        return EnvState(
            vehicles=self._reset_vehicles(batch, generator),
            time=torch.zeros(batch, dtype=torch.float32, device=self.device),
            steps=torch.full(
                (batch,), self._initial_steps, dtype=torch.int32,
                device=self.device,
            ),
        )

    def _reset(self, batch: int, generator):
        """``batch`` fresh scenes drawn from ``generator``: (obs, EnvState)."""
        state = self._reset_state(batch, generator)
        return self._observe(state), state

    reset = _reset

    def _finish_head(self, state: EnvState, action):
        """Reward / termination / info on an already-simulated state."""
        reward = self._reward(state, action)
        terminated = self._is_terminated(state)
        truncated = self._is_truncated(state)
        mes = self.config.get("max_episode_steps")
        if mes:
            truncated = truncated | (state.steps // self.frames_per_step >= mes)
        return state, reward, terminated, truncated, self._info(state, action)

    def _post_step_population(self, state: EnvState, generator) -> EnvState:
        """Per-step population update (spawns, clears) after the head, so
        that it reaches only the next step.  Identity here; an env that
        overrides it draws from ``generator`` before the step's resets."""
        return state

    def _finish_autoreset(self, state: EnvState, action, generator):
        """Head, then done rows replaced by fresh scenes.

        A full batch of resets is drawn from ``generator`` every step and
        selected where done, so a done row's scene is row ``b`` of
        ``_reset(B, g)`` for a clone ``g`` of the generator taken before the
        step (and before the frames, which draw nothing).  Envs without a
        population hook observe once, after the select.  Envs with one (the
        JAX package's order, envs/base.py ``_finish_autoreset``): the head;
        the observation of the state before the hook; the hook, which draws
        from ``generator`` first; the full reset drawn after it; where done,
        the reset state and the reset observation."""
        state, reward, terminated, truncated, info = self._finish_head(
            state, action
        )
        done = terminated | truncated
        B = state.time.shape[0]
        if type(self)._post_step_population is BaseEnv._post_step_population:
            fresh = self._reset_state(B, generator)
            state = where_done(done, fresh, state)
            return self._observe(state), state, reward, terminated, truncated, info
        obs = self._observe(state)
        state = self._post_step_population(state, generator)
        fresh_obs, fresh = self._reset(B, generator)
        state = where_done(done, fresh, state)
        obs = torch.where(done[:, None, None], fresh_obs, obs)
        return obs, state, reward, terminated, truncated, info

    def step_autoreset(self, states: EnvState, actions, generator):
        """Autoreset step through the plain torch frames, the reference the
        kernel path is held against."""
        return self._finish_autoreset(
            self._simulate(states, actions), actions, generator
        )

    def step_autoreset_batched(self, states: EnvState, actions, generator):
        """Autoreset step with the frames on the frame kernel: the main
        path.  Same results as ``step_autoreset`` up to the kernel's
        rounding."""
        return self._finish_autoreset(
            self._simulate_batched(states, actions), actions, generator
        )
