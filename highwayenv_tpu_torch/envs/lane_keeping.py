"""Lane keeping: a dynamical ego under lateral-only continuous control.

PyTorch counterpart of ``highwayenv_tpu/envs/lane_keeping.py`` (reference
highway_env/envs/lane_keeping_env.py, lane-keeping-v0): a sine lane and two
straight lanes, one ego on the BicycleVehicle tire-slip model (a dynamical
ContinuousAction, K4's ``kDynamical`` instantiation on the card), and the
AttributesObservation of its noisy lateral state, the state's derivative
and the tracked lane's reference.

As in the JAX package's ``_step``, a step first advances the tracked lane
(from the straight lane ("c", "d") to the sine lane once the ego is off it;
the cursor lives in the ego's ``route_ptr``), then observes that pre-step
state, then simulates: ``observes_before_step`` and ``_pre_step`` of
``envs/base.py``.  The observation noise is uniform in +-``state_noise`` and
+-``derivative_noise`` on each (4, 1) array; the JAX package draws it from
the state's key, the port from the generator passed to ``reset`` and the
steps: ``_pre_step`` draws a step's before any other draw of the step, and
a reset's draws are its scenes' noise (the scene itself is deterministic).
The noise of the state's observation is kept in the state
(``LaneKeepingState.noise``), so that the autoresets, the compact one and
the captured step observe a placed row as the full reset does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import (
    LineType,
    RoadNetworkBuilder,
    SineLane,
    StraightLane,
)
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.vehicle import dynamics
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState, empty_state


@dataclasses.dataclass
class LaneKeepingState(EnvState):
    #: (B, 2, 4, 1) the uniform noise of the state's observation: the
    #: ``state`` attribute's, then the ``derivative`` attribute's
    noise: torch.Tensor = dataclasses.field(kw_only=True)


class LaneKeepingEnv(BaseEnv):
    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "AttributesObservation",
                    "attributes": ["state", "derivative", "reference_state"],
                },
                "action": {
                    "type": "ContinuousAction",
                    "steering_range": [-np.pi / 3, np.pi / 3],
                    "longitudinal": False,
                    "lateral": True,
                    "dynamical": True,
                },
                "simulation_frequency": 10,
                "policy_frequency": 10,
                "state_noise": 0.05,
                "derivative_noise": 0.05,
                "screen_width": 600,
                "screen_height": 250,
                "scaling": 7,
                "centering_position": [0.4, 0.5],
                "max_episode_steps": 200,  # the registration's TimeLimit
            },
        )
        return config

    def _build_scene(self):
        """Reference lane_keeping_env.py ``_make_road``."""
        net = RoadNetworkBuilder()
        net.add_lane(
            "a", "b",
            SineLane([0, 0], [500, 0], 5, 2 * np.pi / 100, 0, width=10,
                     line_types=[LineType.STRIPED, LineType.STRIPED]),
        )
        net.add_lane(
            "c", "d",
            StraightLane([50, 50], [115, 15], width=10,
                         line_types=(LineType.STRIPED, LineType.STRIPED)),
        )
        net.add_lane(
            "d", "a",
            StraightLane([115, 15], [115 + 20, 15 + 20 * (15 - 50) / (115 - 50)],
                         width=10, line_types=(LineType.NONE, LineType.STRIPED)),
        )
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = 1
        self.num_slots = 1
        # the tracked lanes in order: ("c", "d"), then the sine lane
        self._tracked_lanes = torch.tensor(
            [net.global_lane_index(("c", "d", 0)), net.global_lane_index(("a", "b", 0))],
            dtype=torch.int32, device=self.device,
        )

    # ------------------------------------------------------------------ #
    # reset and the step's pre-step state
    # ------------------------------------------------------------------ #
    def _noise(self, batch: int, generator) -> torch.Tensor:
        """(B, 2, 4, 1) observation noise: the state's, then the derivative's."""
        cfg, dev = self.config, self.device
        return torch.stack([
            _uniform((batch, 4, 1), -cfg[k], cfg[k], generator, dev)
            for k in ("state_noise", "derivative_noise")
        ], dim=1)

    def _state_draws(self, batch: int, generator) -> dict[str, torch.Tensor]:
        """The state's observation noise."""
        return {"noise": self._noise(batch, generator)}

    def _reset_draws(self, batch: int, generator) -> dict[str, torch.Tensor]:
        """The scene is deterministic: a reset draws only its observation's
        noise."""
        return self._state_draws(batch, generator)

    def _place_vehicles(self, draws: dict[str, torch.Tensor]) -> VehicleState:
        """Reference lane_keeping_env.py ``_make_vehicles``: the ego at
        s = 50, 4 m right of the lane ("c", "d"), along its heading at
        8.3 m/s, tracking it (cursor 0)."""
        B, dev = draws["noise"].shape[0], self.device
        lane = self._tracked_lanes[0].expand(B)
        pos = lane_ops.position(self.geo, lane, torch.full((B,), 50.0, device=dev),
                                torch.full((B,), -4.0, device=dev))
        heading = lane_ops.heading_at(self.geo, lane, torch.zeros(B, device=dev))
        veh = empty_state(B, 1, device=dev)
        return veh.replace(
            pos=pos[:, None].to(torch.float32).contiguous(),
            heading=heading[:, None].to(torch.float32).contiguous(),
            speed=torch.full((B, 1), 8.3, device=dev),
            lane=lane[:, None].contiguous(),
            target_lane=lane[:, None].contiguous(),
            kind=torch.full((B, 1), KIND_EGO, dtype=torch.int32, device=dev),
        )

    def _state_of(self, veh: VehicleState, draws: dict[str, torch.Tensor]) -> LaneKeepingState:
        state = super()._state_of(veh, draws)
        return LaneKeepingState(vehicles=state.vehicles, time=state.time,
                                steps=state.steps, obs_stack=state.obs_stack,
                                noise=draws["noise"])

    def _tracked_lane(self, state: EnvState) -> torch.Tensor:
        ptr = torch.clamp(state.vehicles.route_ptr[:, 0], 0, 1)
        return self._tracked_lanes[ptr.long()]

    def _pre_step(self, states: LaneKeepingState, generator) -> LaneKeepingState:
        """The JAX ``_step``'s start: the cursor moves to the sine lane once
        the ego is off the tracked straight lane; then the step's
        observation noise."""
        veh = states.vehicles
        lane = self._tracked_lane(states)
        s, lat = lane_ops.local_coordinates(self.geo, lane, veh.pos[:, 0])
        on = lane_ops.on_lane(self.geo, lane, s, lat)
        ptr = veh.route_ptr[:, 0]
        ptr = torch.where((ptr < 1) & ~on, ptr + 1, ptr)
        return states.replace(
            vehicles=veh.replace(route_ptr=ptr[:, None].contiguous()),
            noise=self._noise(ptr.shape[0], generator),
        )

    # ------------------------------------------------------------------ #
    # the AttributesObservation's sources (reference lane_keeping_env.py)
    # ------------------------------------------------------------------ #
    def _lateral_state(self, state: EnvState) -> torch.Tensor:
        """The ego's (y, psi, v_lat, r), (B, 4, 1)."""
        v = state.vehicles
        return torch.stack(
            [v.pos[:, 0, 1], v.heading[:, 0], v.lateral_speed[:, 0], v.yaw_rate[:, 0]],
            dim=-1,
        )[..., None]

    def attr_state(self, state: LaneKeepingState) -> torch.Tensor:
        return self._lateral_state(state) + state.noise[:, 0]

    def attr_derivative(self, state: LaneKeepingState) -> torch.Tensor:
        d = dynamics.derivative(state.vehicles)[:, 0]
        d4 = torch.stack([d[:, 1], d[:, 2], d[:, 4], d[:, 5]], dim=-1)[..., None]
        return d4 + state.noise[:, 1]

    def attr_reference_state(self, state: EnvState) -> torch.Tensor:
        lane = self._tracked_lane(state)
        s, lat = lane_ops.local_coordinates(self.geo, lane, state.vehicles.pos[:, 0])
        psi_l = lane_ops.heading_at(self.geo, lane, s)
        y_ref = self._lateral_state(state)[:, 0, 0] - lat
        z = torch.zeros_like(psi_l)
        return torch.stack([y_ref, psi_l, z, z], dim=-1)[..., None]

    # ------------------------------------------------------------------ #
    # reward and episode end
    # ------------------------------------------------------------------ #
    def _reward(self, state: EnvState, action) -> torch.Tensor:
        """Reference lane_keeping_env.py ``_reward``: 1 - (lat / width)^2 on
        the tracked lane."""
        lane = self._tracked_lane(state)
        _, lat = lane_ops.local_coordinates(self.geo, lane, state.vehicles.pos[:, 0])
        width = self.geo.width[lane_ops._gather(self.geo, lane)]
        return 1.0 - (lat / width) ** 2

    def _is_terminated(self, state: EnvState) -> torch.Tensor:
        return torch.zeros_like(state.time, dtype=torch.bool)

    def _is_truncated(self, state: EnvState) -> torch.Tensor:
        # max_episode_steps alone (BaseEnv._finish_head)
        return torch.zeros_like(state.time, dtype=torch.bool)

    def _info(self, state: EnvState, action) -> dict:
        """The JAX ``_step``'s info: empty."""
        return {}
