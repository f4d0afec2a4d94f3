"""Human-window viewer, keyboard manual control, and video recording.

PyTorch counterpart of ``highwayenv_tpu/viewer.py``: host-side equivalents
of the reference's pygame stack (envs/common/graphics.py: EnvViewer,
EventHandler) over the single env's ``render_frame``; the step is
untouched.  Works headless with ``SDL_VIDEODRIVER=dummy``.  ``pygame`` and
``imageio`` are imported where they are used, never by
``import highwayenv_tpu_torch``.
"""

from __future__ import annotations

import os

import numpy as np


class EventHandler:
    """Keyboard -> action mapping (graphics.py:198-253)."""

    @classmethod
    def handle_event(cls, viewer, action_type, event):
        import pygame

        name = type(action_type).__name__
        if name == "DiscreteMetaAction":
            cls._discrete(viewer, action_type, event)
        elif name == "ContinuousAction":
            cls._continuous(viewer, action_type, event)

    @classmethod
    def _discrete(cls, viewer, action_type, event):
        import pygame

        if event.type != pygame.KEYDOWN:
            return
        idx = action_type.actions_indexes
        if event.key == pygame.K_RIGHT and action_type.longitudinal:
            viewer.manual_action = idx["FASTER"]
        if event.key == pygame.K_LEFT and action_type.longitudinal:
            viewer.manual_action = idx["SLOWER"]
        if event.key == pygame.K_DOWN and action_type.lateral:
            viewer.manual_action = idx["LANE_RIGHT"]
        if event.key == pygame.K_UP:
            viewer.manual_action = idx["LANE_LEFT"]

    @classmethod
    def _continuous(cls, viewer, action_type, event):
        import pygame

        action = np.array(
            viewer.manual_action
            if viewer.manual_action is not None
            else np.zeros(action_type.size),
            dtype=np.float32,
        )
        steering_index = action_type.size - 1
        if event.type == pygame.KEYDOWN:
            if event.key == pygame.K_RIGHT and action_type.lateral:
                action[steering_index] = 0.7
            if event.key == pygame.K_LEFT and action_type.lateral:
                action[steering_index] = -0.7
            if event.key == pygame.K_DOWN and action_type.longitudinal:
                action[0] = -0.7
            if event.key == pygame.K_UP and action_type.longitudinal:
                action[0] = 0.7
        elif event.type == pygame.KEYUP:
            if event.key == pygame.K_RIGHT and action_type.lateral:
                action[steering_index] = 0.0
            if event.key == pygame.K_LEFT and action_type.lateral:
                action[steering_index] = 0.0
            if event.key == pygame.K_DOWN and action_type.longitudinal:
                action[0] = 0.0
            if event.key == pygame.K_UP and action_type.longitudinal:
                action[0] = 0.0
        viewer.manual_action = action


class EnvViewer:
    """Display rgb_array frames in a pygame window and collect keyboard
    actions (graphics.py:23-130 equivalent)."""

    def __init__(self, gym_env):
        import pygame

        self.gym_env = gym_env
        self.manual_action = None
        self.done = False
        pygame.init()
        pygame.display.set_caption("highwayenv-tpu")
        frame = gym_env.render_frame()
        h, w = frame.shape[:2]
        self.screen = pygame.display.set_mode((w, h))
        self.clock = pygame.time.Clock()

    def display(self) -> np.ndarray:
        import pygame

        frame = self.gym_env.render_frame()
        surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
        self.screen.blit(surf, (0, 0))
        pygame.display.flip()
        self.clock.tick(self.gym_env.metadata.get("render_fps", 15))
        self.handle_events()
        return frame

    def handle_events(self) -> None:
        import pygame

        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                self.done = True
            if self.gym_env.config.get("manual_control", False):
                EventHandler.handle_event(
                    self, self.gym_env.env.action_type, event
                )

    def get_manual_action(self):
        """Current keyboard action, defaulting to IDLE / zero controls."""
        at = self.gym_env.env.action_type
        if self.manual_action is not None:
            return self.manual_action
        if type(at).__name__ == "DiscreteMetaAction":
            return at.actions_indexes.get("IDLE", 0)
        return np.zeros(at.size, np.float32)

    def close(self) -> None:
        import pygame

        pygame.display.quit()
        pygame.quit()


class VideoRecorder:
    """Accumulate rgb_array frames, save as GIF/MP4 via imageio (replaces
    the reference's gymnasium RecordVideo integration)."""

    def __init__(self, fps: int = 15):
        self.fps = fps
        self.frames: list[np.ndarray] = []

    def capture(self, frame: np.ndarray) -> None:
        self.frames.append(np.asarray(frame, np.uint8))

    def save(self, path: str) -> str:
        import imageio

        if not self.frames:
            raise ValueError("no frames captured")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if path.endswith(".gif"):
            imageio.mimsave(path, self.frames, fps=self.fps, loop=0)
        else:
            imageio.mimsave(path, self.frames, fps=self.fps)
        return path
