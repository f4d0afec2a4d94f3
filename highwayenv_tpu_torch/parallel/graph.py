"""One policy step captured as a CUDA graph and replayed.

The counterpart of the ``jax.jit(..., donate_argnums=(0,))`` over a step in
the JAX package's ``vector_env.py`` and ``parallel/sharding.py``: where the
eager step issues several hundred to a few thousand launches from Python,
a replay issues one.  ``CapturedStep`` holds the batch's state in static
buffers (the donated argument), warms the step up once eagerly (which
builds the kernels, the lane tables and the device constants before
capture), captures ``step_autoreset_batched`` into a ``torch.cuda.CUDAGraph``
with the actions in a static buffer ((B,) int32, or (B, size) float32 for a
continuous action; (B, n_agents, ...) with several egos), and replays the
graph each step.  A tuple observation (one per ego) is a tuple of static
buffers.

The env's generator is registered with the graph, so each replay advances
it as an eager step does and draws the same numbers: N replays give the
states, observations and generator state of N eager steps from the same
start.  A compact autoreset (``reset_slots=P``) captures its draws and
first pass; a step with more than P done rows reads the count left on the
host after the replay and runs the further passes eagerly, then observes
again (``BaseEnv._autoreset_rest``).

The kernel wrappers count launches in Python, so a replay does not move
their counters: the capture counts one step's launches once.

Every CUDA call here names the batch's device (the warm-up's streams, the
capture stream, the synchronize) and runs under ``torch.cuda.device(dev)``:
with several cards (``parallel/sharding.py``) the current device is not
the shard's, and ``torch.cuda.graph`` left to itself captures on a stream
of the current device (its default capture stream is made once, on the
device current at its first use), which would capture none of the
shard's kernels.
"""

from __future__ import annotations

import torch

from highwayenv_tpu_torch.envs.base import EnvState, map_fields, map_obs


class CapturedStep:
    """``step_autoreset_batched`` of ``env`` captured as one CUDA graph.

    ``states`` is copied into the step's own buffers; each call
    ``step(actions)`` returns ``(obs, states, reward, terminated,
    truncated, info)`` as the eager step does, in tensors the next call
    overwrites (``states`` is the buffer the next step reads).  With
    ``final_obs`` the step runs ``step_batched`` and resets after it, the
    terminal observation in ``info["final_obs"]``.  ``load(states)`` puts a
    new batch of the same size in place (a reset).

    Raises on a CPU batch, where the caller steps eagerly, and where this
    torch cannot register a generator with a graph; a capture or replay
    that fails raises too.
    """

    def __init__(self, env, states: EnvState, generator: torch.Generator,
                 reset_slots: int | None = None, final_obs: bool = False):
        dev = states.time.device
        if dev.type != "cuda":
            raise ValueError(
                f"CapturedStep captures a CUDA graph; the batch is on {dev}: "
                "step a CPU env eagerly"
            )
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this torch cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): the replays would not "
                "advance the env's generator"
            )
        self.env, self.generator = env, generator
        B = states.time.shape[0]
        self.states = map_fields(torch.clone, states)
        # the actions' buffer: (B,) int32 for a discrete action type,
        # (B, size) float32 for a continuous one, behind (n_agents,) with
        # several egos
        continuous = bool(env.action_type.action_shape)
        self.actions = torch.zeros((B,) + env.action_shape, device=dev,
                                   dtype=torch.float32 if continuous else torch.int32)

        def first(batch):
            return env._autoreset_first(
                batch, self.actions, generator, reset_slots, final_obs
            )

        self.device = dev
        with torch.cuda.device(dev):
            # one eager step on a copy, off the default stream as capture
            # wants, the generator put back after it
            before = generator.get_state()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                env._autoreset_rest(*first(map_fields(torch.clone, states)))
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            generator.set_state(before)

            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev)):
                out, pending = first(self.states)
                map_fields(lambda dst, src: dst.copy_(src), self.states, out[1])
        self._out, self._pending = out, pending

    def load(self, states: EnvState) -> None:
        """Put ``states`` (a batch of the captured size) in the buffers."""
        map_fields(lambda dst, src: dst.copy_(src), self.states, states)

    def __call__(self, actions: torch.Tensor):
        self.replay(actions)
        return self.finish()

    def replay(self, actions: torch.Tensor) -> None:
        """Queue a step: the actions copied in and the graph replayed, with
        no host sync."""
        with torch.cuda.device(self.device):
            self.actions.copy_(actions)
            self.graph.replay()

    def finish(self):
        """The replayed step's outputs, after the compact autoreset's
        further passes where rows are left (its one host read)."""
        obs = self._out[0]
        if self._pending is not None:
            state, new_obs = self.env._compact_rest(self._pending, obs)
            if state is not self._pending.state:  # further passes ran
                self.load(state)
                map_obs(lambda dst, src: dst.copy_(src), obs, new_obs)
        return (obs, self.states) + tuple(self._out[2:])
