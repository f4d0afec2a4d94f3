"""Straight-road scenes with obstacle, landmark and plain ``Vehicle`` rows,
for ``chip_smoke.py`` and ``tests/test_torch_objects.py``.

No registered straight env spawns objects, but a scene may hold them: a
``HostVehicle`` of kind ``KIND_OBSTACLE`` or ``KIND_LANDMARK`` in
``seeding.scene_to_state``, or a ``kind`` edited in a batch.  Such a scene
steps through the dense frame kernel's objects instantiation, on an env
made with ``lean=False``.  ``object_scene`` rewrites rows of a highway
reset batch, given as numpy arrays, so that the JAX package's state and the
port's are built alike; the objects take the fields the port's envs give
theirs (``envs/merge.py``: a 2 x 2 m obstacle; ``envs/parking.py``: a
landmark 2 m long, of the default width; both checking collisions and
collidable, as ``empty_state`` leaves them).  The scenes:

- ``obstacle``: stalled obstacles with traffic closing on them, slot 5
  8 m ahead of the ego on its lane (the ego runs into it), slot 6 40 m
  ahead of slot 14 and slot 7 60 m ahead of slot 20, each on that
  vehicle's lane (the traffic brakes behind them, or runs into them);
- ``landmark``: a landmark 4 m ahead of the ego on its lane (the ego
  drives into it) and one 1 m ahead of slot 15 (overlapping it: ``hit``);
- ``plain``: slots 10 to 12 plain ``Vehicle`` rows (``KIND_PLAIN``, their
  stored controls kept);
- ``pileup``: 20 vehicles in 6 m from x = 100 m, among them an obstacle
  (slot 5), a landmark (slot 8) and three plain rows (slots 10 to 12);
- ``boundary`` (with ``G``): such a pile-up across every boundary of
  blocks of ``G`` slots, for the global layout.
"""

from __future__ import annotations

import numpy as np

KIND_PLAIN, KIND_OBSTACLE, KIND_LANDMARK = 4, 5, 6
OBJECT_LENGTH = OBJECT_WIDTH = 2.0  # vehicle/state.py, the reference's RoadObject
SCENES = ("obstacle", "landmark", "plain", "pileup")
#: the fields ``object_scene`` rewrites
FIELDS = ("pos", "heading", "speed", "target_speed", "lane", "target_lane", "kind", "length",
          "width")


def _place(f, slot, ahead_of, dx, kind, length, width):
    """Slot ``slot`` made a still object of ``kind``, ``dx`` m ahead of
    slot ``ahead_of`` on its lane (``ahead_of`` None: where it is)."""
    if ahead_of is not None:
        f["pos"][:, slot, 0] = f["pos"][:, ahead_of, 0] + dx
        f["pos"][:, slot, 1] = f["pos"][:, ahead_of, 1]
        for k in ("lane", "target_lane"):
            f[k][:, slot] = f[k][:, ahead_of]
    f["heading"][:, slot] = 0.0
    f["speed"][:, slot] = 0.0
    f["target_speed"][:, slot] = 0.0
    f["kind"][:, slot] = kind
    f["length"][:, slot] = length
    f["width"][:, slot] = width


def _pile(f, lo: int, x0):
    """Slots lo .. lo + 19 in 6 m from x0 ((B,) or a scalar), slot lo + 5 an
    obstacle, lo + 8 a landmark, lo + 10 .. lo + 12 plain rows."""
    f["pos"][:, lo:lo + 20, 0] = np.reshape(x0, (-1, 1)) + np.linspace(0, 6, 20)
    _place(f, lo + 5, None, 0.0, KIND_OBSTACLE, OBJECT_LENGTH, OBJECT_WIDTH)
    _place(f, lo + 8, None, 0.0, KIND_LANDMARK, OBJECT_LENGTH, f["width"][:, lo + 8])
    f["kind"][:, lo + 10:lo + 13] = KIND_PLAIN


def object_scene(fields: dict, name: str, G: int | None = None) -> dict:
    """Copies of the ``FIELDS`` arrays of a highway reset batch ((B, V, ...)
    numpy arrays, V >= 21; slot 0 the ego) rewritten into scene ``name``."""
    f = {k: np.array(fields[k], copy=True) for k in FIELDS}
    if name == "obstacle":
        for slot, ahead_of, dx in ((5, 0, 8.0), (6, 14, 40.0), (7, 20, 60.0)):
            _place(f, slot, ahead_of, dx, KIND_OBSTACLE, OBJECT_LENGTH, OBJECT_WIDTH)
    elif name == "landmark":
        for slot, ahead_of, dx in ((8, 0, 4.0), (9, 15, 1.0)):
            _place(f, slot, ahead_of, dx, KIND_LANDMARK, OBJECT_LENGTH, f["width"][:, slot])
    elif name == "plain":
        f["kind"][:, 10:13] = KIND_PLAIN
    elif name == "pileup":
        _pile(f, 0, 100.0)
    elif name == "boundary":
        V = f["kind"].shape[1]
        xs = np.sort(f["pos"][..., 0], axis=1)
        for k in range(G, V - 10, G):
            _pile(f, k - 10, xs[:, k - 10])
    else:
        raise ValueError(f"unknown scene {name!r}")
    return f


def object_state(veh, name: str, G: int | None = None):
    """``object_scene`` of a port ``VehicleState`` (any device)."""
    import torch

    arrays = {k: getattr(veh, k).cpu().numpy() for k in FIELDS}
    out = object_scene(arrays, name, G)
    return veh.replace(**{k: torch.as_tensor(v).to(getattr(veh, k)) for k, v in out.items()})
