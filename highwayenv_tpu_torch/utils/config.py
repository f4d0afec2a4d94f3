"""Layered dict-config system with nested-override validation.

Same *contract* as the reference (highway_env/utils.py:427-478): when a
config override supplies a nested mapping for a key whose default is also a
mapping, the override must redefine **every** key of that nested default
(partial nested overrides are rejected with a dotted-path error message),
with one carve-out for the multi-agent ``action``/``observation`` blocks,
whose inner ``*_config`` sub-dict counts toward the outer key set.

The implementation is this repo's own: an explicit-stack pre-order walk of
``(path, default_node, override_node)`` frames instead of the reference's
recursive walker + contextvar path tracking.  Only the two error-message
shapes are preserved (they are the observable API):

    ``config.<path> must be a mapping, got <typename>``
    ``config.<path> invalid: missing_keys={...}``
"""

from __future__ import annotations

from typing import Any, Mapping

#: outer keys whose ``<key>_config`` sub-mapping is folded into the
#: override before completeness checking (multi-agent configs nest the real
#: per-agent config one level down; reference utils.py:458-461)
_FOLDED_SUBCONFIG_KEYS = frozenset({"action", "observation"})


def _mapping_children(
    path: str, defaults: Mapping[str, Any], override: Mapping[str, Any]
) -> list[tuple[str, str, Mapping[str, Any], Any]]:
    """Nested-mapping keys of ``defaults`` that ``override`` touches, as
    unvalidated work items ``(child_path, key, default_val, override_val)``
    in dict order."""
    return [
        (f"{path}.{key}", key, default_val, override[key])
        for key, default_val in defaults.items()
        if isinstance(default_val, Mapping) and key in override
    ]


def update_config_check(config: dict[str, Any], delta: Mapping[str, Any]) -> None:
    """Validate that every nested mapping in ``delta`` fully redefines the
    corresponding nested mapping in ``config``.  Raises AssertionError with
    a dotted config path on the first violation (reference message shapes).

    Traversal is TRUE pre-order (each node is validated at its own visit and
    its subtree fully explored before later siblings), so the *first* error
    raised on a config with several violations matches the reference's
    depth-first recursion exactly.
    """
    # explicit-stack pre-order DFS: popping an item validates that node,
    # then pushes its children (reversed, so the first child is on top)
    stack = list(reversed(_mapping_children("config", config, delta)))
    while stack:
        child_path, key, default_val, child = stack.pop()
        if not isinstance(child, Mapping):
            raise AssertionError(
                f"{child_path} must be a mapping, "
                f"got {type(child).__name__}"
            )
        if key in _FOLDED_SUBCONFIG_KEYS:
            sub = child.get(f"{key}_config")
            if isinstance(sub, Mapping):
                child = {**child, **sub}
        missing_keys = default_val.keys() - child.keys()
        if missing_keys:
            raise AssertionError(
                f"{child_path} invalid: {missing_keys=}"
            )
        stack.extend(reversed(_mapping_children(child_path, default_val, child)))


def update_config(config: dict[str, Any], delta: Mapping[str, Any]) -> dict[str, Any]:
    """Validate ``delta`` against ``config`` (see update_config_check), then
    apply it in place at the top level and return ``config``."""
    update_config_check(config, delta)
    config.update(delta)
    return config
