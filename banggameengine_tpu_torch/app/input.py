"""Data-driven input system: axes, actions, mouse smoothing, hot reload.

A copy of ``banggameengine_tpu/app/input.py`` (json only; the JAX package
cannot be imported without JAX), its logic unchanged.

Re-design of ``src/input/InputSystem.{h,cpp}`` with the same observable
semantics and the same ``bindings.json`` schema
(``assets/input/bindings.json``):

- **axes**: list of bindings per axis; each contributes ``scale`` when its
  key is held / its mouse-delta/scroll value; contributions are summed then
  clamped to [-1, 1] (``InputSystem.cpp:452-546``, clamp at ``:543``);
- **actions**: pressed / held / released edge detection per frame
  (``UpdateActions``, ``:408-450``);
- **mouse**: sensitivity multiplier + optional EMA smoothing
  (``alpha``-blended, ``:452-546``; config keys ``sensitivity``,
  ``smoothtype: "ema"``, ``alpha``);
- **hot reload**: mtime polling (``ReloadIfChanged``, ``:347-365``).

The device backend is abstracted as an :class:`InputSource` so the same
system serves a real window, a scripted replay, or network input.  Device
side, the per-tick snapshot is flattened to the
:class:`banggameengine_tpu_torch.state.InputFrame` the step consumes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Iterable

log = logging.getLogger("Input")

# canonical key names (superset of the reference's KeyFromString table,
# InputSystem.cpp:26-79): letters, digits, and named keys
_NAMED_KEYS = {
    "SPACE", "ENTER", "ESCAPE", "TAB", "BACKSPACE",
    "LEFT_SHIFT", "RIGHT_SHIFT", "LEFT_CONTROL", "RIGHT_CONTROL",
    "LEFT_ALT", "RIGHT_ALT",
    "UP", "DOWN", "LEFT", "RIGHT",
    "F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8", "F9", "F10", "F11", "F12",
}
_MOUSE_BUTTONS = {"MOUSE_LEFT", "MOUSE_RIGHT", "MOUSE_MIDDLE"}
_MOUSE_AXES = {"DeltaX", "DeltaY"}
_SCROLL_AXES = {"ScrollY", "ScrollX"}


def normalize_key(name: str) -> str | None:
    up = name.strip().upper()
    if len(up) == 1 and (up.isalpha() or up.isdigit()):
        return up
    if up in _NAMED_KEYS:
        return up
    return None


@dataclasses.dataclass
class AxisBinding:
    kind: str        # 'key' | 'mouse' | 'scroll'
    source: str      # key name / DeltaX / ScrollY ...
    scale: float = 1.0


@dataclasses.dataclass
class ActionState:
    pressed: bool = False   # went down this frame
    held: bool = False
    released: bool = False  # went up this frame


class InputSource:
    """Backend snapshot provider (one per window / replay / net client)."""

    def keys_down(self) -> set[str]:
        return set()

    def mouse_buttons_down(self) -> set[str]:
        return set()

    def mouse_delta(self) -> tuple[float, float]:
        return (0.0, 0.0)

    def scroll_delta(self) -> tuple[float, float]:
        """(x, y) scroll since last poll."""
        return (0.0, 0.0)


class ScriptedInputSource(InputSource):
    """Deterministic scripted input for headless runs and tests."""

    def __init__(self):
        self._keys: set[str] = set()
        self._buttons: set[str] = set()
        self._mouse = (0.0, 0.0)
        self._scroll = (0.0, 0.0)

    def press(self, *keys: str):
        self._keys.update(k.upper() for k in keys)

    def release(self, *keys: str):
        for k in keys:
            self._keys.discard(k.upper())

    def set_mouse_delta(self, dx: float, dy: float):
        self._mouse = (dx, dy)

    def set_scroll(self, sx: float, sy: float):
        self._scroll = (sx, sy)

    def press_button(self, *buttons: str):
        self._buttons.update(b.upper() for b in buttons)

    def release_button(self, *buttons: str):
        for b in buttons:
            self._buttons.discard(b.upper())

    def keys_down(self):
        return self._keys

    def mouse_buttons_down(self):
        return self._buttons

    def mouse_delta(self):
        return self._mouse

    def scroll_delta(self):
        return self._scroll


class InputSystem:
    def __init__(self, source: InputSource | None = None):
        self.source = source or ScriptedInputSource()
        self._axes: dict[str, list[AxisBinding]] = {}
        self._actions: dict[str, list[AxisBinding]] = {}
        self._axis_values: dict[str, float] = {}
        self._action_states: dict[str, ActionState] = {}
        self._mouse_sensitivity = 1.0
        self._ema_alpha: float | None = None
        self._ema_state = (0.0, 0.0)
        self._bindings_path: str | None = None
        self._bindings_mtime = 0.0

    # -- loading -------------------------------------------------------------
    def load_bindings(self, path: str) -> bool:
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("[Input] bindings load failed: %s", e)
            return False

        axes: dict[str, list[AxisBinding]] = {}
        for name, blist in (data.get("axes") or {}).items():
            out = []
            for b in blist or []:
                if not isinstance(b, dict):
                    continue
                scale = float(b.get("scale", 1.0))
                if "key" in b:
                    k = normalize_key(str(b["key"]))
                    if k is None:
                        log.warning("[Input] unknown key '%s' in axis %s", b["key"], name)
                        continue
                    out.append(AxisBinding("key", k, scale))
                elif "mouse" in b and str(b["mouse"]) in _MOUSE_AXES:
                    out.append(AxisBinding("mouse", str(b["mouse"]), scale))
                elif "scroll" in b and str(b["scroll"]) in _SCROLL_AXES:
                    out.append(AxisBinding("scroll", str(b["scroll"]), scale))
            axes[name] = out

        actions: dict[str, list[AxisBinding]] = {}
        for name, blist in (data.get("actions") or {}).items():
            out = []
            for b in blist or []:
                if not isinstance(b, dict):
                    continue
                if "key" in b:
                    k = normalize_key(str(b["key"]))
                    if k:
                        out.append(AxisBinding("key", k))
                elif "mouseButton" in b and str(b["mouseButton"]).upper() in _MOUSE_BUTTONS:
                    out.append(AxisBinding("mouse_button", str(b["mouseButton"]).upper()))
            actions[name] = out

        mouse = data.get("mouse") or {}
        self._mouse_sensitivity = float(mouse.get("sensitivity", 1.0))
        if str(mouse.get("smoothtype", "")).lower() == "ema":
            self._ema_alpha = float(mouse.get("alpha", 0.5))
        else:
            self._ema_alpha = None

        self._axes = axes
        self._actions = actions
        self._axis_values = {k: 0.0 for k in axes}
        self._action_states = {k: ActionState() for k in actions}
        self._bindings_path = path
        try:
            self._bindings_mtime = os.path.getmtime(path)
        except OSError:
            self._bindings_mtime = 0.0
        log.info("[Input] loaded %d axes, %d actions", len(axes), len(actions))
        return True

    def reload_if_changed(self) -> bool:
        """mtime-polled hot reload (InputSystem.cpp:347-365)."""
        if not self._bindings_path:
            return False
        try:
            m = os.path.getmtime(self._bindings_path)
        except OSError:
            return False
        if m > self._bindings_mtime:
            return self.load_bindings(self._bindings_path)
        return False

    # -- per-frame update ----------------------------------------------------
    def update(self) -> None:
        keys = {k.upper() for k in self.source.keys_down()}
        buttons = {b.upper() for b in self.source.mouse_buttons_down()}
        raw_dx, raw_dy = self.source.mouse_delta()
        sx, sy = self.source.scroll_delta()

        dx = raw_dx * self._mouse_sensitivity
        dy = raw_dy * self._mouse_sensitivity
        if self._ema_alpha is not None:
            a = self._ema_alpha
            ex, ey = self._ema_state
            dx = a * dx + (1 - a) * ex
            dy = a * dy + (1 - a) * ey
            self._ema_state = (dx, dy)

        for name, blist in self._axes.items():
            total = 0.0
            for b in blist:
                if b.kind == "key":
                    if b.source in keys:
                        total += b.scale
                elif b.kind == "mouse":
                    total += b.scale * (dx if b.source == "DeltaX" else dy)
                elif b.kind == "scroll":
                    total += b.scale * (sy if b.source == "ScrollY" else sx)
            # mouse/scroll axes are deltas and exceed [-1,1] legitimately in
            # the reference only after clamp — clamp everything like :543
            self._axis_values[name] = max(-1.0, min(1.0, total))

        for name, blist in self._actions.items():
            down = any(
                (b.kind == "key" and b.source in keys)
                or (b.kind == "mouse_button" and b.source in buttons)
                for b in blist
            )
            st = self._action_states[name]
            st.pressed = down and not st.held
            st.released = (not down) and st.held
            st.held = down

    # -- queries (InputSystem.h:27-33) ---------------------------------------
    def get_axis(self, name: str) -> float:
        return self._axis_values.get(name, 0.0)

    def has_axis(self, name: str) -> bool:
        return name in self._axes

    def get_action(self, name: str) -> ActionState:
        return self._action_states.get(name, ActionState())

    def action_pressed(self, name: str) -> bool:
        return self.get_action(name).pressed

    def action_held(self, name: str) -> bool:
        return self.get_action(name).held

    def action_released(self, name: str) -> bool:
        return self.get_action(name).released
