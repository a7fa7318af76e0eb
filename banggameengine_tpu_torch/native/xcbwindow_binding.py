"""ctypes binding for the native xcb presentation window.

Counterpart of ``banggameengine_tpu/native/xcbwindow_binding.py``.

The native side (``xcbwindow.cpp``) dlopens ``libxcb.so.1`` at runtime and
returns NULL when no X server is reachable, so importing/constructing this
binding is always safe — callers degrade to headless (the reference's
Noop-backend fallback, ``Renderer.cpp:156``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from banggameengine_tpu_torch.native.build import build_native

# X11 keysym -> engine key name (the subset the reference's bindings.json
# uses: letters, digits, space/shift/esc, arrows, F-keys — see
# InputSystem.cpp:26-79 KeyFromString)
_KEYSYM_NAMES: dict[int, str] = {}
for _c in range(26):
    _KEYSYM_NAMES[0x61 + _c] = chr(ord("A") + _c)   # a-z -> "A".."Z"
    _KEYSYM_NAMES[0x41 + _c] = chr(ord("A") + _c)
for _d in range(10):
    _KEYSYM_NAMES[0x30 + _d] = chr(ord("0") + _d)
_KEYSYM_NAMES.update({
    0x20: "SPACE",
    0xFF1B: "ESCAPE",
    0xFFE1: "LEFT_SHIFT",
    0xFFE2: "RIGHT_SHIFT",
    0xFFE3: "LEFT_CONTROL",
    0xFFE4: "RIGHT_CONTROL",
    0xFF51: "LEFT", 0xFF52: "UP", 0xFF53: "RIGHT", 0xFF54: "DOWN",
    0xFF0D: "ENTER", 0xFF09: "TAB",
})
for _f in range(12):
    _KEYSYM_NAMES[0xFFBE + _f] = f"F{_f + 1}"

_BUTTON_NAMES = {1: "MOUSE_LEFT", 2: "MOUSE_MIDDLE", 3: "MOUSE_RIGHT"}

# event kinds from bang_win_poll
EV_KEY_DOWN, EV_KEY_UP = 1, 2
EV_BTN_DOWN, EV_BTN_UP = 3, 4
EV_MOTION, EV_CLOSE, EV_RESIZE = 5, 6, 7
# X buttons 4/5 are the scroll wheel
_SCROLL_UP, _SCROLL_DOWN = 4, 5


def _load():
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.bang_win_open.restype = ctypes.c_void_p
    lib.bang_win_open.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
    lib.bang_win_present.restype = None
    lib.bang_win_present.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.bang_win_poll.restype = ctypes.c_int
    lib.bang_win_poll.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.bang_win_should_close.restype = ctypes.c_int
    lib.bang_win_should_close.argtypes = [ctypes.c_void_p]
    lib.bang_win_close.restype = None
    lib.bang_win_close.argtypes = [ctypes.c_void_p]
    lib.bang_win_set_title.restype = None
    lib.bang_win_set_title.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bang_win_set_cursor_locked.restype = None
    lib.bang_win_set_cursor_locked.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bang_win_warp_center.restype = None
    lib.bang_win_warp_center.argtypes = [ctypes.c_void_p]
    return lib


class NativeXcbWindow:
    """Thin object wrapper; raises RuntimeError when no display exists."""

    MAX_EVENTS = 256

    def __init__(self, width: int, height: int, title: str):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._handle = self._lib.bang_win_open(
            width, height, title.encode("utf-8"))
        if not self._handle:
            raise RuntimeError("no X server reachable (xcb_connect failed)")
        self.width = width
        self.height = height
        self._buf = (ctypes.c_int32 * (4 * self.MAX_EVENTS))()

    def present(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w = frame.shape[:2]
        self._lib.bang_win_present(
            self._handle, frame.ctypes.data_as(ctypes.c_void_p), w, h)

    def poll(self) -> list[tuple[int, int, int, int]]:
        n = self._lib.bang_win_poll(self._handle, self._buf, self.MAX_EVENTS)
        out = []
        for i in range(n):
            out.append(tuple(self._buf[4 * i:4 * i + 4]))
        return out

    def should_close(self) -> bool:
        return bool(self._lib.bang_win_should_close(self._handle))

    def set_title(self, title: str) -> None:
        self._lib.bang_win_set_title(self._handle, title.encode("utf-8"))

    def set_cursor_locked(self, locked: bool) -> None:
        self._lib.bang_win_set_cursor_locked(self._handle, int(locked))

    def warp_center(self) -> None:
        """Re-center the pointer while locked (call after draining poll)."""
        self._lib.bang_win_warp_center(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.bang_win_close(self._handle)
            self._handle = None

    @staticmethod
    def keysym_name(sym: int) -> str | None:
        return _KEYSYM_NAMES.get(sym)

    @staticmethod
    def button_name(button: int) -> str | None:
        return _BUTTON_NAMES.get(button)
