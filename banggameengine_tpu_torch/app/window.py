"""Window / display abstraction: the host-side surface of the app.

Counterpart of ``banggameengine_tpu/app/window.py``.  In
:class:`HeadlessWindow` frames are numpy arrays, and ``present`` passes
each to an optional callback and writes it as a PNG
(``frame_00000.png``, ...) to an optional directory, encoded with
``zlib`` (the JAX package writes through PIL, which the card's machine
lacks).  The interactive backends are the JAX package's:
:class:`XcbWindow` over the native xcb presenter
(:mod:`banggameengine_tpu_torch.native.xcbwindow_binding`, built at first
use) and :class:`GlfwWindow` where ``glfw`` and PyOpenGL import;
:func:`create_window` tries them in that order and falls back to
:class:`HeadlessWindow`.  Every window is an :class:`InputSource`, so the
input system reads it directly.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from banggameengine_tpu_torch.app.input import InputSource
from banggameengine_tpu_torch.scene.textures import encode_png_rgba8

log = logging.getLogger("Window")


class BaseWindow(InputSource):
    width: int
    height: int

    def poll_events(self) -> None: ...

    def present(self, frame: np.ndarray) -> None: ...

    def should_close(self) -> bool:
        return False

    def set_cursor_locked(self, locked: bool) -> None: ...

    def set_title(self, title: str) -> None: ...


class HeadlessWindow(BaseWindow):
    """No display: frames go to an optional sink (callback or PNG dir)."""

    def __init__(self, width: int = 1280, height: int = 720,
                 frame_sink=None, record_dir: str | None = None):
        self.width = width
        self.height = height
        self.title = ""
        self._sink = frame_sink
        self._record_dir = record_dir
        self._frame_no = 0
        self._cursor_locked = False
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)

    def poll_events(self) -> None:
        pass

    def present(self, frame: np.ndarray) -> None:
        if self._sink is not None:
            self._sink(frame)
        if self._record_dir is not None:
            path = os.path.join(self._record_dir,
                                f"frame_{self._frame_no:05d}.png")
            with open(path, "wb") as f:
                f.write(encode_png_rgba8(frame))
        self._frame_no += 1

    def set_cursor_locked(self, locked: bool) -> None:
        self._cursor_locked = locked

    def set_title(self, title: str) -> None:
        self.title = title


class XcbWindow(BaseWindow):
    """Interactive window over the native xcb presenter
    (:mod:`banggameengine_tpu_torch.native.xcbwindow_binding`).

    This is the path that actually DISPLAYS frames (the reference's
    ``bgfx::frame()`` swap, ``Renderer.cpp:733-736``): ``present()`` blits
    the RGBA framebuffer into the X window.  Raises RuntimeError when no X
    server is reachable; ``create_window`` then degrades to headless.
    """

    def __init__(self, width: int = 1280, height: int = 720,
                 title: str = "BangGameEngine-TPU"):
        from banggameengine_tpu_torch.native.xcbwindow_binding import (
            EV_BTN_DOWN, EV_BTN_UP, EV_KEY_DOWN, EV_KEY_UP, EV_MOTION,
            EV_RESIZE, NativeXcbWindow, _SCROLL_DOWN, _SCROLL_UP,
        )

        self._ev = dict(kd=EV_KEY_DOWN, ku=EV_KEY_UP, bd=EV_BTN_DOWN,
                        bu=EV_BTN_UP, mv=EV_MOTION, rs=EV_RESIZE,
                        su=_SCROLL_UP, sd=_SCROLL_DOWN)
        self._native = NativeXcbWindow(width, height, title)
        self.width = width
        self.height = height
        self._keys: set[str] = set()
        self._buttons: set[str] = set()
        self._mouse = (0.0, 0.0)
        self._mouse_delta = (0.0, 0.0)
        self._scroll = [0.0, 0.0]
        self._cursor_locked = False

    def poll_events(self) -> None:
        nw = self._native
        e = self._ev
        dx = dy = 0.0
        for kind, a, b, _c in nw.poll():
            if kind == e["kd"]:
                name = nw.keysym_name(a)
                if name:
                    self._keys.add(name)
            elif kind == e["ku"]:
                name = nw.keysym_name(a)
                self._keys.discard(name)
            elif kind == e["bd"]:
                if a == e["su"]:
                    self._scroll[1] += 1.0
                elif a == e["sd"]:
                    self._scroll[1] -= 1.0
                else:
                    name = nw.button_name(a)
                    if name:
                        self._buttons.add(name)
            elif kind == e["bu"]:
                name = nw.button_name(a)
                self._buttons.discard(name)
            elif kind == e["mv"]:
                dx += a - self._mouse[0]
                dy += b - self._mouse[1]
                self._mouse = (float(a), float(b))
            elif kind == e["rs"]:
                self.width, self.height = int(a), int(b)
        # deltas only while locked (Window.cpp:72-76).  While locked the
        # native layer warps the pointer back to the window center after
        # every poll (GLFW_CURSOR_DISABLED equivalent) so deltas never
        # saturate at the screen edge; the baseline resets to center.
        if self._cursor_locked:
            self._mouse_delta = (dx, dy)
            self._native.warp_center()
            self._mouse = (self.width / 2.0, self.height / 2.0)
        else:
            self._mouse_delta = (0.0, 0.0)

    def present(self, frame: np.ndarray) -> None:
        self._native.present(frame)

    def should_close(self) -> bool:
        return self._native.should_close()

    def set_cursor_locked(self, locked: bool) -> None:
        if locked and not self._cursor_locked:
            # baseline at center: the native layer warps there on lock
            self._mouse = (self.width / 2.0, self.height / 2.0)
        self._cursor_locked = locked
        self._native.set_cursor_locked(locked)

    def set_title(self, title: str) -> None:
        self._native.set_title(title)

    def close(self) -> None:
        self._native.close()

    # InputSource ------------------------------------------------------------
    def keys_down(self):
        return set(self._keys)

    def mouse_buttons_down(self):
        return set(self._buttons)

    def mouse_delta(self):
        return self._mouse_delta

    def scroll_delta(self):
        out = tuple(self._scroll)
        self._scroll[0] = self._scroll[1] = 0.0
        return out


class GlfwWindow(BaseWindow):
    """Interactive window via glfw (only when the module is available).

    Mirrors the reference's input behavior (per-poll mouse deltas zeroed
    while the cursor is unlocked, scroll accumulation); presentation blits
    the fetched RGBA framebuffer through a minimal GL fixed-function path
    when pyOpenGL is importable (the swap the reference gets from
    ``bgfx::frame()``, ``Renderer.cpp:733-736``), and raises at
    construction otherwise so ``create_window`` keeps walking the fallback
    chain instead of opening a window that can never show anything.
    """

    def __init__(self, width: int = 1280, height: int = 720,
                 title: str = "BangGameEngine-TPU"):
        import glfw  # noqa: F401 (raises ImportError when unavailable)
        import OpenGL.GL as gl  # noqa: F401 (presentation requires GL)

        self._glfw = glfw
        self._gl = gl
        if not glfw.init():
            raise RuntimeError("glfw init failed")
        self._win = glfw.create_window(width, height, title, None, None)
        if not self._win:
            glfw.terminate()
            raise RuntimeError("glfw window creation failed")
        self.width = width
        self.height = height
        self._last_mouse = (0.0, 0.0)
        self._mouse_delta = (0.0, 0.0)
        self._scroll = [0.0, 0.0]
        self._cursor_locked = False

        def on_scroll(_w, sx, sy):
            self._scroll[0] += sx
            self._scroll[1] += sy

        glfw.set_scroll_callback(self._win, on_scroll)

    def poll_events(self) -> None:
        g = self._glfw
        g.poll_events()
        x, y = g.get_cursor_pos(self._win)
        dx, dy = x - self._last_mouse[0], y - self._last_mouse[1]
        self._last_mouse = (x, y)
        # deltas only while locked (Window.cpp:72-76)
        self._mouse_delta = (dx, dy) if self._cursor_locked else (0.0, 0.0)

    def present(self, frame: np.ndarray) -> None:
        """Blit the RGBA frame: glDrawPixels with a top-left raster origin
        (negative y zoom flips the row order to GL's bottom-up.)"""
        g, gl = self._glfw, self._gl
        g.make_context_current(self._win)
        fbw, fbh = g.get_framebuffer_size(self._win)
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w = frame.shape[:2]
        gl.glViewport(0, 0, max(fbw, 1), max(fbh, 1))
        gl.glClearColor(0.0, 0.0, 0.0, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT)
        gl.glPixelStorei(gl.GL_UNPACK_ALIGNMENT, 1)
        gl.glRasterPos2f(-1.0, 1.0)
        gl.glPixelZoom(fbw / float(w), -fbh / float(h))
        gl.glDrawPixels(w, h, gl.GL_RGBA, gl.GL_UNSIGNED_BYTE, frame)
        g.swap_buffers(self._win)

    def should_close(self) -> bool:
        return bool(self._glfw.window_should_close(self._win))

    def set_cursor_locked(self, locked: bool) -> None:
        g = self._glfw
        mode = g.CURSOR_DISABLED if locked else g.CURSOR_NORMAL
        g.set_input_mode(self._win, g.CURSOR, mode)
        self._cursor_locked = locked

    def set_title(self, title: str) -> None:
        self._glfw.set_window_title(self._win, title)

    # InputSource -----------------------------------------------------------
    def keys_down(self):
        g = self._glfw
        keys = set()
        for name in dir(g):
            if name.startswith("KEY_"):
                code = getattr(g, name)
                if isinstance(code, int) and g.get_key(self._win, code) == g.PRESS:
                    keys.add(name[4:])
        return keys

    def mouse_buttons_down(self):
        g = self._glfw
        out = set()
        for name, code in (
            ("MOUSE_LEFT", g.MOUSE_BUTTON_LEFT),
            ("MOUSE_RIGHT", g.MOUSE_BUTTON_RIGHT),
            ("MOUSE_MIDDLE", g.MOUSE_BUTTON_MIDDLE),
        ):
            if g.get_mouse_button(self._win, code) == g.PRESS:
                out.add(name)
        return out

    def mouse_delta(self):
        return self._mouse_delta

    def scroll_delta(self):
        out = tuple(self._scroll)
        self._scroll[0] = self._scroll[1] = 0.0
        return out


def create_window(width: int = 1280, height: int = 720, **kwargs) -> BaseWindow:
    """Native xcb presenter when a display exists, then GLFW (input-only),
    headless otherwise (the reference's backend fallback chain,
    ``Renderer.cpp:146-157`` preferred -> D3D11 -> auto -> Noop)."""
    try:
        return XcbWindow(width, height)
    except Exception as e:
        log.info("[Window] xcb window unavailable (%s)", e)
    try:
        return GlfwWindow(width, height)
    except Exception as e:
        log.info("[Window] interactive window unavailable (%s); headless", e)
    return HeadlessWindow(width, height, **kwargs)
