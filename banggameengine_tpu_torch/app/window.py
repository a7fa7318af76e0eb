"""Window / display abstraction: the host-side surface of the app.

Counterpart of ``banggameengine_tpu/app/window.py``'s :class:`BaseWindow`
and :class:`HeadlessWindow`: frames are numpy arrays, and ``present``
passes each to an optional callback and writes it as a PNG
(``frame_00000.png``, ...) to an optional directory, encoded with
``zlib`` (the JAX package writes through PIL, which the card's machine
lacks).  Both windows are :class:`InputSource`\\ s, so the input system
reads them directly.  The interactive backends (the native xcb presenter
and GLFW) are not ported: ROADMAP item 19.
"""

from __future__ import annotations

import os

import numpy as np

from banggameengine_tpu_torch.app.input import InputSource
from banggameengine_tpu_torch.scene.textures import encode_png_rgba8


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
