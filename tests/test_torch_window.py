"""The port's windows against the JAX package's (no X server here).

Counterpart of ``tests/test_window.py``, test for test: the native xcb
presenter builds (into ``banggameengine_tpu_torch/_build/``), fails
gracefully without a display, and carries the JAX package's keysym and
button tables; ``create_window`` degrades to ``HeadlessWindow``.
"""

import numpy as np
import pytest

from banggameengine_tpu.native import xcbwindow_binding as jax_binding
from banggameengine_tpu_torch.app.window import (
    HeadlessWindow,
    XcbWindow,
    create_window,
)
from banggameengine_tpu_torch.native import xcbwindow_binding as binding
from banggameengine_tpu_torch.native.build import build_native


def test_native_lib_builds_with_window():
    assert build_native() is not None


def test_xcb_window_graceful_without_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(RuntimeError):
        XcbWindow(320, 200)


def test_create_window_falls_back_headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    w = create_window(320, 200)
    assert isinstance(w, HeadlessWindow)


def test_keysym_names_cover_reference_bindings():
    names = set(binding._KEYSYM_NAMES.values())
    for required in ["W", "A", "S", "D", "SPACE", "LEFT_SHIFT", "ESCAPE",
                     "F1", "F3", "F5", "F9", "V", "Z", "X", "C", "B", "N",
                     "R", "UP", "DOWN", "LEFT", "RIGHT"]:
        assert required in names, required


def test_tables_equal_the_jax_bindings():
    assert binding._KEYSYM_NAMES == jax_binding._KEYSYM_NAMES
    assert binding._BUTTON_NAMES == jax_binding._BUTTON_NAMES
    for name in ("EV_KEY_DOWN", "EV_KEY_UP", "EV_BTN_DOWN", "EV_BTN_UP",
                 "EV_MOTION", "EV_CLOSE", "EV_RESIZE", "_SCROLL_UP",
                 "_SCROLL_DOWN"):
        assert getattr(binding, name) == getattr(jax_binding, name), name


def test_headless_present_sink():
    got = []
    w = HeadlessWindow(64, 32, frame_sink=got.append)
    frame = np.zeros((32, 64, 4), np.uint8)
    w.present(frame)
    assert len(got) == 1 and got[0].shape == (32, 64, 4)
