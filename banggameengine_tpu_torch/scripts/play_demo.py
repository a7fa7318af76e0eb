"""Run the demo scene headless through the port's Application.

Counterpart of the JAX package's ``examples/play_demo.py``: loads
``scenes/demo.json`` from an asset tree, runs the fixed-step loop with a
scripted input track (idle 2 s while the character falls and lands, walk
toward the checkpoint, sprint after 5 s, jump once a second from 6 s),
prints the status and stats lines and the trigger events, and can write
the frames as PNGs.  The default path is the fused interactive tick;
``--no-fused`` keeps separate step and render calls.  ``--overlay`` turns
the physics overlay (F3) on and takes the separate calls; there, and
whenever ``--record`` is given on them, every display frame is rendered
by ``render_current_frame(hud=True)``: the interpolated motion states,
the overlay's lines and the debug-text HUD.

    python -m banggameengine_tpu_torch.scripts.play_demo --seconds 8
    python -m banggameengine_tpu_torch.scripts.play_demo --overlay \\
        --width 1280 --height 720 --seconds 2
    python -m banggameengine_tpu_torch.scripts.play_demo --device cpu \\
        --seconds 1 --width 128 --height 72 --record /tmp/frames

The asset tree defaults to ``BANG_ASSETS_DIR`` or, without it, the
repository's ``tests/data/app_assets``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

REPO_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "data", "app_assets")
CHECKPOINT_XZ = (5.0, 5.0)


def apply_track(app, i: int, fps: int, cj: int) -> None:
    """Set the scripted input of display frame ``i``: idle for 2 s, then W
    with the camera turned toward the checkpoint, LEFT_SHIFT from 5 s,
    SPACE on the first frame of each second from 6 s.  (The orbit
    controller sets the camera's yaw again before each step reads it, so
    the walk follows the orbit's yaw.)"""
    t = i / fps
    src = app.input.source
    if t < 2.0:
        src.release("W", "LEFT_SHIFT", "SPACE")
    elif t < 5.0:
        src.press("W")
        pos = app.state.pos[cj].cpu().numpy()
        d = np.asarray(CHECKPOINT_XZ) - pos[[0, 2]]
        app.camera.set_yaw_pitch(float(np.arctan2(d[1], d[0])),
                                 app.camera.pitch)
    elif t < 6.0:
        src.press("LEFT_SHIFT")
    elif i % fps == 0:
        src.press("SPACE")
    else:
        src.release("SPACE")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--assets", default=os.environ.get("BANG_ASSETS_DIR",
                                                      REPO_ASSETS))
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--record", default=None, help="PNG output directory")
    p.add_argument("--overlay", action="store_true",
                   help="physics debug overlay (F3) and the HUD; takes the "
                        "separate step and render calls")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="drive the fused interactive tick (substeps + frame "
                        "in one call, events carried back); --no-fused "
                        "keeps separate step and render calls")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from banggameengine_tpu_torch.app import Application
    from banggameengine_tpu_torch.app.window import HeadlessWindow

    window = HeadlessWindow(args.width, args.height, record_dir=args.record)
    # the overlay renders through the separate step and render calls
    fused = args.fused and not args.overlay
    app = Application(assets_root=args.assets, width=args.width,
                      height=args.height, fused_tick=fused,
                      device=args.device)
    app.physics_overlay = args.overlay
    cj = app.built.find_entity("cj")
    for i in range(int(args.seconds * args.fps)):
        apply_track(app, i, args.fps, cj)
        app.frame(real_dt=1.0 / args.fps)
        if fused:
            if args.record and app.last_frame_image is not None:
                window.present(app.last_frame_image)
        elif args.record or args.overlay:
            window.present(app.render_current_frame(hud=True))

    print(app.status_line())
    print(app.physics_stats())
    print(f"trigger events: {[(e.phase.value, app.entity_label(e.other_entity)) for e in app._trigger_log]}")
    if args.record:
        print(f"frames written to {args.record}")


if __name__ == "__main__":
    main()
