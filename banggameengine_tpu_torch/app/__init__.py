"""The application shell: the fixed-step app, input, the orbit camera,
the event bus, the frame timer, the HUD and the windows (the JAX
package's ``app/``)."""

from banggameengine_tpu_torch.app.events import EventBus, TriggerEvent
from banggameengine_tpu_torch.app.timing import Time
from banggameengine_tpu_torch.app.input import InputSystem
from banggameengine_tpu_torch.app.orbit import CameraOrbitController
from banggameengine_tpu_torch.app.application import Application

__all__ = [
    "EventBus",
    "TriggerEvent",
    "Time",
    "InputSystem",
    "CameraOrbitController",
    "Application",
]
