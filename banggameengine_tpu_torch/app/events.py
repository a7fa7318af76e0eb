"""Synchronous type-indexed event bus + trigger event types.

Counterpart of ``banggameengine_tpu/app/events.py`` (the reference's
``EventBus``: subscribe, publish, clear over a type -> handler list).  On
the device, events are the dense planes of
:class:`banggameengine_tpu_torch.state.StepEvents`;
:func:`dispatch_step_events` turns them into bus publishes, the
reference's ``TriggerEvent{Enter, Stay, Exit}`` callbacks.  The three
planes come to the host in one device-to-host copy
(:func:`event_planes`).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Any, Callable, Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")


class TriggerPhase(enum.Enum):
    ENTER = "enter"
    STAY = "stay"
    EXIT = "exit"


@dataclasses.dataclass(frozen=True)
class TriggerEvent:
    """The reference's TriggerEvent payload: which trigger, which other
    entity, which phase."""

    trigger_entity: int
    other_entity: int
    phase: TriggerPhase
    world: int = 0  # world index for many-world batches


class EventBus:
    def __init__(self):
        self._handlers: dict[type, list[Callable[[Any], None]]] = defaultdict(list)

    def subscribe(self, event_type: Type[T], handler: Callable[[T], None]) -> Callable[[], None]:
        self._handlers[event_type].append(handler)

        def unsubscribe():
            try:
                self._handlers[event_type].remove(handler)
            except ValueError:
                pass

        return unsubscribe

    def publish(self, event: Any) -> None:
        for h in list(self._handlers[type(event)]):
            h(event)

    def clear(self) -> None:
        self._handlers.clear()


def event_planes(step_events) -> np.ndarray:
    """bool[3, ..., T, N]: the enter, stay and exit planes on the host, in
    one device-to-host copy."""
    return torch.stack([step_events.trigger_enter, step_events.trigger_stay,
                        step_events.trigger_exit]).cpu().numpy()


def dispatch_event_planes(bus: EventBus, planes: np.ndarray, trig_entity,
                          stay: bool = True, world: int = 0) -> int:
    """Publish the events of one step's host planes ``bool[3, T, N]``
    (enter, stay, exit) in the order Enter, Stay, Exit; returns how many
    were published."""
    te = np.asarray(trig_entity)
    phases = [(TriggerPhase.ENTER, planes[0]), (TriggerPhase.EXIT, planes[2])]
    if stay:
        phases.insert(1, (TriggerPhase.STAY, planes[1]))
    count = 0
    for phase, mat in phases:
        slots, others = np.nonzero(mat)
        for s, o in zip(slots.tolist(), others.tolist()):
            bus.publish(
                TriggerEvent(
                    trigger_entity=int(te[s]), other_entity=o,
                    phase=phase, world=world,
                )
            )
            count += 1
    return count


def dispatch_step_events(bus: EventBus, step_events, trig_entity,
                         stay: bool = True, world: int = 0) -> int:
    """Convert one step's StepEvents -> TriggerEvent publishes.

    Bus subscribers receive Enter/Stay/Exit every step, as the reference
    publishes them; it is the *app* handler that ignores Stay.  Pass
    ``stay=False`` to skip Stay publishes entirely (they fire every step
    while overlapping).  ``trig_entity`` is a host array (or a tensor,
    read here).  Returns the number of events published."""
    if isinstance(trig_entity, torch.Tensor):
        trig_entity = trig_entity.cpu().numpy()
    return dispatch_event_planes(bus, event_planes(step_events), trig_entity,
                                 stay=stay, world=world)
