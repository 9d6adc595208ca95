"""Scheduling framework — plugin points and registry.

Ref: pkg/scheduler/framework/v1alpha1/{interface.go:89-142, framework.go:
30-114, registry.go, context.go}. The v1.15 snapshot exposes exactly two
extension points — Reserve (after a host is chosen, before assume) and
Prebind (before the bind is issued) — which is what this implements, plus
the same supporting pieces: a name->factory Registry, a per-scheduling-
cycle PluginContext K/V store, and a Framework runner that calls every
registered plugin in registration order and stops on the first failure.

Gang extension: a Permit point between Reserve and Prebind (the later
framework versions' WaitOnPermit, interface.go in >= v1.17; coscheduling
builds on it). A permit plugin may return Status.wait(), which parks the
winner with its node RESERVED (assumed in the cache) but unbound; the
shell binds it when a later cycle's permit allows it, or rolls the
reservation back on timeout (scheduler/gang.py drives both edges).

Batch adaptation: the reference runs plugins inside scheduleOne, once per
pod; here the shell calls run_reserve_plugins per winner before its assume
and run_prebind_plugins per winner before the bulk bind — same per-pod
semantics, same ordering guarantees relative to assume/bind
(scheduler.go:507,533).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..api.core import Pod


class PluginContext:
    """Per-cycle scratch shared across plugins (ref: context.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, object] = {}

    def read(self, key: str):
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def write(self, key: str, value) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class Status:
    """Ref: interface.go Status — Success, an error message, or Wait
    (the Permit point's third verdict: hold the reservation, bind later)."""

    WAIT = 2

    def __init__(self, code: int = 0, message: str = ""):
        self.code = code
        self.message = message

    @property
    def success(self) -> bool:
        return self.code == 0

    @property
    def is_wait(self) -> bool:
        return self.code == Status.WAIT

    @staticmethod
    def ok() -> "Status":
        return Status()

    @staticmethod
    def error(message: str) -> "Status":
        return Status(1, message)

    @staticmethod
    def wait(message: str = "") -> "Status":
        return Status(Status.WAIT, message)


class Plugin:
    """Base plugin; subclasses implement reserve, permit and/or prebind
    (ref: ReservePlugin/PrebindPlugin interfaces + the later PermitPlugin)."""

    name = "plugin"

    def reserve(self, ctx: PluginContext, pod: Pod,
                node_name: str) -> Status:
        return Status.ok()

    def permit(self, ctx: PluginContext, pod: Pod,
               node_name: str) -> Status:
        return Status.ok()

    def prebind(self, ctx: PluginContext, pod: Pod,
                node_name: str) -> Status:
        return Status.ok()


class Registry:
    """name -> factory (ref: registry.go)."""

    def __init__(self):
        self._factories: Dict[str, Callable[..., Plugin]] = {}

    def register(self, name: str, factory: Callable[..., Plugin]) -> None:
        if name in self._factories:
            raise ValueError(f"plugin {name} already registered")
        self._factories[name] = factory

    def unregister(self, name: str) -> None:
        self._factories.pop(name, None)

    def build_all(self, *args, **kwargs) -> List[Plugin]:
        # the reference's NewFramework instantiates every registry entry
        # unconditionally (framework.go:58-70)
        return [f(*args, **kwargs) for f in self._factories.values()]


class Framework:
    """Runs the plugin set at each extension point
    (ref: framework.go RunReservePlugins :79, RunPrebindPlugins :96)."""

    def __init__(self, registry: Optional[Registry] = None,
                 plugins: Optional[List[Plugin]] = None):
        self.plugins: List[Plugin] = list(plugins or [])
        if registry is not None:
            self.plugins.extend(registry.build_all())

    def run_reserve_plugins(self, ctx: PluginContext, pod: Pod,
                            node_name: str) -> Status:
        for p in self.plugins:
            st = p.reserve(ctx, pod, node_name)
            if not st.success:
                return Status.error(
                    f"error while running {p.name} reserve plugin for pod "
                    f"{pod.metadata.name}: {st.message}")
        return Status.ok()

    def run_permit_plugins(self, ctx: PluginContext, pod: Pod,
                           node_name: str) -> Status:
        """First error wins; otherwise a single Wait verdict makes the
        whole point Wait (ref: RunPermitPlugins — max of the statuses)."""
        wait: Optional[Status] = None
        for p in self.plugins:
            st = p.permit(ctx, pod, node_name)
            if st.is_wait:
                wait = st
            elif not st.success:
                return Status.error(
                    f"error while running {p.name} permit plugin for pod "
                    f"{pod.metadata.name}: {st.message}")
        return wait if wait is not None else Status.ok()

    def run_prebind_plugins(self, ctx: PluginContext, pod: Pod,
                            node_name: str) -> Status:
        for p in self.plugins:
            st = p.prebind(ctx, pod, node_name)
            if not st.success:
                return Status.error(
                    f"error while running {p.name} prebind plugin for pod "
                    f"{pod.metadata.name}: {st.message}")
        return Status.ok()
