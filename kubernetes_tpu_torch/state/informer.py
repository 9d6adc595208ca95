"""Informers: reflector + indexer + shared event fan-out.

Ref: staging/src/k8s.io/client-go/tools/cache — Reflector.ListAndWatch
(reflector.go:159), thread-safe Indexer store, sharedIndexInformer
(shared_informer.go:189) with per-listener delivery, and the
SharedInformerFactory. The DeltaFIFO stage is collapsed: the in-process store
already delivers ordered events, so the reflector applies them straight to the
indexer and notifies listeners.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Type

from ..utils.backoff import BackoffPolicy
from ..utils.clock import Clock, REAL_CLOCK
from ..utils.metrics import InformerMetrics
from .client import Client, ResourceClient, apply_bind_fields
from .store import (ADDED, BOOKMARK, DELETED, ExpiredError, MODIFIED,
                    SlimBindRef)


class Indexer:
    """Thread-safe key->object store with named secondary indices
    (ref: tools/cache/thread_safe_store.go)."""

    def __init__(self, index_funcs: Optional[Dict[str, Callable[[Any], List[str]]]] = None):
        self._lock = threading.RLock()
        self._items: Dict[str, Any] = {}
        self._index_funcs = index_funcs or {}
        # index name -> index value -> set of keys
        self._indices: Dict[str, Dict[str, set]] = defaultdict(lambda: defaultdict(set))

    @staticmethod
    def key_of(obj: Any) -> str:
        return obj.metadata.key()

    def _update_indices(self, old: Optional[Any], new: Optional[Any], key: str) -> None:
        for name, fn in self._index_funcs.items():
            idx = self._indices[name]
            if old is not None:
                for v in fn(old):
                    idx[v].discard(key)
                    if not idx[v]:
                        del idx[v]
            if new is not None:
                for v in fn(new):
                    idx[v].add(key)

    def add(self, obj: Any) -> None:
        key = self.key_of(obj)
        with self._lock:
            old = self._items.get(key)
            self._items[key] = obj
            self._update_indices(old, obj, key)

    update = add

    def delete(self, obj: Any) -> None:
        key = self.key_of(obj)
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._update_indices(old, None, key)

    def get_by_key(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self, namespace: Optional[str] = None) -> List[Any]:
        with self._lock:
            items = list(self._items.values())
        if namespace is not None:
            items = [o for o in items if o.metadata.namespace == namespace]
        return items

    def by_index(self, index_name: str, value: str) -> List[Any]:
        with self._lock:
            keys = list(self._indices[index_name].get(value, ()))
            return [self._items[k] for k in keys if k in self._items]

    def replace(self, objs: List[Any]) -> None:
        with self._lock:
            self._items.clear()
            self._indices.clear()
            for obj in objs:
                self.add(obj)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._items)


class EventHandlers:
    def __init__(self, on_add=None, on_update=None, on_delete=None):
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete


class SharedInformer:
    """One reflector per resource type; many handler sets.

    Handlers run on the informer's delivery thread (the reference's
    processorListener goroutines collapse to direct calls here; handlers must
    be fast and push work onto workqueues, which is also the reference's
    contract).

    Failure model (ref: reflector.go ListAndWatch + the watch cache's
    bounded history): the informer tracks `last_sync_rv` — the reference's
    lastSyncResourceVersion — and answers a broken watch stream by
    RECONNECTING the watch at that rv. A full LIST happens only on first
    sync and when the server answers 410 Gone (the rv fell out of the
    bounded history window — Store.HISTORY_WINDOW / ExpiredError).
    Reconnect attempts back off with the shared utils/backoff policy and
    reset once a stream makes progress. A heartbeat-staleness watchdog
    kills wire streams that go silent (the hub heartbeats every second,
    so silence is dead TCP, not an idle cluster) instead of blocking on a
    read that will never return."""

    #: reconnect backoff after a zero-progress watch round (connect
    #: failure or a stream that died before delivering anything)
    BACKOFF = BackoffPolicy(base=0.05, factor=2.0, cap=2.0, attempts=8,
                            jitter=0.2)
    #: kill a wire watch stream with no bytes (heartbeats included) for
    #: this long; in-process store watches have no wire and are exempt
    WATCH_STALENESS_TIMEOUT = 30.0
    #: event-queue poll period — the cadence of stop checks and the
    #: staleness watchdog while the stream is idle
    _POLL = 1.0

    def __init__(self, rc: ResourceClient,
                 index_funcs: Optional[Dict[str, Callable]] = None,
                 metrics: Optional[InformerMetrics] = None):
        self._rc = rc
        self._resource = getattr(rc, "_resource", "")
        self.metrics = metrics if metrics is not None else InformerMetrics()
        self.indexer = Indexer(index_funcs)
        self._handlers: List[EventHandlers] = []
        self._lock = threading.Lock()
        self._started = False
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch = None
        #: rv of the last event processed (or the last LIST) — where a
        #: dropped watch resumes. None until the first sync.
        self.last_sync_rv: Optional[int] = None
        #: whether the transport's watch() accepts `bookmarks=` — probed
        #: from its signature on first connect (None = not yet probed)
        self._bookmark_capable: Optional[bool] = None
        self.staleness_timeout = self.WATCH_STALENESS_TIMEOUT

    def add_event_handlers(self, handlers: EventHandlers) -> None:
        with self._lock:
            self._handlers.append(handlers)
            if self._synced.is_set():
                for obj in self.indexer.list():
                    self._dispatch(handlers.on_add, obj)

    def remove_event_handlers(self, handlers: EventHandlers) -> None:
        """Detach a handler set (a crashed/restarted component must not
        keep receiving deliveries through a shared factory)."""
        with self._lock:
            try:
                self._handlers.remove(handlers)
            except ValueError:
                pass

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            if self._watch is not None:
                self._watch.stop()

    def repoint(self, rc: ResourceClient) -> None:
        """Fail this informer over to a new transport (a promoted standby
        apiserver) WITHOUT a restart: the current watch stream is severed
        and the next round reconnects through `rc` at last_sync_rv. When
        the standby preserved the primary's resourceVersions (the
        StoreReplica contract) and the resume rv is still inside its
        history window, the failover costs one reconnect — no relist, no
        indexer rebuild, and the component's caches stay warm."""
        with self._lock:
            self._rc = rc
            self._resource = getattr(rc, "_resource", self._resource)
            self._bookmark_capable = None  # re-probe the new transport
            if self._watch is not None:
                self._watch.stop()
        self.metrics.repoints.inc(resource=self._resource)

    def _delays(self) -> Iterator[float]:
        """The reconnect schedule: the shared retry-forever policy (a
        reflector retries indefinitely — backoff exhaustion must not
        strand the informer). Jitter is seeded per INSTANCE: after a hub
        restart severs every replica's streams, identically-seeded delays
        would reconnect the whole fleet at the same instants — a
        synchronized herd against the recovering server. The read path
        sits outside the chaos event-log determinism contract, so
        instance-varying jitter breaks nothing."""
        return self.BACKOFF.delays_forever(seed=id(self) & 0xFFFFFFFF,
                                           op=self._resource)

    def _run(self) -> None:
        auth_error_logged = False
        relist = True
        delay_iter: Optional[Iterator[float]] = None
        while not self._stop.is_set():
            resumed = not relist
            try:
                if relist:
                    self._relist()
                    relist = False
                delivered = self._watch_round(resumed)
            except ExpiredError:
                # 410 Gone: last_sync_rv fell out of the server's bounded
                # history window — the ONLY error that costs a full LIST
                # (ref: reflector resourceVersion-too-old path)
                relist = True
                continue
            except PermissionError as e:
                # credential failures are not transient: surface once and
                # back off hard instead of hammering the hub at 20 req/s
                if not auth_error_logged:
                    import sys
                    print(f"informer auth failure (will retry): {e}",
                          file=sys.stderr)
                    auth_error_logged = True
                if self._stop.is_set():
                    return
                self._stop.wait(5.0)
                continue
            except Exception:
                if self._stop.is_set():
                    return
                if delay_iter is None:
                    delay_iter = self._delays()
                self._stop.wait(next(delay_iter))
                continue
            if delivered is None:
                return  # stop() requested
            if delivered > 0:
                delay_iter = None  # the stream made progress: reset backoff

    def _dispatch(self, fn, *args) -> None:
        """Handler exceptions must not tear down the watch loop (a failing
        handler would otherwise force relist storms and leak watches)."""
        if fn is None:
            return
        try:
            fn(*args)
        except Exception:
            import traceback
            traceback.print_exc()

    def _relist(self) -> None:
        """LIST + replace + synthetic delta dispatch — first sync and the
        410 recovery path (ref: DeltaFIFO Replace semantics)."""
        with self._lock:
            if self._watch is not None:  # drop a stale watch from a prior round
                self._watch.stop()
                self._watch = None
        items, rv = self._rc.list_rv()
        old = {k: v for k, v in ((Indexer.key_of(o), o) for o in self.indexer.list())}
        self.indexer.replace(items)
        with self._lock:
            handlers = list(self._handlers)
        for obj in items:
            key = Indexer.key_of(obj)
            prev = old.pop(key, None)
            for h in handlers:
                if prev is None:
                    self._dispatch(h.on_add, obj)
                elif prev.metadata.resource_version != obj.metadata.resource_version:
                    self._dispatch(h.on_update, prev, obj)
        for prev in old.values():
            for h in handlers:
                self._dispatch(h.on_delete, prev)
        self.last_sync_rv = int(rv)
        self.metrics.relists.inc(resource=self._resource)
        self._synced.set()

    def _watch_round(self, resumed: bool) -> Optional[int]:
        """One watch stream's lifetime, connected at last_sync_rv.
        Returns the number of events processed (the caller resets its
        backoff on progress), or None when stop() ended the round.
        Raises ExpiredError on 410 (caller relists) and the stream/
        connect error on a zero-progress round (caller backs off)."""
        # negotiate slim bind frames on transports that support them: the
        # informer (unlike raw watch consumers) holds every object's
        # previous revision and can apply the delta. Instance-level
        # lookup, not type-level, so proxies that forward the attribute
        # (chaos/_FaultyResourceClient) negotiate for their inner client
        # and the wire-chaos soak exercises the same slim path
        # production informers use.
        if getattr(self._rc, "_SLIM_WATCH", None) is False:
            try:
                self._rc._SLIM_WATCH = True
            except AttributeError:
                pass
        # negotiate BOOKMARK heartbeats (allowWatchBookmarks): the
        # server rides its current rv on the idle heartbeat, so
        # last_sync_rv keeps pace with OTHER resources' churn during
        # quiet periods — without them, a long-idle informer's resume rv
        # ages out of the bounded history window and the reconnect costs
        # a full 410 relist. Capability is SIGNATURE-detected once (a
        # transport without the kwarg — test fakes, older proxies — gets
        # a plain watch): wrapping the call in `except TypeError` would
        # misread a genuine TypeError inside watch() as "no bookmark
        # support" and silently disable bookmarks fleet-wide.
        if self._bookmark_capable is None:
            import inspect
            try:
                params = inspect.signature(self._rc.watch).parameters
                self._bookmark_capable = "bookmarks" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
            except (TypeError, ValueError):
                self._bookmark_capable = False
        if self._bookmark_capable:
            watch = self._rc.watch(resource_version=self.last_sync_rv,
                                   bookmarks=True)
        else:
            watch = self._rc.watch(resource_version=self.last_sync_rv)
        with self._lock:
            self._watch = watch
            if self._stop.is_set():  # stop() raced the watch creation
                watch.stop()
                return None
        if resumed:
            self.metrics.watch_reconnects.inc(resource=self._resource)
        delivered = 0
        while True:
            try:
                ev = watch.events.get(timeout=self._POLL)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return None
                # heartbeat-staleness watchdog: the server heartbeats
                # every second, so a wire stream with no bytes at all is
                # dead TCP — kill it and resume at last_sync_rv rather
                # than block forever on a read that will never return
                last_activity = getattr(watch, "last_activity", None)
                if last_activity is not None:
                    stale = time.monotonic() - last_activity
                    self.metrics.watch_staleness.set(
                        stale, resource=self._resource)
                    if stale >= self.staleness_timeout \
                            and hasattr(watch, "kill") \
                            and not getattr(watch, "killed", False):
                        self.metrics.watch_stale_kills.inc(
                            resource=self._resource)
                        watch.kill(f"no bytes for {stale:.1f}s")
                        # the pump notices the dead socket and closes the
                        # queue; keep draining until the None arrives
                continue
            if ev is None:
                break
            if self._stop.is_set():
                return None
            if self._process_event(ev):
                delivered += 1
        if self._stop.is_set():
            return None
        self.metrics.watch_staleness.set(0.0, resource=self._resource)
        err = getattr(watch, "error", None)
        if err is not None:
            self.metrics.watch_stream_errors.inc(
                resource=self._resource, reason=type(err).__name__)
        if delivered == 0:
            # a stream that died (or closed) without ever delivering — a
            # flapping/restarting hub: back off before reconnecting so a
            # dead server isn't hammered. A stream that MADE progress
            # reconnects immediately even when it ended in an error (the
            # caller resets its backoff on the returned count).
            raise err if err is not None else ConnectionError(
                f"watch on {self._resource} closed without progress")
        return delivered

    def _process_event(self, ev) -> bool:
        """Apply one watch event to the indexer, advance last_sync_rv,
        and fan out to handlers. False if the event was dropped (a slim
        frame whose object could not be materialized)."""
        if ev.type == BOOKMARK:
            # object-less heartbeat frame: only the resume point moves.
            # Counts as stream progress (the server is alive), so the
            # caller's reconnect backoff resets like any delivery.
            if ev.resource_version:
                rv = int(ev.resource_version)
                if self.last_sync_rv is None or rv > self.last_sync_rv:
                    self.last_sync_rv = rv
            self.metrics.watch_bookmarks.inc(resource=self._resource)
            return True
        obj = ev.object
        if isinstance(obj, SlimBindRef):
            # negotiated slim bind frame: materialize the bound pod
            # from our cached prior revision (the hub applied exactly
            # these fields to exactly that object)
            cached = self.indexer.get_by_key(
                f"{obj.namespace}/{obj.name}" if obj.namespace
                else obj.name)
            if cached is None:
                try:  # cache miss (relist raced): fall back to a GET
                    obj = self._rc.get(obj.name, namespace=obj.namespace)
                except Exception:
                    return False
            else:
                from ..api import serde
                new = serde.shallow_bind_clone(cached)
                apply_bind_fields(new, obj.node, obj.ts)
                new.metadata.resource_version = str(obj.rv)
                obj = new
        with self._lock:
            handlers = list(self._handlers)
        if ev.type == ADDED:
            prev = self.indexer.get_by_key(Indexer.key_of(obj))
            self.indexer.add(obj)
            for h in handlers:
                if prev is None:
                    self._dispatch(h.on_add, obj)
                else:
                    self._dispatch(h.on_update, prev, obj)
        elif ev.type == MODIFIED:
            prev = self.indexer.get_by_key(Indexer.key_of(obj))
            self.indexer.update(obj)
            for h in handlers:
                self._dispatch(h.on_update, prev if prev is not None else obj, obj)
        elif ev.type == DELETED:
            self.indexer.delete(obj)
            for h in handlers:
                self._dispatch(h.on_delete, obj)
        if ev.resource_version:
            rv = int(ev.resource_version)
            if self.last_sync_rv is None or rv > self.last_sync_rv:
                self.last_sync_rv = rv
        return True

    def wait_for_sync(self, timeout: float = 10.0,
                      clock: Clock = REAL_CLOCK) -> bool:
        """False fast if the informer is stopped (ref: WaitForCacheSync
        returning false when the stop channel closes). Waits on `clock`
        — REAL time by default, since the sync it polls for happens on a
        real watch-pump thread even under a virtual event clock."""
        deadline = clock.now() + timeout
        while True:
            if self._synced.is_set():
                return True
            if self._stop.is_set() or clock.now() >= deadline:
                return False
            clock.sleep(0.005)

    def has_synced(self) -> bool:
        return self._synced.is_set()


def pod_node_name_index(pod) -> List[str]:
    return [pod.spec.node_name] if pod.spec.node_name else []


class SharedInformerFactory:
    """Ref: client-go informers.NewSharedInformerFactory — one informer per
    type, shared across all consumers."""

    def __init__(self, client: Client,
                 metrics: Optional[InformerMetrics] = None,
                 read_client: Optional[Client] = None):
        self._client = client
        #: replica read fan-out (ref: the apiserver's "watch from cache"
        #: served by followers): when set, informers LIST and watch
        #: through THIS client — a follower replica's read-only hub —
        #: while `client` stays the write path. None means reads ride
        #: the primary like before.
        self._read_client = read_client
        #: one metric family set shared by this factory's informers
        #: (series split by resource label)
        self.metrics = metrics if metrics is not None else InformerMetrics()
        self._informers: Dict[Type, SharedInformer] = {}
        self._lock = threading.Lock()
        self._started = False

    def informer_for(self, cls: Type) -> SharedInformer:
        with self._lock:
            inf = self._informers.get(cls)
            created = inf is None
            if created:
                index_funcs = {}
                from ..api.core import Pod
                if cls is Pod:
                    index_funcs["nodeName"] = pod_node_name_index
                rc_client = self._read_client \
                    if self._read_client is not None else self._client
                inf = SharedInformer(rc_client.resource(cls), index_funcs,
                                     metrics=self.metrics)
                self._informers[cls] = inf
            started = self._started
        if started:
            # informers requested after start() join the running factory
            # (the reference requires a second factory.Start; lazy-start
            # removes that footgun for in-process wiring). Every caller —
            # not just the creating one — waits for sync, so a concurrent
            # lookup can't read an unsynced indexer; SharedInformer.start
            # is idempotent under its own lock.
            inf.start()
            inf.wait_for_sync()
        return inf

    def start(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
            self._started = True
        for inf in informers:
            inf.start()

    def repoint(self, client: Client) -> None:
        """Fail every informer over to a new client (promoted standby):
        each reconnects at its last_sync_rv — see SharedInformer.repoint.
        Informers created AFTER this call also ride the new client.
        Clears any replica read routing: after a promote the old
        follower may BE the new primary (or be gone), so reads collapse
        onto the promoted client until a router re-splits them."""
        with self._lock:
            self._client = client
            self._read_client = None
            informers = dict(self._informers)
        for cls, inf in informers.items():
            inf.repoint(client.resource(cls))

    def repoint_reads(self, client: Optional[Client]) -> None:
        """Move only the READ path (LIST + watch) to `client` — the
        replica-read rotation: a lagging follower is swapped out for
        the primary (pass the primary client here), and back in when it
        catches up. Same rv-continuous reconnect as repoint(), but the
        write client is untouched. None collapses reads back onto the
        write client."""
        with self._lock:
            self._read_client = client
            target = client if client is not None else self._client
            informers = dict(self._informers)
        for cls, inf in informers.items():
            inf.repoint(target.resource(cls))

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        with self._lock:
            informers = list(self._informers.values())
        return all(inf.wait_for_sync(timeout) for inf in informers)

    def stop(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.stop()
