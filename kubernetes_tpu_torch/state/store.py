"""Versioned, watchable object store — the L0/L3 storage collapsed in-process.

Semantics follow the reference's etcd3 store + watch cache:
  - one monotonically increasing cluster-wide resourceVersion (etcd revision)
    stamped on every write (ref: etcd3/store.go Create/GuaranteedUpdate)
  - optimistic concurrency: update/delete may require the caller's
    resourceVersion to match (CAS, ref: GuaranteedUpdate preconditions)
  - watches resume from any resourceVersion held in the bounded event history
    window (ref: storage/cacher/cacher.go watchCache), delivered in order
  - per-(resource, namespace) keying like etcd key paths

Thread-safe; watchers receive events on their own unbounded queues so a slow
consumer never blocks writers (the reference's buffered watch channels +
terminate-slow-watcher policy is unnecessary in-process).

Copy discipline (the client-go contract, shared_informer.go doc: "objects
returned from the store MUST be treated as read-only"): the store keeps one
canonical frozen object per key. Writes deep-copy IN (the caller keeps
ownership of what it passed); reads, watch events, and returns share the
canonical object WITHOUT copying. Mutating anything the store handed out is
a bug — mutate a deepcopy_obj() and write it back.

Copy of kubernetes_tpu/state/store.py without durability: the
write-ahead log (state/wal.py and its native appender) is not ported, so
`wal_path=` and `restart()` raise NotImplementedError (ROADMAP, the
harnesses and commands item).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..api import serde

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"


class ConflictError(Exception):
    """resourceVersion precondition failed (HTTP 409 analog)."""


class NotFoundError(KeyError):
    """object does not exist (HTTP 404 analog)."""


class AlreadyExistsError(Exception):
    """create of an existing key (HTTP 409 AlreadyExists analog)."""


class ExpiredError(Exception):
    """watch resourceVersion fell out of the history window (HTTP 410 Gone)."""


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | BOOKMARK
    object: Any
    resource_version: int = 0
    #: optional compact form of a known-shape mutation (today: binds —
    #: {"namespace","name","node","ts"}). In-process consumers ignore it
    #: (object is always the full canonical); the HTTP watch serves it to
    #: clients that negotiated slim frames, the way the reference
    #: negotiates protobuf instead of JSON per Accept header
    slim: Any = None


@dataclass
class SlimBindRef:
    """Placeholder object in a WatchEvent decoded from a negotiated slim
    bind frame: the consumer (SharedInformer) materializes the full pod by
    applying `apply_bind_fields` to its cached copy at the previous
    revision. Only ever produced by the HTTP watch client — store-level
    watches always carry full canonical objects."""
    namespace: str
    name: str
    node: str
    ts: Optional[str]
    rv: int


class Watch:
    """A single watch subscription; iterate or poll via queue."""

    def __init__(self, store: "Store", wid: int):
        self._store = store
        self._id = wid
        self.events: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        self._stopped = False

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self._store._remove_watch(self._id)
            self.events.put(None)

    def __iter__(self):
        while True:
            ev = self.events.get()
            if ev is None:
                return
            yield ev


class Store:
    """The cluster state store. Keys are (resource, namespace, name).

    `wal_path` (durability through a write-ahead log) is not ported and
    raises NotImplementedError."""

    HISTORY_WINDOW = 4096  # retained events for watch resume (watchCache capacity)

    def __init__(self, wal_path: Optional[str] = None,
                 wal_sync: bool = False, metrics=None):
        self._lock = threading.RLock()
        self._rv = 0
        # resource -> {(namespace, name) -> (obj, rv)}
        self._data: Dict[str, Dict[Tuple[str, str], Tuple[Any, int]]] = {}
        # ring of (rv, resource, WatchEvent); trimmed to HISTORY_WINDOW at
        # publish (O(1) popleft, honors runtime window changes)
        self._history: Deque[Tuple[int, str, WatchEvent]] = deque()
        self._watches: Dict[int, Tuple[str, Optional[str], Watch]] = {}
        self._next_watch_id = 0
        self._uid_counter = 0
        self._wal = None
        #: RobustnessMetrics (optional): WAL append-error and replay
        #: recovery accounting ride the owner's registry
        self.metrics = metrics
        #: the last replay's accounting (state/wal.WalRecovery), None
        #: until a WAL-backed store has replayed at least once
        self.wal_recovery = None
        if wal_path is not None:
            raise NotImplementedError(
                "Store(wal_path=...): the write-ahead log is not ported yet "
                "(ROADMAP: harnesses and commands)")

    # ---------------------------------------------------------------- wal

    def _journal(self, op: str, resource: str, obj: Any, rv: int) -> None:
        """Called under the lock after a committed mutation. The frozen
        object is handed to the writer as-is; encoding (serde.encode_cached
        — shared with the watch/list fan-out for the same revision) runs on
        the WAL worker in deferred mode, immediately otherwise."""
        if self._wal is not None:
            self._wal.append(op, resource, rv, obj,
                             uid_counter=self._uid_counter)

    def _wal_commit(self) -> None:
        if self._wal is not None:
            self._wal.flush()

    def flush_wal(self) -> None:
        """Wait until every journaled record is in the file. In deferred
        mode the worker lags the write path by design (a process crash can
        lose that tail, same class as the OS buffer in non-sync mode);
        graceful shutdown, compaction, and tests drain through here."""
        if self._wal is not None:
            self._wal.drain()

    def compact(self) -> None:
        """Rewrite the log as one PUT per live object: nothing to do
        without a write-ahead log."""
        return

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                self._wal.close()
                self._wal = None

    def restart(self, torn: int = 0) -> int:
        """Crash-restart by replaying the write-ahead log, which the port
        does not have yet."""
        raise NotImplementedError(
            "Store.restart: the write-ahead log is not ported yet "
            "(ROADMAP: harnesses and commands)")

    # ------------------------------------------------------------- writes

    def create(self, resource: str, obj: Any) -> Any:
        with self._lock:
            stored = self._create_locked(resource, obj)
            self._wal_commit()
            self._publish(resource,
                          WatchEvent(ADDED, stored,
                                     int(stored.metadata.resource_version)))
            return stored

    def _create_locked(self, resource: str, obj: Any) -> Any:
        """One create under the held lock — journaled but NOT wal-committed
        or published; the caller batches those."""
        # copy BEFORE any stamping: the caller may be holding a canonical
        # object from get()/list(), which must never be written through
        stored = serde.deepcopy_obj(obj)
        meta = stored.metadata
        if meta.generate_name and not meta.name:
            self._uid_counter += 1
            meta.name = f"{meta.generate_name}{self._uid_counter:x}"
        key = (meta.namespace, meta.name)
        bucket = self._data.setdefault(resource, {})
        # an object pending finalization still owns its key (ref: the
        # apiserver returns 409 AlreadyExists until finalizers clear)
        if key in bucket:
            raise AlreadyExistsError(f"{resource} {key} already exists")
        self._rv += 1
        if not meta.uid:
            self._uid_counter += 1
            meta.uid = f"uid-{self._uid_counter:08x}"
        if meta.creation_timestamp is None:
            from ..utils.clock import now_iso
            meta.creation_timestamp = now_iso()
        if meta.generation == 0 and hasattr(stored, "spec"):
            meta.generation = 1  # ref: registry strategies PrepareForCreate
        meta.resource_version = str(self._rv)
        bucket[key] = (stored, self._rv)
        self._journal("PUT", resource, stored, self._rv)
        return stored

    def create_bulk(self, resource: str, objs: List[Any]) -> List[Any]:
        """N creates under ONE lock acquisition and ONE durability point —
        the write-side analog of bulk_apply. Result slots are the stored
        objects or the Exception that rejected that slot (AlreadyExists);
        accepted items commit even when siblings fail, exactly like N
        independent creates."""
        out: List[Any] = []
        events: List[WatchEvent] = []
        with self._lock:
            for obj in objs:
                try:
                    stored = self._create_locked(resource, obj)
                except Exception as e:
                    out.append(e)
                    continue
                out.append(stored)
                events.append(WatchEvent(
                    ADDED, stored, int(stored.metadata.resource_version)))
            self._wal_commit()
            for ev in events:
                self._publish(resource, ev)
        return out

    def update(self, resource: str, obj: Any, *, enforce_rv: bool = True) -> Any:
        with self._lock:
            meta = obj.metadata
            key = (meta.namespace, meta.name)
            bucket = self._data.setdefault(resource, {})
            existing = bucket.get(key)
            if existing is None:
                raise NotFoundError(f"{resource} {key} not found")
            cur_obj, cur_rv = existing
            if enforce_rv and meta.resource_version and int(meta.resource_version) != cur_rv:
                raise ConflictError(
                    f"{resource} {key}: resourceVersion {meta.resource_version} != {cur_rv}")
            self._rv += 1
            # copy BEFORE stamping (the caller may pass a canonical object)
            stored = serde.deepcopy_obj(obj)
            stored.metadata.resource_version = str(self._rv)
            if not stored.metadata.uid:
                stored.metadata.uid = cur_obj.metadata.uid
            if stored.metadata.creation_timestamp is None:
                stored.metadata.creation_timestamp = \
                    cur_obj.metadata.creation_timestamp
            # spec changes bump metadata.generation (ref: registry strategies
            # PrepareForUpdate; status-only writes keep it). The bind hot path
            # (bulk_apply) intentionally skips this comparison.
            if hasattr(stored, "spec"):
                if stored.spec != cur_obj.spec:
                    stored.metadata.generation = cur_obj.metadata.generation + 1
                else:
                    stored.metadata.generation = cur_obj.metadata.generation
            # removing the last finalizer completes a pending deletion
            # (ref: registry/generic Store.Update deleteCollection path)
            if stored.metadata.deletion_timestamp is not None and \
                    not stored.metadata.finalizers:
                del bucket[key]
                self._journal("DELETE", resource, stored, self._rv)
                self._wal_commit()
                self._publish(resource, WatchEvent(DELETED, stored, self._rv))
                return stored
            bucket[key] = (stored, self._rv)
            self._journal("PUT", resource, stored, self._rv)
            self._wal_commit()
            self._publish(resource, WatchEvent(MODIFIED, stored, self._rv))
            return stored

    def delete(self, resource: str, namespace: str, name: str,
               *, resource_version: Optional[str] = None) -> Any:
        with self._lock:
            key = (namespace, name)
            bucket = self._data.setdefault(resource, {})
            existing = bucket.get(key)
            if existing is None:
                raise NotFoundError(f"{resource} {key} not found")
            cur_obj, cur_rv = existing
            if resource_version is not None and int(resource_version) != cur_rv:
                raise ConflictError(f"{resource} {key}: stale resourceVersion")
            # finalizer semantics: objects with finalizers get a deletion
            # timestamp instead of vanishing (ref: registry/generic
            # Store.Delete). Both paths mutate ONLY metadata fields
            # (deletionTimestamp / resourceVersion), so a shallow shell+
            # metadata clone replaces the former full deepcopy — the frozen
            # source keeps every shared sub-object read-only.
            if cur_obj.metadata.finalizers and cur_obj.metadata.deletion_timestamp is None:
                marked = serde.shallow_meta_clone(cur_obj)
                from ..utils.clock import now_iso
                marked.metadata.deletion_timestamp = now_iso()
                self._rv += 1
                marked.metadata.resource_version = str(self._rv)
                bucket[key] = (marked, self._rv)
                self._journal("PUT", resource, marked, self._rv)
                self._wal_commit()
                self._publish(resource, WatchEvent(MODIFIED, marked, self._rv))
                return marked
            del bucket[key]
            self._rv += 1
            final = serde.shallow_meta_clone(cur_obj)
            final.metadata.resource_version = str(self._rv)
            self._journal("DELETE", resource, final, self._rv)
            self._wal_commit()
            self._publish(resource, WatchEvent(DELETED, final, self._rv))
            return final

    def bulk_apply(self, resource: str,
                   items: List[Tuple[str, str, Callable[[Any], Any]]],
                   copy_fn: Callable[[Any], Any] = serde.deepcopy_obj,
                   slim_fn: Optional[Callable[[Any], Any]] = None,
                   ) -> List[Any]:
        """Apply N read-modify-write mutations under ONE lock acquisition.

        The batched analog of N guaranteed_update calls: the scheduler's bind
        phase turns one-bind-POST-per-pod (ref: scheduler.go:549 -> pod/rest
        BindingREST) into a single store transaction. Each (namespace, name,
        mutate) gets a fresh copy of the live object; a mutate may raise to
        skip its item (the error is recorded in the result slot). A caller
        whose mutate only touches known layers may pass a cheaper copy_fn
        (e.g. serde.shallow_bind_clone for the bind subresource).
        """
        out: List[Any] = []
        events: List[Tuple[str, WatchEvent]] = []
        #: slim records of this transaction, journaled as ONE group-commit
        #: "BINDS" WAL record — one encode + one append per bind batch
        #: instead of one per pod (each entry carries its own rv for replay)
        slim_batch: List[Any] = []
        with self._lock:
            bucket = self._data.setdefault(resource, {})
            for namespace, name, mutate in items:
                key = (namespace, name)
                existing = bucket.get(key)
                if existing is None:
                    out.append(NotFoundError(f"{resource} {key} not found"))
                    continue
                try:
                    updated = mutate(copy_fn(existing[0]))
                except Exception as e:  # mutate rejected the object
                    out.append(e)
                    continue
                self._rv += 1
                updated.metadata.resource_version = str(self._rv)
                if updated.metadata.deletion_timestamp is not None and \
                        not updated.metadata.finalizers:
                    del bucket[key]
                    self._journal("DELETE", resource, updated, self._rv)
                    events.append((resource,
                                   WatchEvent(DELETED, updated, self._rv)))
                else:
                    bucket[key] = (updated, self._rv)
                    slim = slim_fn(updated) if slim_fn is not None else None
                    if slim is not None:
                        # known-shape mutation: journal the compact record
                        # (replayed via apply_bind_fields) and hand the
                        # watch layer the same dict — no full-pod encode
                        # on either path
                        if self._wal is not None:
                            rec = dict(slim)
                            rec["rv"] = self._rv
                            slim_batch.append(rec)
                    else:
                        self._journal("PUT", resource, updated, self._rv)
                    events.append((resource,
                                   WatchEvent(MODIFIED, updated, self._rv,
                                              slim=slim)))
                out.append(updated)
            if slim_batch:
                self._wal.append("BINDS", resource, self._rv,
                                 {"binds": slim_batch},
                                 uid_counter=self._uid_counter)
            self._wal_commit()  # one durability point per transaction
            for res, ev in events:
                self._publish(res, ev)
        return out

    #: False on the base store; a follower's store (replication.py
    #: ReadOnlyStore) overrides to True until promoted — the apiserver
    #: answers 503 on writes against a read-only store
    read_only = False

    def _follow_clock_locked(self, rv: int) -> None:
        """Advance the replica's clock to the primary's. The uid/name
        counter tracks 2*rv: the primary bumps it at most twice per
        create (generated name + uid) while rv advances at least once,
        so counter <= 2*rv there — overshooting keeps every post-promote
        generated suffix/uid above anything the primary ever minted."""
        self._rv = max(self._rv, rv)
        self._uid_counter = max(self._uid_counter, 2 * rv)

    def apply_replicated(self, resource: str, obj: Any, rv: int,
                         deleted: bool = False) -> None:
        """Apply one event from a PRIMARY store at the primary's
        resourceVersion (the replication follower's write path — see
        state/replication.py). The replica's clock follows the primary's
        so a promote continues the same CAS timeline; local watches fire
        so read clients of the replica see live events."""
        with self._lock:
            bucket = self._data.setdefault(resource, {})
            key = (obj.metadata.namespace, obj.metadata.name)
            self._follow_clock_locked(rv)
            if deleted:
                existed = bucket.pop(key, None)
                if existed is not None:
                    self._journal("DELETE", resource, obj, rv)
                    self._wal_commit()
                    self._publish(resource, WatchEvent(DELETED, obj, rv))
                return
            cur = bucket.get(key)
            if cur is not None and cur[1] >= rv:
                return  # stale or duplicate frame (relist overlap)
            bucket[key] = (obj, rv)
            self._journal("PUT", resource, obj, rv)
            self._wal_commit()
            self._publish(resource, WatchEvent(
                ADDED if cur is None else MODIFIED, obj, rv))

    def replace_replicated(self, resource: str, objs: List[Any],
                           rv: int) -> None:
        """Apply a full primary LIST as a replace (the reflector's
        Replace semantics): upsert every listed object and PRUNE local
        keys the primary no longer has — an object deleted during a
        watch outage must not survive as a ghost on the replica.

        A listed object at a rv BELOW the local copy's is accepted, not
        skipped: the primary's consistent LIST is authoritative, and a
        lower rv means the primary REGRESSED under the follower (torn-WAL
        recovery truncated history the follower already applied). Keeping
        the lost future would fork the replica from its primary forever —
        the etcd-learner analog is a snapshot resync after leader log
        truncation. Only an rv-identical copy is skipped (no change).
        The replica's own rv clock never regresses (_follow_clock_locked
        keeps the high-water mark), so a later promote still mints rvs
        above anything EITHER timeline handed out."""
        with self._lock:
            bucket = self._data.setdefault(resource, {})
            listed = set()
            for obj in objs:
                key = (obj.metadata.namespace, obj.metadata.name)
                listed.add(key)
                obj_rv = int(obj.metadata.resource_version or 0)
                cur = bucket.get(key)
                if cur is not None and cur[1] == obj_rv:
                    continue
                bucket[key] = (obj, obj_rv)
                self._journal("PUT", resource, obj, obj_rv)
                self._publish(resource, WatchEvent(
                    ADDED if cur is None else MODIFIED, obj, obj_rv))
            for key in [k for k in bucket if k not in listed]:
                gone, gone_rv = bucket.pop(key)
                self._journal("DELETE", resource, gone, rv)
                self._publish(resource, WatchEvent(DELETED, gone, rv))
            self._follow_clock_locked(rv)
            self._wal_commit()

    def guaranteed_update(self, resource: str, namespace: str, name: str,
                          mutate: Callable[[Any], Any], retries: int = 16,
                          copy_fn: Callable[[Any], Any] = serde.deepcopy_obj,
                          ) -> Any:
        """CAS retry loop (ref: etcd3/store.go GuaranteedUpdate :238).
        `copy_fn` is the read-side copy handed to `mutate`: callers whose
        mutator only touches known layers (the bind subresource) pass
        serde.shallow_bind_clone and skip the full deepcopy."""
        for _ in range(retries):
            # get() returns the frozen canonical object; mutate a copy
            updated = mutate(copy_fn(self.get(resource, namespace, name)))
            try:
                return self.update(resource, updated)
            except ConflictError:
                continue
        raise ConflictError(f"{resource} {namespace}/{name}: too many conflicts")

    # ------------------------------------------------------------- reads

    def get(self, resource: str, namespace: str, name: str) -> Any:
        with self._lock:
            existing = self._data.get(resource, {}).get((namespace, name))
            if existing is None:
                raise NotFoundError(f"{resource} {namespace}/{name} not found")
            return existing[0]  # frozen canonical object: read-only

    def list(self, resource: str, namespace: Optional[str] = None,
             label_selector: Optional[Callable[[Any], bool]] = None
             ) -> Tuple[List[Any], int]:
        """Returns (items, listResourceVersion)."""
        with self._lock:
            out = []
            for (ns, _), (obj, _rv) in sorted(self._data.get(resource, {}).items()):
                if namespace is not None and ns != namespace:
                    continue
                if label_selector is not None and not label_selector(obj):
                    continue
                out.append(obj)  # frozen canonical objects: read-only
            return out, self._rv

    def count(self, resource: str) -> int:
        """O(1) object count — cheap emptiness checks for per-request
        admission gates (webhook configs, priority classes)."""
        with self._lock:
            return len(self._data.get(resource, ()))

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    def contents(self) -> Dict[Tuple[str, str, str], int]:
        """{(resource, namespace, name): rv} for every live object — the
        comparison surface for WAL-replay and replication verification
        (chaos/invariants.py checks the journal reconstructs exactly
        this map)."""
        with self._lock:
            return {(resource, ns, name): rv
                    for resource, bucket in self._data.items()
                    for (ns, name), (_obj, rv) in bucket.items()}

    # ------------------------------------------------------------- watch

    def watch(self, resource: str, namespace: Optional[str] = None,
              resource_version: Optional[int] = None) -> Watch:
        """Subscribe to events after `resource_version` (exclusive). None means
        'from now'. Raises ExpiredError if rv is older than the history window
        (clients must relist, ref: 410 Gone -> Reflector relist)."""
        with self._lock:
            self._next_watch_id += 1
            w = Watch(self, self._next_watch_id)
            if resource_version is not None and resource_version > self._rv:
                # a FUTURE rv: no honest client can hold one, so the
                # store's clock must have REGRESSED under this watcher
                # (torn-WAL recovery). Answering "from now" would let the
                # client keep ghost objects the store lost — force the
                # 410 relist instead (ref: apiserver's invalid-rv watch
                # handling; etcd answers ErrFutureRev)
                raise ExpiredError(
                    f"resourceVersion {resource_version} is ahead of the "
                    f"store ({self._rv}): state regressed; relist")
            if resource_version is not None and resource_version < self._rv:
                oldest = self._history[0][0] if self._history else self._rv + 1
                if resource_version + 1 < oldest and resource_version < self._rv:
                    # rv no longer replayable unless it covers everything retained
                    if not (not self._history and resource_version >= self._rv):
                        raise ExpiredError(
                            f"resourceVersion {resource_version} is too old "
                            f"(oldest retained: {oldest})")
                for rv, res, ev in self._history:
                    if rv > resource_version and res == resource:
                        if namespace is None or ev.object.metadata.namespace == namespace:
                            w.events.put(ev)
            self._watches[w._id] = (resource, namespace, w)
            return w

    def _publish(self, resource: str, ev: WatchEvent) -> None:
        # the event shares the canonical frozen object: consumers must not
        # mutate delivered objects (the client-go informer contract)
        self._history.append((ev.resource_version, resource, ev))
        while len(self._history) > self.HISTORY_WINDOW:
            self._history.popleft()
        if self._watches:
            for res, ns, w in list(self._watches.values()):
                if res == resource and (ns is None or
                                        ev.object.metadata.namespace == ns):
                    w.events.put(ev)

    def _remove_watch(self, wid: int) -> None:
        with self._lock:
            self._watches.pop(wid, None)
