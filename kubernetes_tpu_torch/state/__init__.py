"""State plane: versioned store, watch, typed client, informers, event
recorder — copies of kubernetes_tpu/state's in-process modules.

Not ported yet (ROADMAP, the harnesses and commands item): the
write-ahead log, replication, leader election and work queues.
"""

from .client import Client, PodClient, ResourceClient
from .informer import (EventHandlers, Indexer, SharedInformer,
                       SharedInformerFactory)
from .store import (ADDED, BOOKMARK, DELETED, MODIFIED, AlreadyExistsError,
                    ConflictError, ExpiredError, NotFoundError, Store, Watch,
                    WatchEvent)

__all__ = [n for n in dir() if not n.startswith("_")]
