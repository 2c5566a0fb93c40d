from repro_torch.storage.backend import (
    FaultyStore,
    FileStore,
    LatencyStore,
    MemoryStore,
    ObjectStore,
    StorageError,
)
from repro_torch.storage.proxy import Proxy, RequestResult, store_coded_object

__all__ = [
    "ObjectStore",
    "MemoryStore",
    "FileStore",
    "LatencyStore",
    "FaultyStore",
    "StorageError",
    "Proxy",
    "RequestResult",
    "store_coded_object",
]
