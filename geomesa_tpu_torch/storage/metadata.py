"""Catalog metadata: a small key-value tier with caching.

The port's copy of geomesa_tpu/storage/metadata.py (reference
GeoMesaMetadata / TableBasedMetadata): every store keeps a catalog of
schema specs, user data and index names, fronted by a read cache with
explicit invalidation. Two backends: in-memory (the store's default) and
file-backed (one file per key under a directory, atomic replace writes
at the fault point ``metadata``), both behind :class:`CachedMetadata`.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Optional, Protocol, runtime_checkable

from geomesa_tpu_torch.fault import atomic_write, with_retries

_SAFE_KEY = re.compile(r"^[A-Za-z0-9_.~/-]+$")


@runtime_checkable
class Metadata(Protocol):
    """The GeoMesaMetadata contract (get/insert/remove/scan + cache
    control)."""

    def get(self, key: str) -> Optional[str]: ...

    def insert(self, key: str, value: str) -> None: ...

    def remove(self, key: str) -> None: ...

    def scan(self, prefix: str) -> Iterator[tuple[str, str]]: ...

    def invalidate(self) -> None: ...


class InMemoryMetadata:
    """Dict-backed catalog (the in-process default; reference
    InMemoryMetadata used by TestGeoMesaDataStore)."""

    def __init__(self):
        self._kv: dict[str, str] = {}

    def get(self, key: str) -> Optional[str]:
        return self._kv.get(key)

    def insert(self, key: str, value: str) -> None:
        self._kv[key] = str(value)

    def remove(self, key: str) -> None:
        self._kv.pop(key, None)

    def scan(self, prefix: str):
        for k in sorted(self._kv):
            if k.startswith(prefix):
                yield k, self._kv[k]

    def invalidate(self) -> None:
        pass


class FileMetadata:
    """One file per key under ``root`` with atomic-replace writes (the
    FileBasedMetadata analogue). Keys may contain '/' (subdirectories);
    every path segment is validated filesystem-safe."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if not _SAFE_KEY.match(key) or ".." in key.split("/"):
            raise ValueError(f"metadata key {key!r} is not filesystem-safe")
        return os.path.join(self.root, *key.split("/"))

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def insert(self, key: str, value: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)

        # same durability discipline as the persist tier (fault.
        # atomic_write), retried on transient IO faults — a crashed
        # insert leaves the old value, never a torn file
        with_retries(
            lambda: atomic_write(
                path, str(value).encode("utf-8"), point="metadata"
            )
        )

    def remove(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def scan(self, prefix: str):
        for dirpath, _dirs, files in sorted(os.walk(self.root)):
            for f in sorted(files):
                if f.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    with open(os.path.join(dirpath, f)) as fh:
                        yield key, fh.read()

    def invalidate(self) -> None:
        pass


class CachedMetadata:
    """Read-through cache over any Metadata backend (the TableBasedMetadata
    caching tier): reads hit the cache, writes update both, ``invalidate``
    drops the cache so external changes become visible."""

    def __init__(self, backend: Metadata):
        self.backend = backend
        self._cache: dict[str, Optional[str]] = {}

    def get(self, key: str) -> Optional[str]:
        if key not in self._cache:
            self._cache[key] = self.backend.get(key)
        return self._cache[key]

    def insert(self, key: str, value: str) -> None:
        self.backend.insert(key, value)
        self._cache[key] = str(value)

    def remove(self, key: str) -> None:
        self.backend.remove(key)
        self._cache[key] = None

    def scan(self, prefix: str):
        # scans always hit the backend (prefix coverage of the cache is
        # unknowable); individual results refresh the cache
        for k, v in self.backend.scan(prefix):
            self._cache[k] = v
            yield k, v

    def invalidate(self) -> None:
        self._cache.clear()
        self.backend.invalidate()
