"""StatsStorage: pub/sub persistence for training stats (reference
`deeplearning4j-core/.../api/storage/StatsStorage.java`,
`StatsStorageRouter.java`, `Persistable.java`; backends
`deeplearning4j-ui-model/.../ui/storage/InMemoryStatsStorage.java` and
`FileStatsStorage.java` (MapDB) — the file backend here is append-only
JSONL, which serves the same durability role without a MapDB dependency).

Counterpart of `deeplearning4j_tpu/ui/storage.py`: the same records and
the same file format, so each package reads the other's files."""
from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union


@dataclass
class StatsRecord:
    """One persisted stats update (reference `Persistable` +
    `StatsReport`): arbitrary JSON-serializable `data`."""

    session_id: str
    type_id: str          # e.g. 'stats', 'static_info'
    worker_id: str
    timestamp: float
    data: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(s: str) -> "StatsRecord":
        return StatsRecord(**json.loads(s))


class StatsStorageRouter:
    """Write-side interface (reference `StatsStorageRouter.java`)."""

    def put_record(self, record: StatsRecord) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write+listen interface (reference `StatsStorage.java`)."""

    def __init__(self) -> None:
        self._listeners: List[Callable[[StatsRecord], None]] = []
        self._lock = threading.Lock()

    # -- write --------------------------------------------------------------
    def put_record(self, record: StatsRecord) -> None:
        with self._lock:
            self._store(record)
        for cb in list(self._listeners):
            cb(record)

    def _store(self, record: StatsRecord) -> None:
        raise NotImplementedError

    # -- read ---------------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_workers(self, session_id: str) -> List[str]:
        return sorted({r.worker_id for r in self.get_records(session_id)})

    def get_records(self, session_id: str,
                    type_id: Optional[str] = None,
                    worker_id: Optional[str] = None) -> List[StatsRecord]:
        raise NotImplementedError

    def get_latest_record(self, session_id: str,
                          type_id: Optional[str] = None) -> Optional[StatsRecord]:
        recs = self.get_records(session_id, type_id)
        return recs[-1] if recs else None

    # -- listen -------------------------------------------------------------
    def register_stats_listener(self, cb: Callable[[StatsRecord], None]) -> None:
        self._listeners.append(cb)

    def deregister_stats_listener(self, cb: Callable[[StatsRecord], None]) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)


class InMemoryStatsStorage(StatsStorage):
    """Reference `ui/storage/InMemoryStatsStorage.java`."""

    def __init__(self) -> None:
        super().__init__()
        self._records: List[StatsRecord] = []

    def _store(self, record: StatsRecord) -> None:
        self._records.append(record)

    def list_session_ids(self) -> List[str]:
        return sorted({r.session_id for r in self._records})

    def get_records(self, session_id: str, type_id: Optional[str] = None,
                    worker_id: Optional[str] = None) -> List[StatsRecord]:
        return [r for r in self._records
                if r.session_id == session_id
                and (type_id is None or r.type_id == type_id)
                and (worker_id is None or r.worker_id == worker_id)]


class FileStatsStorage(StatsStorage):
    """Durable append-only JSONL storage (role of
    `ui/storage/FileStatsStorage.java`, which persists via MapDB);
    readable cross-process.

    Queries are served from an in-memory per-session index; only the
    bytes APPENDED since the last read are parsed on refresh (r1 re-read
    and re-parsed the whole file on every dashboard query, which falls
    over on long runs). External truncation/rotation triggers a rebuild."""

    def __init__(self, path: Union[str, Path]):
        super().__init__()
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        if not self._path.exists():
            self._path.touch()
        self._offset = 0                      # bytes fully parsed so far
        self._by_session: dict = {}           # session_id -> [records]

    def _store(self, record: StatsRecord) -> None:
        with open(self._path, "ab") as f:
            f.write((record.to_json() + "\n").encode("utf-8"))

    def _refresh(self) -> None:
        # the UI serves queries from ThreadingHTTPServer handler threads:
        # index mutation must hold the same lock as writes, or concurrent
        # refreshes double-append and push _offset past EOF
        with self._lock:
            size = self._path.stat().st_size
            if size < self._offset:
                # truncated or rotated externally: rebuild from scratch
                self._offset = 0
                self._by_session = {}
            if size == self._offset:
                return
            with open(self._path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
            # consume only COMPLETE lines — a writer may be mid-line
            end = chunk.rfind(b"\n") + 1
            parsed = []
            for line in chunk[:end].decode("utf-8").splitlines():
                if not line.strip():
                    continue
                try:
                    parsed.append(StatsRecord.from_json(line))
                except Exception:
                    # a corrupt line (crashed writer) is skipped, not
                    # retried forever: parse the whole chunk BEFORE
                    # mutating the index, then advance past it
                    import logging

                    logging.getLogger("deeplearning4j_tpu_torch").warning(
                        "FileStatsStorage: skipping malformed record in %s",
                        self._path)
            for r in parsed:
                self._by_session.setdefault(r.session_id, []).append(r)
            self._offset += end

    def list_session_ids(self) -> List[str]:
        self._refresh()
        return sorted(self._by_session)

    def get_records(self, session_id: str, type_id: Optional[str] = None,
                    worker_id: Optional[str] = None) -> List[StatsRecord]:
        self._refresh()
        return [r for r in self._by_session.get(session_id, [])
                if (type_id is None or r.type_id == type_id)
                and (worker_id is None or r.worker_id == worker_id)]
