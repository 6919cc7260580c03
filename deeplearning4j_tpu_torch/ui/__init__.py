"""Observability / UI (reference `deeplearning4j-ui-parent/`, §2.7 of
SURVEY.md): StatsListener capture → StatsStorage (in-memory / file) →
web UI server + remote HTTP routing.

Counterpart of `deeplearning4j_tpu/ui`: the same records, files, routes,
JSON and pages, so either package's listener, router or storage feeds
either package's server."""
from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage,
    InMemoryStatsStorage,
    StatsRecord,
    StatsStorage,
)
from deeplearning4j_tpu_torch.ui.stats_listener import StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
from deeplearning4j_tpu_torch.ui.remote import RemoteUIStatsStorageRouter  # noqa: F401
