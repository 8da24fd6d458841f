"""Read-side query stack: Reader → Planner → Executor.

  * :mod:`repro_torch.search.reader`  — read-only index snapshots with their
    own search-I/O accounting and a byte-budgeted three-tier posting cache
    (host lists, settled prefixes, int32 device rows),
  * :mod:`repro_torch.search.plan`    — typed ``Query → QueryPlan`` routing
    over the four lookup paths, batched and vectorized,
  * :mod:`repro_torch.search.service` — ``SearchService.search_batch``: the
    plan → scatter-fetch → join → gather pipeline with the streaming
    top-k stage,
  * :mod:`repro_torch.search.replica` — the replica read fabric: N replica
    readers per shard subscribing to the writer's touched-key digest
    stream, with least-loaded wave routing and mid-batch failover,
  * :mod:`repro_torch.search.pool`    — the cross-query chunk pool,
  * :mod:`repro_torch.search.join`    — the interchangeable join backends
    (numpy oracle, torch, cuda),
  * :mod:`repro_torch.search.scoring` — the ranked-retrieval score.
"""

from repro_torch.search.join import (
    JOIN_BACKENDS,
    cuda_join_many,
    cuda_window_join,
    numpy_phrase_join,
    numpy_window_join,
    pack_keys,
    pos_scale,
    torch_join_many,
    torch_window_join,
)
from repro_torch.search.plan import (
    ROUTE_MULTI,
    ROUTE_ORDINARY,
    ROUTE_STOPSEQ,
    ROUTE_WV,
    ROUTES,
    KeyLookup,
    MultiKeySpec,
    PlannedQuery,
    Query,
    QueryPlan,
    QueryResult,
    plan_batch,
)
from repro_torch.search.scoring import (
    PROX_SCALE,
    TF_CAP,
    ScoreSpec,
    head_order,
    score_docs,
    score_docs_torch,
    spec_for,
)
from repro_torch.search.reader import (
    CacheStats,
    IndexReader,
    IndexSetReader,
    PostingCache,
    ReaderCursor,
    ShardedIndexSetReader,
)
from repro_torch.search.replica import (
    AllReplicasDeadError,
    ReplicaDeadError,
    ReplicaReader,
    ReplicaSetReader,
)
from repro_torch.search.service import (
    SearchService,
    SnapshotViolationError,
    TraceIncompleteError,
)

__all__ = [
    "JOIN_BACKENDS",
    "cuda_join_many",
    "cuda_window_join",
    "numpy_phrase_join",
    "numpy_window_join",
    "pack_keys",
    "pos_scale",
    "torch_join_many",
    "torch_window_join",
    "ROUTE_MULTI",
    "ROUTE_ORDINARY",
    "ROUTE_STOPSEQ",
    "ROUTE_WV",
    "ROUTES",
    "KeyLookup",
    "MultiKeySpec",
    "PlannedQuery",
    "Query",
    "QueryPlan",
    "QueryResult",
    "plan_batch",
    "PROX_SCALE",
    "TF_CAP",
    "ScoreSpec",
    "head_order",
    "score_docs",
    "score_docs_torch",
    "spec_for",
    "CacheStats",
    "IndexReader",
    "IndexSetReader",
    "PostingCache",
    "ReaderCursor",
    "ShardedIndexSetReader",
    "AllReplicasDeadError",
    "ReplicaDeadError",
    "ReplicaReader",
    "ReplicaSetReader",
    "SearchService",
    "SnapshotViolationError",
    "TraceIncompleteError",
]
