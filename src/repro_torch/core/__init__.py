"""Chipmink core over torch state: delta-identified incremental
persistence (the paper's contribution).

Public API:
    Chipmink          — save(state)->TimeID / load(names, time_id), plus
                        the versioning surface: branch / tag / checkout /
                        log / diff / gc / evict_branch / fsck (mechanism in
                        repro_torch.version)
    LGA, BundleAll, SplitAll, RandomPolicy, TbH, lga0, lga1
    build_graph, pod_graph
    MemoryStore, FileStore
    FaultyStore, InjectedCrash, RetryPolicy — fault injection + retry
                        policy for the crash-consistency story
    LeaseManager, LeaseHeartbeat — multi-writer leases, fencing tokens,
                        save intents (Chipmink(multi_writer=True))
    DeltaPolicy       — delta-chain pod storage cost model
                        (Chipmink(delta_chains=True))
    readonly_state_leaves, is_static_execution, host_call_is_static —
                        the static checker (§6.3): which state leaves a
                        step provably returns unchanged (`readonly_paths`)
"""
from .graph import ObjectGraph, build_graph, chunk_grid, rebuild_tree
from .async_saver import AsyncSaveError, AsyncSaver
from .checkpoint import Chipmink, TimeID, reflow
from .delta import (DeltaPolicy, apply_pod_delta, encode_pod_delta,
                    parse_delta)
from .faults import (Fault, FaultyStore, InjectedCrash, LEASE_OPS,
                     LeaseFaultInjector, RetryPolicy, call_with_retries,
                     crash_matrix_points, delta_matrix_points,
                     lease_matrix_points)
from .lease import (LEASES_META_KEY, Lease, LeaseHeartbeat, LeaseHeld,
                    LeaseLost, LeaseManager, default_owner)
from .graph_cache import GraphCache, IncrementalBuildInfo
from .lga import (BUNDLE, SPLIT_CONTINUE, SPLIT_FINAL, BundleAll, LGA,
                  PoddingPolicy, RandomPolicy, SplitAll, TbH, expected_cost,
                  lga0, lga1)
from .memo import CROSS_POD_OFFSET, GlobalMemoSpace
from .podding import PodAssignment, Unpodder, pod_graph, serialize_pod
from .store import BaseStore, FileStore, MemoryStore
from .thesaurus import PodThesaurus
from .volatility import (ConstantVolatility, FlipTracker, PriorVolatility,
                         VolatilityModel)
from .active_filter import ActiveVariableFilter
from .ascc import (STATIC_HOST_ALLOWLIST, host_call_is_static,
                   is_static_execution, readonly_state_leaves)
