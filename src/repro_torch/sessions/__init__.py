"""Multi-tenant session checkpointing: thousands of serving sessions,
one content-addressed store (the ROADMAP's millions-of-users scenario).

`SessionService` multiplexes per-session serving state (KV/SSM caches,
request cursors) onto a shared store through a small pool of `Chipmink`
instances: each session is a `CommitDAG` branch under ``sessions/<id>``,
saves run the full incremental pipeline with per-session detector/cache
state swapped around each call, cross-session pod dedup comes free from
content addressing (shared prompt prefixes collapse to one physical
pod), migration is a `delta_checkout` of the session's branch on another
service instance, and idle eviction reclaims the session's exclusive
bytes in O(session delta) via the refcount GC (`Chipmink.evict_branch`).
"""
from .service import SESSION_NS, FleetStats, SessionContext, SessionService

__all__ = ["SESSION_NS", "FleetStats", "SessionContext", "SessionService"]
