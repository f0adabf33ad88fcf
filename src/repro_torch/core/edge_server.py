"""Multi-tenant edge-server vocabulary.

Only the allocation-policy names are ported so far, so that ``FleetSpec``
validates and round-trips; the admission scheduler itself is not ported yet.
"""
from __future__ import annotations

ALLOCATION_POLICIES = ("weighted_fair", "priority", "fifo")
