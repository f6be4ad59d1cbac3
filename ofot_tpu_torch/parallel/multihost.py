"""Host partitioning of a sweep.

Counterpart of the host-partition half of ``ofot_tpu.parallel.multihost``:
independent Middlebury sequences need no communication at all, so
``partition_keys`` deterministically splits the sequence list across
hosts; each host runs its share of the sweep with local flag-file resume,
and the per-host manifest shards merge trivially (``merge_manifests``).
The multi-process initialization (``initialize``) belongs to the
distribution layer, which is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path


def partition_keys(keys, process_id: int, process_count: int):
    """Deterministic round-robin split of sequence keys across hosts."""
    keys = sorted(keys)
    return [k for i, k in enumerate(keys) if i % process_count == process_id]


def merge_manifests(paths, out_path: str) -> dict:
    """Merge per-host manifest shards into one manifest.json."""
    merged: dict = {}
    for p in paths:
        p = Path(p)
        if p.exists():
            merged.update(json.loads(p.read_text()))
    Path(out_path).write_text(json.dumps(merged, indent=1))
    return merged
