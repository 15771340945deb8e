"""The process-wide stats registry behind the HTTP sidecar's
``/stats`` endpoint (and the fleet's ``/fleet/stats`` federation).

Strictly bounded state — at most :data:`PROFILE_CAP` file summaries
(newest win) and :data:`DRIFT_CAP` drift records — so a long-lived
serving replica's registry can never grow with traffic. Everything is
best-effort observability: nothing here is consulted by the data
path.

Port copy of ``cobrix_tpu.stats.service``, unchanged. The HTTP
``/stats`` endpoint and ``/fleet/stats`` come with the port's serve
tier (ROADMAP A8); `snapshot` is their payload.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List

PROFILE_CAP = 64
DRIFT_CAP = 256

_LOCK = threading.Lock()
_PROFILES: "OrderedDict[str, dict]" = OrderedDict()
_DRIFT: deque = deque(maxlen=DRIFT_CAP)
_COUNTS = {"profiles_built": 0, "drift_events": 0}


def note_profiles(profiles: Dict[str, object]) -> None:
    """Record freshly built/loaded file profiles (collect.py calls
    this once per profiling read)."""
    with _LOCK:
        for url, profile in profiles.items():
            summary = profile.summary()
            _PROFILES.pop(url, None)
            _PROFILES[url] = summary
            _COUNTS["profiles_built"] += 1
            while len(_PROFILES) > PROFILE_CAP:
                _PROFILES.popitem(last=False)


def note_drift(events: List[dict]) -> None:
    with _LOCK:
        for event in events:
            record = dict(event)
            record.setdefault("ts", time.time())
            _DRIFT.append(record)
            _COUNTS["drift_events"] += 1


def snapshot() -> dict:
    """The ``/stats`` payload: profile summaries, recent drift, and
    lifetime counts."""
    with _LOCK:
        return {
            "profiles": {url: dict(s) for url, s in _PROFILES.items()},
            "drift": [dict(d) for d in _DRIFT],
            "counts": dict(_COUNTS),
        }


def reset_for_tests() -> None:
    with _LOCK:
        _PROFILES.clear()
        _DRIFT.clear()
        for key in _COUNTS:
            _COUNTS[key] = 0
