"""Median ms of the tracker's frontend (`detect_batch`: upload and the
frontend program) on 16 of the window's frames, between CUDA events,
replayed after the window."""

import statistics


def read(rec):
    ms = rec["frontend_ms"]
    return statistics.median(ms) if ms else None
