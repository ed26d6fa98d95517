"""Host ms spent waiting at the program's host syncs (its `sync_*`
spans: each `need` read, each pageable upload or read, the telemetry
read-back's event wait) over the window, per process_stream call."""


def read(rec):
    syncs = rec["syncs"]
    waits = [v for k, v in rec["stage_totals"].items()
             if k.startswith("sync_")]
    if not waits or not syncs:
        return None
    return 1e3 * sum(waits) / len(syncs)
