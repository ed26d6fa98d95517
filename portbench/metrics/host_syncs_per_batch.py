"""Host syncs torch's sync debug mode reports inside each of the window's
process_stream calls, per call."""


def read(rec):
    syncs = rec["syncs"]
    return sum(syncs) / len(syncs) if syncs else None
