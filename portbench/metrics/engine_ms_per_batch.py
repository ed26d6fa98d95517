"""Host ms of the tracker's `engine_dispatch` stage per dispatch (it
absorbs the device time before each frame's `need` read)."""


def read(rec):
    n = rec["stage_counts"].get("engine_dispatch", 0)
    return 1e3 * rec["stage_totals"]["engine_dispatch"] / n if n else None
