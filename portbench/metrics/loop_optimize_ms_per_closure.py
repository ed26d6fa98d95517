"""Host ms of the tracker's `loop_optimize` stage (the pose graph and
the map's correction) per closure."""


def read(rec):
    n = rec["stage_counts"].get("loop_optimize", 0)
    return 1e3 * rec["stage_totals"]["loop_optimize"] / n if n else None
