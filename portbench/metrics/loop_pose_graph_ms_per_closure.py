"""Host ms of the loop closer's pose graph (`loop_pose_graph`: the
pose-graph program and the reads of its result) per closure
(`loop_optimize` stage)."""


def read(rec):
    n = rec["stage_counts"].get("loop_optimize", 0)
    t = rec["stage_totals"].get("loop_pose_graph")
    return 1e3 * t / n if n and t is not None else None
