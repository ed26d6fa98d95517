"""The 95th percentile (nearest rank) of the traced run's pose latencies:
`pose_latency_p95_ms` where it stands as a per-layer metric (ORB's drive
times fall in two groups from run to run, too far apart to bound)."""

from portbench import stats


def read(rec):
    lat = rec.get("latencies_s")
    return 1e3 * stats.p95(lat) if lat else None
