"""The profiled slice's share of time in which nothing ran on the device:
1 - the union of the device's activity intervals over the slice's span,
in %."""

from portbench import stats


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["device"]:
        return None
    span = sl["end_s"] - sl["start_s"]
    busy = stats.union_length([(s, e) for _, s, e in sl["device"]])
    return 100.0 * (1.0 - busy / span)
