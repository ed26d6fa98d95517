"""Device idle ms inside the engine batch, per `engine_dispatch` of the
profiled slice: the slice's device gaps that fall inside the union of the
engine batch's sub-spans (`engine_load`, `engine_step`, `sync_need`,
`engine_promote`, `engine_pack`), which tile `engine_dispatch`."""

from portbench import stats

PARTS = ("engine_load", "engine_step", "sync_need", "engine_promote",
         "engine_pack")


def _union(intervals) -> list:
    """Disjoint, sorted [start, end) intervals covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["device"]:
        return None
    parts = [(s, e) for name, s, e in sl["stages"] if name in PARTS]
    n = sum(name == "engine_dispatch" for name, _, _ in sl["stages"])
    if not parts or not n:
        return None
    gaps = stats.gaps([(s, e) for _, s, e in sl["device"]], sl["start_s"],
                      sl["end_s"])
    return 1e3 * _overlap(gaps, _union(parts)) / n
