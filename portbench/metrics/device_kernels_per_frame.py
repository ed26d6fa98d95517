"""Kernel executions on the device in the profiled slice, per frame of
the slice (copies and fills not counted)."""


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["device"]:
        return None
    n = sum(not name.startswith(("Memcpy", "Memset"))
            for name, _, _ in sl["device"])
    return n / sl["frames"]
