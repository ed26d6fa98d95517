"""The SIFT kernels' share of their roofline over the profiled slice:
the least time the slice's frontend calls needed (portbench/roofline.py,
from the frames, the configuration and the returned keypoints) over the
device time of the launches of `extrema_winners` and `patch_hist`
(orientation histograms and descriptors), in %."""

from portbench import roofline


def read(rec):
    sl = rec["slice"]
    if not sl or sl["sift_bound_s"] is None:
        return None
    t = sum(e - s for name, s, e in sl["device"]
            if any(k in name for k in roofline.SIFT_KERNELS))
    return 100.0 * sl["sift_bound_s"] / t if t > 0 else None
