"""Stage-overlapped frontend -> backend execution (pipeline parallelism;
visualslam_tpu/parallel/pipeline.py).

CUDA launches are asynchronous, so the detection of image batch k+1 is
enqueued on the device BEFORE the host consumes batch k's features for
tracking / window BA: while the host slices features, matches and
assembles BA problems for batch k, the device is already working through
batch k+1's pyramid and detection, a double-buffered producer / consumer
whose buffers are the frontend's output tensors.

Results equal the sequential chunk-by-chunk path (`Tracker.detect_batch`
then `process_features` per frame): the same frontend runs on the same
inputs and the features are consumed in the same order; only the dispatch
timing changes.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np


def batched(seq_len: int, batch: int, start: int = 0
            ) -> Iterator[Tuple[int, List[int]]]:
    """Yield (first_id, ids) chunks covering [start, seq_len)."""
    k = start
    while k < seq_len:
        ids = list(range(k, min(k + batch, seq_len)))
        yield ids[0], ids
        k = ids[-1] + 1


def pipelined_batches(tracker, batch_iter: Iterable[Tuple[int, np.ndarray]]):
    """Generator: runs the tracker over (first_id, imgs[B, H, W]) batches
    with one-batch lookahead.

    For each incoming batch the frontend is dispatched first (the device
    starts working), and only THEN is the previous batch's feature set
    consumed by tracking / BA, so frontend(k+1) overlaps backend(k). Yields
    (ids, [FrameResult, ...]) per batch, in order."""
    prev = None  # (first_id, batched Features, n)
    for first_id, imgs in batch_iter:
        feats = tracker.detect_batch(np.asarray(imgs))   # async dispatch
        if prev is not None:
            yield _consume(tracker, *prev)
        prev = (first_id, feats, len(imgs))
    if prev is not None:
        yield _consume(tracker, *prev)


def _consume(tracker, first_id: int, feats, n: int):
    results = [
        tracker.process_features(tracker.features_at(feats, i), first_id + i)
        for i in range(n)
    ]
    return list(range(first_id, first_id + n)), results


def pipelined_process(tracker, imgs: Sequence[np.ndarray] | np.ndarray,
                      batch: int = 8, first_frame_id: int = 0) -> list:
    """Run a whole image stack through the pipelined tracker. Returns the
    flat [FrameResult, ...] list (the contract of detecting and processing
    chunk by chunk)."""
    imgs = np.asarray(imgs)

    def gen():
        for first, ids in batched(len(imgs), batch):
            yield first + first_frame_id, imgs[first:first + len(ids)]

    out: list = []
    for _, results in pipelined_batches(tracker, gen()):
        out.extend(results)
    return out
