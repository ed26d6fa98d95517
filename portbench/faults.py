"""Faults planted in the program under the harness, for the tests and the
readings that show the check catches them (control.py --fault). Each is a
context manager that patches `Tracker` while it is open.

- `state_unchanged`: every stream step returns the pose the tracker had
  when the drive's init ended, as if no step moved its state;
- `half_batch`: half of every batch's poses are never delivered;
- `answer_altered`: the frontend's descriptors of the first frame of
  every batch are altered where the frontend produces them: SIFT's
  shifted by one element, ORB's with two bits of each word flipped.

(A cell of one card has no exchange between chips to leave out.)
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(name: str, wrap):
    from visualslam_tpu_torch.slam.tracker import Tracker

    orig = getattr(Tracker, name)
    setattr(Tracker, name, wrap(orig))
    try:
        yield
    finally:
        setattr(Tracker, name, orig)


def state_unchanged():
    def wrap(orig):
        def process_stream(self, imgs, first):
            out = orig(self, imgs, first)
            init = self.frames[7]
            for fr in out:
                fr.R, fr.t = init.R.copy(), init.t.copy()
            return out
        return process_stream
    return _patched("process_stream", wrap)


@contextlib.contextmanager
def half_batch():
    def half(results):
        return [fr for fr in results if fr.frame_id % 8 < 4]

    with _patched("process_stream", lambda orig: (
            lambda self, imgs, first: half(orig(self, imgs, first)))), \
            _patched("finish", lambda orig: (
                lambda self: half(orig(self)))):
        yield


def alter(feats):
    """Features with the first frame's descriptors altered."""
    d = feats.descriptors.clone()
    if d.dtype.is_floating_point:
        d[0] = d[0].roll(1, -1)
    else:               # ORB's packed bits: flip two in each word
        w = d.view(torch.int32)
        w[0] = torch.bitwise_xor(w[0], 5)
    return feats._replace(descriptors=d)


def answer_altered():
    def wrap(orig):
        def detect_batch(self, imgs):
            return alter(orig(self, imgs))
        return detect_batch
    return _patched("detect_batch", wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
