"""The frontend's check: every valid keypoint of a frontend's output,
frame by frame, judged by the plain SIFT (`sift.py`) or ORB (`orb.py`) of
the configuration, on the frames the program was given.

`numbers` gives the worst frame's numbers of the program's own output,
or, with control=True, of the control put in the program's place at the
same keypoints: the plain frontend in the precision below the
configuration's.
"""

from __future__ import annotations

import torch

from portbench.reference import orb, sift


def _frame(feats, f: int):
    kp = type(feats.keypoints)(*(x[f] for x in feats.keypoints))
    return kp, feats.descriptors[f]


def numbers(frames: torch.Tensor, feats, cfg: dict,
            control: bool = False) -> dict:
    """frames [n, H, W] uint8 on the features' device; feats: the
    frontend's Features of a batch whose first n frames these are; cfg: a
    SlamConfig as a dict."""
    worst: dict = {}
    for f in range(len(frames)):
        kp, desc = _frame(feats, f)
        if cfg["frontend"] == "sift":
            side = sift.program_side(kp, desc, cfg["pyramid"])
            mod = sift
        elif cfg["frontend"] == "orb":
            side = orb.program_side(kp, desc)
            mod = orb
        else:
            raise NotImplementedError(cfg["frontend"])
        if control:
            side = mod.control_side(frames[f], side, cfg)
        for k, v in mod.judge(frames[f], side, cfg).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
