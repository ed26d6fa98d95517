"""Debug / sanitizer modes (visualslam_tpu/utils/debug.py).

The reference debugged out-of-bounds reads by enlarging padding
(Diff_of_Gauss.cpp:568-571). The PyTorch counterparts collected here:

  - `debug_mode()`: torch's anomaly detection for the block, so a NaN
    produced in a backward pass faults at its op with the forward stack;
  - `checked(fn)`: runs fn and reports NaN / inf in its outputs as an
    error object, as the JAX package's checkify wrapper does;
  - kernels: a CUDA error surfaces at the launch that caused it only with
    CUDA_LAUNCH_BLOCKING=1, which must be set in the environment before
    CUDA starts (it cannot be switched on from inside a running process).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Run a block with torch's anomaly checks on."""
    with torch.autograd.set_detect_anomaly(nan_checks, check_nan=nan_checks):
        yield


class CheckError:
    """What `checked` found: `get()` is the message or None, `throw()`
    raises when an output was NaN or inf."""

    def __init__(self, msg: str | None = None):
        self.msg = msg

    def get(self) -> str | None:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise FloatingPointError(self.msg)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)


def checked(fn):
    """Wrap fn: returns (err, out); err.throw() raises when a floating
    output holds NaN or inf. The test reads each output on the host."""
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, x in enumerate(_leaves(out)):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                return CheckError(f"output {i} holds NaN or inf"), out
        return CheckError(), out

    return run
