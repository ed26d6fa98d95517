"""All-pairs descriptor distances (visualslam_tpu/ops/distance.py)."""

from __future__ import annotations

import torch


def l2sq_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. a: [..., Ka, D], b: [..., Kb, D] ->
    [..., Ka, Kb] float32, as |a|^2 + |b|^2 - 2 a.b clamped at 0. One
    float32 product (TF32 off, frontend.detect_and_describe): TF32's
    rounding of a.b would flip near-tied ratio tests."""
    a = a.float()
    b = b.float()
    ab = a @ b.transpose(-1, -2)
    na = (a * a).sum(dim=-1, keepdim=True)
    nb = (b * b).sum(dim=-1, keepdim=True)
    return (na + nb.transpose(-1, -2) - 2.0 * ab).clamp_min(0.0)


def packed_words(words: torch.Tensor) -> torch.Tensor:
    """Bit-packed uint32 words as int64 values in [0, 2^32). torch has few
    kernels for uint32 (no shifts, no multiplies; no indexing on the card
    in some releases): the words are read through an int32 view, whose
    conversion every release has."""
    return words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def pack_words(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the uint32 words' bits
    (`.view(torch.uint32)` gives the words)."""
    signed = torch.where(values >= 2 ** 31, values - 2 ** 32, values)
    return signed.to(torch.int32)


def unpack_bits(packed: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """[..., K, Wd] uint32 -> [..., K, Wd * 32] {0, 1} float32, little-endian
    bit order within each word (the shifts run in int64)."""
    shifts = torch.arange(bits, dtype=torch.int64, device=packed.device)
    b = (packed_words(packed)[..., None] >> shifts) & 1
    return b.flatten(-2).float()


def hamming_distance_matrix(a_packed: torch.Tensor,
                            b_packed: torch.Tensor) -> torch.Tensor:
    """Hamming distances between bit-packed descriptors [..., K, Wd] uint32
    -> [..., Ka, Kb] float32, as |a| + |b| - 2 a.b on the unpacked bits (a
    float32 product of {0, 1} values: exact)."""
    a = unpack_bits(a_packed)
    b = unpack_bits(b_packed)
    ab = a @ b.transpose(-1, -2)
    na = a.sum(dim=-1, keepdim=True)
    nb = b.sum(dim=-1, keepdim=True)
    return na + nb.transpose(-1, -2) - 2.0 * ab
