"""The paths of K2's launch schedule that the on-card parity checks walk
(``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``), and the kinds
of member tensor K2 is handed, in one place so that both checks hold the
kernel to the same cases."""

from __future__ import annotations

import math

import torch

#: label -> (leaf dtype, op, row shape, leaves, vector bytes, team lanes);
#: the last two are what ``cuda_gossip.rows_schedule`` gives 16-byte-aligned
#: members. Members off that alignment (``MEMBER_KINDS``) take narrower
#: vectors and wider teams: teams of 16 lanes come from them.
K2_PATHS = {
    "gset bool[64]": (torch.bool, "or", (64,), 1, 16, 4),
    "gcounter int32[16]": (torch.int32, "max", (16,), 1, 16, 4),
    "packed 2 x 128 words": (torch.int32, "or", (128,), 2, 16, 32),
    "packed 2 x (16, 2) words": (torch.int32, "or", (16, 2), 2, 16, 8),
    "bool[16] (a team of one lane)": (torch.bool, "or", (16,), 1, 16, 1),
    "int32[4] max (a team of one lane)": (torch.int32, "max", (4,), 1, 16, 1),
    "int32[8] max (teams of two)": (torch.int32, "max", (8,), 1, 16, 2),
    "int32[6] max": (torch.int32, "max", (6,), 1, 8, 4),
    "int32[3] max": (torch.int32, "max", (3,), 1, 4, 4),
    "bool[5]": (torch.bool, "or", (5,), 1, 1, 8),
    "bool[1000] (the team walks the row)": (torch.bool, "or", (1000,), 1, 8, 32),
    "int32[300] words (the team walks the row)": (torch.int32, "or", (300,), 1, 16, 32),
}

#: how a leaf's G members reach K2: one stacked ``[G, R, ...]`` tensor, its
#: unbind views, clones, or copies one element past the allocator's alignment
MEMBER_KINDS = ("stacked", "views", "clones", "offset")


def row_bytes(path: str) -> int:
    """The bytes of one leaf row on ``path``."""
    dtype, _op, row, *_ = K2_PATHS[path]
    return math.prod(row) * (1 if dtype == torch.bool else 4)


def k2_leaves(path: str, g: int, r: int, gen: torch.Generator) -> list:
    """Random ``[G, R, ...]`` leaves for ``path`` on ``gen``'s device: 0 / 1
    bools, small ints for ``max`` (so folds tie), any word for ``or``."""
    dtype, op, row, n_leaves, *_ = K2_PATHS[path]
    shape, dev = (g, r) + row, gen.device
    if dtype == torch.bool:
        return [torch.randint(0, 2, shape, device=dev, generator=gen).bool()
                for _ in range(n_leaves)]
    lo, hi = (-50, 50) if op == "max" else (-2**31, 2**31 - 1)
    return [torch.randint(lo, hi, shape, dtype=torch.int32, device=dev, generator=gen)
            for _ in range(n_leaves)]


def k2_members(leaf: torch.Tensor, kind: str):
    """One ``[G, R, ...]`` leaf as K2 is handed it (``MEMBER_KINDS``); the
    offset copies start 4 bytes off for int32, 1 byte for bool."""
    if kind == "stacked":
        return leaf
    if kind == "views":
        return list(leaf.unbind(0))
    if kind == "clones":
        return [m.clone() for m in leaf.unbind(0)]
    buf = torch.empty(leaf.numel() + 1, dtype=leaf.dtype, device=leaf.device)
    buf[1:] = leaf.flatten()
    return list(buf[1:].view(leaf.shape).unbind(0))


#: K3's ring paths as (A, E, R): 4-byte copies (A = 3), bulk copies (A = 16)
#: and dots rows wider than a stage, staged in column chunks (E = 512, A = 64)
K3_PATHS = {"4-byte": (3, 8, 1000), "bulk": (16, 64, 1000),
            "column-chunked": (64, 512, 128)}


def chaos_mask(r: int, k: int, gen: torch.Generator, dead: float = 0.25,
               dead_row: int = 1) -> torch.Tensor:
    """A seeded chaos-style ``bool[R, K]`` edge mask on ``gen``'s device:
    about ``dead`` of the edges dead, and every edge of ``dead_row`` dead
    (a crashed or isolated replica: its gather must keep its own row)."""
    mask = torch.rand((r, k), device=gen.device, generator=gen) >= dead
    mask[dead_row] = False
    return mask
