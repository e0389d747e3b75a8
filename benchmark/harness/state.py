"""The harness's own handling of the program's replica states: a device
copy to restore from, and a digest of a converged population that the
check reads once the window has closed. The states are the program's
output; the harness copies and compares them bit for bit and never reads
their layout."""

from __future__ import annotations

import torch


def tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def leaves(x) -> list:
    out = []
    tree_map(out.append, x)
    return out


def snapshot(rt) -> dict:
    """A device copy of every variable's population."""
    return {v: tree_map(torch.clone, st) for v, st in rt.states.items()}


def restore(rt, snap: dict) -> None:
    """Put the copy back (a fresh copy, so the snapshot survives)."""
    for v, st in snap.items():
        rt.states[v] = tree_map(torch.clone, st)


class Digest:
    """What a converged population showed, kept on the device without a
    host sync: per variable, whether every replica's row equals row 0 (bit
    for bit, leaf by leaf), and a copy of row 0."""

    def __init__(self, rt, var_ids):
        self.equal = {}
        self.row0 = {}
        for v in var_ids:
            ls = leaves(rt.states[v])
            flags = [torch.all(leaf == leaf[:1]) for leaf in ls]
            self.equal[v] = torch.stack(flags).all()
            self.row0[v] = [leaf[0].clone() for leaf in ls]

    def rows_apart(self) -> list:
        """The variables whose replicas disagree."""
        return [v for v, flag in self.equal.items() if not bool(flag)]

    def same_as(self, other: "Digest") -> list:
        """The variables whose row 0 differs from ``other``'s."""
        return [v for v in self.row0
                if any(not torch.equal(a, b)
                       for a, b in zip(self.row0[v], other.row0[v]))]

    def values(self, rt, replica_value) -> dict:
        """Each variable's value as the program reads it back from this
        row 0: the row is written into the live population's row 0 and
        read there (the population is not used again)."""
        out = {}
        for v, row in self.row0.items():
            for leaf, saved in zip(leaves(rt.states[v]), row):
                leaf[0].copy_(saved)
            out[v] = replica_value(v, 0)
        return out
