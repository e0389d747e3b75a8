"""Gossip topologies made from the seed, on the device, in a few large
calls. A table ``int32[R, K]`` lists whom each replica pulls from.

Both generators put one random cycle through every replica in column 0,
so the pull digraph is strongly connected by construction: a converged
population holds the join of every write at every replica, which is what
the reference assumes. (``lasp_tpu_torch.mesh.topology`` draws column 0 as
a random permutation, strongly connected only with high probability.)"""

from __future__ import annotations

import numpy as np
import torch


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _cycle(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``nxt[r]``: one random cycle through all ``n`` replicas."""
    order = torch.randperm(n, generator=gen, device=device)
    nxt = torch.empty(n, dtype=torch.int64, device=device)
    nxt[order] = torch.roll(order, -1)
    return nxt


def random_regular(n: int, k: int, seed: int, device) -> np.ndarray:
    """BASELINE's random gossip: column 0 one random cycle, columns 1..k-1
    random permutations, so every replica pulls from k peers and is pulled
    by k."""
    dev = torch.device(device)
    gen = _generator(dev, seed)
    cols = [_cycle(n, gen, dev)]
    cols += [torch.randperm(n, generator=gen, device=dev) for _ in range(k - 1)]
    return torch.stack(cols, dim=1).to(torch.int32).cpu().numpy()


def scale_free(n: int, k: int, seed: int, device, alpha: float = 1.0) -> np.ndarray:
    """BASELINE's scale-free gossip, in locality order: column 0 is the
    backbone cycle, numbered along itself (replica ``r`` pulls from ``r +
    1``); columns 1..k-1 pull from hubs drawn with Zipf popularity
    ``(rank + 1) ** -alpha``, each rank a replica placed by a random
    permutation."""
    dev = torch.device(device)
    gen = _generator(dev, seed)
    where = torch.randperm(n, generator=gen, device=dev)
    weights = torch.arange(1, n + 1, dtype=torch.float64, device=dev) ** -alpha
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n, k - 1), generator=gen, dtype=torch.float64, device=dev)
    ranks = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    backbone = (torch.arange(n, device=dev) + 1) % n
    table = torch.cat([backbone[:, None], where[ranks]], dim=1)
    return table.to(torch.int32).cpu().numpy()


def most_pulled(table: np.ndarray, k: int) -> list:
    """The ``k`` replicas that most replicas pull from (the hubs), the
    lower index first among equals."""
    counts = np.bincount(table.reshape(-1), minlength=table.shape[0])
    kth = np.partition(counts, counts.size - k)[counts.size - k]
    tied = np.flatnonzero(counts >= kth)
    return sorted(tied.tolist(), key=lambda r: (-counts[r], r))[:k]


BUILDERS = {"random_regular": random_regular, "scale_free": scale_free}


def build(spec: dict, n: int, seed: int, device) -> np.ndarray:
    """The table a configuration's ``topology`` entry names."""
    return BUILDERS[spec["kind"]](n, spec["fanout"], seed, device)
