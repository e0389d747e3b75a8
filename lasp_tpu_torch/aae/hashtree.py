"""Per-replica Merkle hashtrees over each codec's wire leaves (port of
``lasp_tpu.aae.hashtree``).

- **row hashes** — ``hash(states[v][r])`` for every variable ``v`` and
  replica row ``r``, on the runtime's device: every leaf widens to 32-bit
  words as JAX's ``_leaf_words`` does, each word is position-mixed through
  murmur3 fmix32 and the row's words fold by a log-depth XOR; leaves chain
  through the mixer. The results equal JAX's ``uint32`` hashes bit for bit.
- **per-replica trees** — the ``uint32[V, R]`` leaf matrix condenses into
  segment hashes and one root per replica, in host numpy (a copy of JAX's).
- **incremental rehash** — the runtime ORs every tracked row mutation into
  the forest's dirty masks (``ReplicatedRuntime._aae_mark``), so a refresh
  rehashes only dirty rows; a ``verify`` refresh also rehashes the clean
  rows and flags every mismatch with the committed hash as silent
  corruption.

Tree lifetime follows the dispatch plan's: a structural plan invalidation
bumps ``_aae_state_epoch`` (full resync), a mask flip ``_aae_tree_epoch``
(the levels rebuild).

The arithmetic runs in ``int64`` holding ``uint32`` values: torch has no
``uint32`` arithmetic on every device, so every multiply is split in 16-bit
halves (no product passes 2^49) and masked to 32 bits, which keeps the
shifts logical; torch has no XOR reduction, so a row's words fold pairwise,
zero-padded after the mix (zero is the fold's identity). Rows are hashed in
chunks, so a temporary holds at most ``_CHUNK_WORDS`` words. Each hash
dispatch is an ``aae_hash`` record of the kernel cost ledger;
:attr:`HashForest.hash_seconds` totals the hash time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.base import tree_leaves, tree_map
from ..telemetry import counter, span
from ..utils.metrics import Timer

_MASK = 0xFFFFFFFF
#: murmur3 fmix32 constants — the word mixer is a bijection on uint32
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
#: golden-ratio position/leaf salts
_GOLD = np.uint32(0x9E3779B1)
_FNV = np.uint32(0x811C9DC5)
#: words per int64 temporary of the chunked hash (128 MiB)
_CHUNK_WORDS = 1 << 24


def _mix32(x):
    """murmur3 finalizer on numpy ``uint32`` arrays (``*`` wraps)."""
    x = x ^ (x >> np.uint32(16))
    x = x * _M1
    x = x ^ (x >> np.uint32(13))
    x = x * _M2
    x = x ^ (x >> np.uint32(16))
    return x


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the multiplier
    split in 16-bit halves keeps every product below 2**49."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` on int64 tensors holding ``uint32`` values."""
    x = x ^ (x >> 16)
    x = _mul32(x, int(_M1))
    x = x ^ (x >> 13)
    x = _mul32(x, int(_M2))
    return x ^ (x >> 16)


def _leaf_words(flat: torch.Tensor) -> torch.Tensor:
    """``[r, n]`` leaf rows -> ``int64[r, W]`` words in ``[0, 2**32)``:
    bool and 8/16-bit values widen (sign-extended mod 2**32, JAX's
    ``astype(uint32)``), 32-bit values are reinterpreted, a 64-bit value
    splits into its low word then its high word."""
    if flat.dtype == torch.bool:
        return flat.to(torch.int64)
    if flat.element_size() < 4:
        return flat.to(torch.int64) & _MASK
    # 32-bit: the same bits; 64-bit: [r, 2n], the low word first
    return flat.contiguous().view(torch.int32).to(torch.int64) & _MASK


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row's words by a pairwise fold (log-depth)."""
    r, w = x.shape
    if w == 0:
        return torch.zeros((r,), dtype=torch.int64, device=x.device)
    while w > 1:
        if w % 2:
            x = torch.cat([x, torch.zeros((r, 1), dtype=x.dtype, device=x.device)], 1)
            w += 1
        half = w // 2
        x = x[:, :half] ^ x[:, half:]
        w = half
    return x[:, 0]


_POS_CACHE: dict = {}


def _positions(n: int, salt: int, device) -> torch.Tensor:
    """The leaf's per-word position salts (host numpy, as JAX computes
    them), as int64 on ``device``; cached."""
    key = (n, salt, str(device))
    got = _POS_CACHE.get(key)
    if got is None:
        pos = _mix32(np.arange(n, dtype=np.uint32) * _GOLD + np.uint32(salt))
        got = torch.as_tensor(pos.astype(np.int64), device=device)
        if len(_POS_CACHE) > 256:
            _POS_CACHE.clear()
        _POS_CACHE[key] = got
    return got


def _leaf_hash(leaf: torch.Tensor, salt: int) -> torch.Tensor:
    """``int64[R]``: the XOR of one leaf's position-mixed words per row."""
    r = leaf.shape[0]
    flat = leaf.reshape(r, -1)
    n = flat.shape[1] * (2 if flat.element_size() == 8 else 1)
    pos = _positions(n, salt, leaf.device)
    out = torch.empty((r,), dtype=torch.int64, device=leaf.device)
    step = max(1, _CHUNK_WORDS // max(n, 1))
    for lo in range(0, r, step):
        w = _leaf_words(flat[lo: lo + step])
        out[lo: lo + step] = _xor_rows(_mix32_t(w ^ pos))
    return out


def _row_hash_impl(states) -> torch.Tensor:
    """``int64[R]`` holding JAX's ``uint32`` row hashes: position-mixed
    XOR per leaf, leaves chained through the bijective mixer."""
    leaves = tree_leaves(states)
    r = leaves[0].shape[0]
    acc = torch.full((r,), int(_FNV), dtype=torch.int64, device=leaves[0].device)
    for li, leaf in enumerate(leaves):
        salt = (li + 1) * int(_GOLD) & _MASK
        h = _leaf_hash(leaf, salt)
        acc = _mix32_t(acc ^ _mix32_t((h + salt) & _MASK))
    return _mix32_t(acc)


def row_hashes(states) -> np.ndarray:
    """Host ``uint32[R]`` row hashes of one variable's population."""
    return _row_hash_impl(states).cpu().numpy().astype(np.uint32)


def group_row_hashes(stacked) -> np.ndarray:
    """Host ``uint32[G, R]`` for a plan group's ``[G, R, ...]`` stack
    (member by member, where JAX vmaps one kernel over the stack)."""
    g = tree_leaves(stacked)[0].shape[0]
    return np.stack([
        row_hashes(tree_map(lambda x, i=i: x[i], stacked)) for i in range(g)
    ]) if g else np.zeros((0, 0), dtype=np.uint32)


def subset_row_hashes(states, rows: np.ndarray) -> np.ndarray:
    """``uint32[F]`` for the named replica rows only (gather, then hash:
    the incremental arm scales with dirty rows, not the population)."""
    dev = tree_leaves(states)[0].device
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
    return row_hashes(tree_map(lambda x: x[idx], states))


def _np_mix_levels(leafmat: np.ndarray, seg: int):
    """(segmat uint32[NS, R], roots uint32[R]) from the leaf matrix — the
    per-replica tree levels, vectorized across every replica column."""
    v, r = leafmat.shape
    ns = max(1, -(-v // seg))
    padded = np.zeros((ns * seg, r), dtype=np.uint32)
    pos = _mix32(
        np.arange(ns * seg, dtype=np.uint32) * _GOLD + np.uint32(1)
    )
    padded[:v] = leafmat
    mixed = _mix32(padded ^ pos[:, None])
    segmat = _mix32(
        np.bitwise_xor.reduce(mixed.reshape(ns, seg, r), axis=1)
    )
    spos = _mix32(np.arange(ns, dtype=np.uint32) * _GOLD + np.uint32(2))
    roots = _mix32(np.bitwise_xor.reduce(_mix32(segmat ^ spos[:, None]),
                                         axis=0))
    return segmat, roots


class HashForest:
    """The per-runtime tree set: committed row hashes per variable, the
    leaf/segment/root matrices, and the dirty accumulator the runtime
    feeds (attaching registers it as ``runtime._aae_dirty``)."""

    def __init__(self, runtime, seg_size: int = 8,
                 subset_crossover: float = 0.25):
        getattr(runtime, "rt", runtime)._refuse_across("HashForest", 8)
        self.rt = runtime
        self.seg = int(seg_size)
        if self.seg < 1:
            raise ValueError("seg_size must be >= 1")
        #: incremental arm crossover (fraction of rows dirty above which the
        #: full rehash replaces gather + hash)
        self.subset_crossover = float(subset_crossover)
        #: var -> bool[R] rows changed by TRACKED mutations since the last
        #: refresh (the runtime ORs into this; see ``_aae_mark``)
        self.dirty: dict = {}
        #: var -> uint32[R] last-committed row hashes
        self.committed: dict = {}
        self._var_order: tuple = ()
        self._leafmat = np.zeros((0, 0), dtype=np.uint32)
        self.segmat = np.zeros((0, 0), dtype=np.uint32)
        self.roots = np.zeros((0,), dtype=np.uint32)
        self._state_epoch = -1
        self._tree_epoch = -1
        self.rows_hashed = {"incremental": 0, "verify": 0, "full": 0}
        self.segments_rehashed = 0
        self.segments_total = 0
        #: host seconds of the row hashes, device work included (each
        #: dispatch ends in its host read)
        self.hash_seconds = 0.0
        runtime._aae_dirty = self.dirty
        self._resync()

    # -- structure ------------------------------------------------------------
    def _resync(self) -> None:
        """Full structural rebuild: committed hashes drop, every row goes
        dirty, and the next refresh recommits from live state."""
        rt = self.rt
        self._var_order = tuple(rt.var_ids)
        n = rt.n_replicas
        self.committed = {}
        self.dirty.clear()
        for v in self._var_order:
            self.dirty[v] = np.ones(n, dtype=bool)
        self._leafmat = np.zeros(
            (len(self._var_order), n), dtype=np.uint32
        )
        self._state_epoch = rt._aae_state_epoch
        self._tree_epoch = rt._aae_tree_epoch

    def _check_epochs(self) -> None:
        rt = self.rt
        if (
            rt._aae_state_epoch != self._state_epoch
            or self._var_order != tuple(rt.var_ids)
            or (self._leafmat.shape[1] != rt.n_replicas)
        ):
            self._resync()
        elif rt._aae_tree_epoch != self._tree_epoch:
            # mask flip: row hashes are state-pure and stay committed; only
            # the levels rebuild (and the exchange re-pairs)
            self._tree_epoch = rt._aae_tree_epoch
            self._rebuild_levels(range(len(self._var_order)))

    @property
    def var_order(self) -> tuple:
        return self._var_order

    # -- refresh --------------------------------------------------------------
    def _hash_var(self, v: str, rows: "np.ndarray | None") -> np.ndarray:
        """One variable's row hashes — all rows (``rows`` None) or the
        named subset (host uint32)."""
        pop = self.rt._population(v)
        codec, _spec = self.rt._mesh_meta(v)
        with Timer() as t:
            if rows is None:
                out = row_hashes(pop)
            else:
                out = subset_row_hashes(pop, rows)
        self.hash_seconds += t.elapsed
        self._ledger(
            codec.__name__, t.elapsed,
            self.rt.n_replicas if rows is None else int(rows.size),
            self.rt._row_bytes(v),
        )
        return out

    def _ledger(self, codec_name: str, seconds: float, rows: int,
                row_bytes: int, g_active: int = 1) -> None:
        """One hash dispatch into the ``aae_hash`` roofline family (its
        seconds close on the hashes' host read)."""
        from ..telemetry import get_ledger
        from ..telemetry import registry as _reg

        if not _reg.enabled():
            return
        get_ledger().record(
            "aae_hash", codec_name,
            n_replicas=self.rt.n_replicas, fanout=1, seconds=seconds,
            row_bytes=row_bytes, rows=rows, g_active=g_active,
        )

    def refresh(self, verify: bool = False) -> dict:
        """One tree refresh: rehash every DIRTY row (committing it — tracked
        changes are legitimate) and, with ``verify=True``, the CLEAN rows
        too, flagging every committed-hash mismatch as silent corruption.
        Returns ``{"corrupt": [(var, row), ...], "rows_hashed",
        "vars_touched", "verified_rows"}``."""
        self._check_epochs()
        rt = self.rt
        n = rt.n_replicas
        corrupt: list = []
        rows_hashed = 0
        verified = 0
        touched: list = []
        full_vars: list = []
        subset_vars: list = []
        for v in self._var_order:
            d = self.dirty.get(v)
            has_dirty = d is not None and d.any()
            if not has_dirty and not verify:
                continue  # quiescent var: zero work
            if verify or self.committed.get(v) is None or (
                has_dirty and int(d.sum()) > self.subset_crossover * n
            ):
                full_vars.append(v)
            else:
                subset_vars.append(v)
        #: var -> (rows, hashes) of the incremental arm: its commit, leaf
        #: check and level rebuild touch those columns only
        sub_of: dict = {}
        with span("aae.hash", verify=verify):
            fresh_of = {v: self._hash_var(v, None) for v in full_vars}
            for v in subset_vars:
                rows = np.flatnonzero(self.dirty[v])
                sub = self._hash_var(v, rows)
                rows_hashed += int(rows.size)
                self.rows_hashed["incremental"] += int(rows.size)
                self.committed[v][rows] = sub
                self.dirty[v].fill(False)
                sub_of[v] = (rows, sub)
            for v in full_vars:
                fresh = fresh_of[v]
                rows_hashed += n
                self.rows_hashed["verify" if verify else "full"] += n
                committed = self.committed.get(v)
                d = self.dirty.get(v)
                has_dirty = d is not None and d.any()
                if verify and committed is not None:
                    clean = ~d if has_dirty else np.ones(n, dtype=bool)
                    bad = np.flatnonzero(clean & (fresh != committed))
                    verified += int(clean.sum())
                    corrupt.extend((v, int(r)) for r in bad)
                self.committed[v] = fresh
                if has_dirty:
                    d.fill(False)
            cols: "list | None" = []  # the changed columns (None: all)
            for vi, v in enumerate(self._var_order):
                if v in sub_of:
                    rows, sub = sub_of[v]
                    if not np.array_equal(self._leafmat[vi, rows], sub):
                        self._leafmat[vi, rows] = sub
                        touched.append(vi)
                        if cols is not None:
                            cols.append(rows)
                elif v in fresh_of:
                    if not np.array_equal(self._leafmat[vi], self.committed[v]):
                        self._leafmat[vi] = self.committed[v]
                        touched.append(vi)
                        cols = None
        if touched:
            self._rebuild_levels(touched, None if cols is None else np.concatenate(cols))
        if rows_hashed:
            counter(
                "aae_rows_hashed_total",
                help="replica rows rehashed by the AAE forest, by mode "
                     "(incremental dirty-row refresh vs full/verify "
                     "passes)",
                mode="verify" if verify else "refresh",
            ).inc(rows_hashed)
        return {
            "corrupt": corrupt,
            "rows_hashed": rows_hashed,
            "vars_touched": len(touched),
            "verified_rows": verified,
        }

    def rehash_rows(self, var_id: str, rows) -> np.ndarray:
        """Recompute + commit the named rows of one variable (the
        post-repair commit path). Returns their fresh hashes."""
        self._check_epochs()
        rows = np.asarray(rows, dtype=np.int64)
        fresh = self._hash_var(var_id, rows)
        vi = self._var_order.index(var_id)
        committed = self.committed.get(var_id)
        if committed is None:
            committed = self.committed[var_id] = self._hash_var(var_id, None)
            self._leafmat[vi] = committed
            cols = None
        else:
            committed[rows] = fresh
            self._leafmat[vi, rows] = fresh
            cols = rows
        d = self.dirty.get(var_id)
        if d is not None:
            d[rows] = False
        self._rebuild_levels([vi], cols)
        return fresh

    # -- tree levels -----------------------------------------------------------
    def _rebuild_levels(self, touched_vars, cols=None) -> None:
        """Recompute the segment hashes of the segments holding the touched
        leaf rows, then the roots — clean segments keep their hashes. Each
        replica column's levels read that column only, so ``cols`` (the
        replica columns whose leaves changed; None: every column) bounds
        the work."""
        v, r = self._leafmat.shape
        ns = max(1, -(-max(v, 1) // self.seg))
        self.segments_total = ns
        if self.segmat.shape != (ns, r):
            self.segmat, self.roots = _np_mix_levels(self._leafmat, self.seg)
            self.segments_rehashed += ns
            return
        segs = sorted({int(vi) // self.seg for vi in touched_vars})
        if not segs:
            return
        c = slice(None) if cols is None else np.unique(cols)
        leaves = self._leafmat[:, c]
        padded = np.zeros((ns * self.seg, leaves.shape[1]), dtype=np.uint32)
        padded[:v] = leaves
        pos = _mix32(
            np.arange(ns * self.seg, dtype=np.uint32) * _GOLD + np.uint32(1)
        )
        for s in segs:
            lo, hi = s * self.seg, (s + 1) * self.seg
            mixed = _mix32(padded[lo:hi] ^ pos[lo:hi, None])
            self.segmat[s, c] = _mix32(np.bitwise_xor.reduce(mixed, axis=0))
        self.segments_rehashed += len(segs)
        spos = _mix32(np.arange(ns, dtype=np.uint32) * _GOLD + np.uint32(2))
        self.roots[c] = _mix32(
            np.bitwise_xor.reduce(_mix32(self.segmat[:, c] ^ spos[:, None]), axis=0)
        )

    # -- read views ------------------------------------------------------------
    def leaf_matrix(self) -> np.ndarray:
        """uint32[V, R] — row ``vi`` is ``var_order[vi]``'s committed
        hashes across replicas."""
        return self._leafmat

    def describe(self) -> dict:
        return {
            "vars": len(self._var_order),
            "n_replicas": int(self._leafmat.shape[1]),
            "seg_size": self.seg,
            "segments": int(self.segmat.shape[0]),
            "rows_hashed": dict(self.rows_hashed),
            "segments_rehashed": self.segments_rehashed,
            "hash_seconds": self.hash_seconds,
        }
