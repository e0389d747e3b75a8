"""The CUDA gossip kernels against their plain PyTorch versions, on the card
(marker ``cuda``; each test skips where there is no CUDA device). Tolerance
zero: every value is a bit or an integer.

This file imports neither ``jax`` nor ``lasp_tpu``, so it also runs on a
machine that has only the port's dependencies, without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from lasp_tpu_torch.ops import cuda_gossip as cg
from lasp_tpu_torch.ops import rows_paths as rp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,d", [(1003, 2, 2), (1003, 3, 1024), (517, 8, 3)])
def test_dense_kernel_matches_plain_on_card(cuda, r, k, d):
    gen = torch.Generator(device=cuda).manual_seed(r + k + d)
    ex = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    rm = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    got = cg.gossip_round_dense(ex, rm, nb)
    want = cg.gossip_round_dense_plain(ex, rm, nb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(rp.K2_PATHS))
@pytest.mark.parametrize("g", [1, 16, 70])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_rows_kernel_matches_plain_on_card(cuda, path, g, k):
    """K2 on each path of its schedule (``rows_paths.K2_PATHS``: 16-, 8-, 4-
    and 1-byte vectors, teams of 1 to 32 lanes), G = 70 above the
    launcher's 64-member table, K above the kernel's ``kFanoutChunk`` of 4;
    masked and unmasked, buckets of 5, 16 and 33 with a duplicate pad slot,
    int64 and int32 rows, and the members as one stacked tensor, unbind
    views, clones and misaligned copies (which take narrower vectors)."""
    _dtype, op, _row, _n, vec, team = rp.K2_PATHS[path]
    row_bytes = rp.row_bytes(path)
    assert cg.rows_schedule(row_bytes, 16) == (vec, team)
    gen = torch.Generator(device=cuda).manual_seed(g * 100 + k + row_bytes)
    r = 500
    leaves = rp.k2_leaves(path, g, r, gen)
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    for masked in (False, True):
        mask = torch.rand((r, k), device=cuda, generator=gen) > 0.4 if masked else None
        for bucket in (5, 16, 33):
            rows = torch.randint(0, r, (g, bucket), device=cuda, generator=gen)
            rows[:, -1] = rows[:, 0]
            want, ch_w = cg.gossip_round_rows_plain(op, leaves, nb, rows, mask)
            for kind in rp.MEMBER_KINDS:
                members = [rp.k2_members(x, kind) for x in leaves]
                for rr in (rows, rows.int()):
                    got, ch = cg.gossip_round_rows(op, members, nb, rr, mask)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for a, b in zip(got, want))
                    assert ch.dtype == torch.bool and torch.equal(ch, ch_w)


@pytest.mark.cuda
@pytest.mark.parametrize("a,e", [(4, 8), (16, 64)])
@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("g", [1, 3, 16])
def test_vclock_kernel_matches_plain_on_card(cuda, a, e, k, masked, g):
    """K3 (OR-SWOT join) against its plain version, bucket 33 with a
    duplicate slot; the leaves as stacked tensors and as member lists."""
    gen = torch.Generator(device=cuda).manual_seed(a * e + k + g)
    r = 500
    clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32, device=cuda, generator=gen)
    dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32, device=cuda, generator=gen)
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    mask = torch.rand((r, k), device=cuda, generator=gen) > 0.4 if masked else None
    rows = torch.randint(0, r, (g, 33), device=cuda, generator=gen)
    rows[:, -1] = rows[:, 0]
    want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
    for c, d in ((clock, dots), (list(clock.unbind(0)), list(dots.unbind(0)))):
        got, ch = cg.gossip_round_rows_vclock(c, d, nb, rows, mask)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ch, ch_w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1026, 1027])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_dense_kernel_slab_path_matches_plain_on_card(cuda, d, k):
    """K1 at R = 65,536, where the automatic schedule cuts column slabs:
    16-, 8- and 4-byte loads and a narrower last slab, into given ``out=``
    buffers."""
    r = 65_536
    gen = torch.Generator(device=cuda).manual_seed(d + k)
    ex = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    rm = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    assert cg.dense_slab_words(r, d, cg.dense_vector_words(d, ex, rm)) < d
    out = (torch.empty_like(ex), torch.empty_like(rm))
    got = cg.gossip_round_dense(ex, rm, nb, out=out)
    want = cg.gossip_round_dense_plain(ex, rm, nb)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == out[0].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("slab_words", [8, 16, 32, 48, 1024])
def test_dense_kernel_every_schedule_matches_plain_on_card(cuda, slab_words):
    r, d, k = 4099, 1024, 3
    gen = torch.Generator(device=cuda).manual_seed(slab_words)
    ex = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    rm = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device=cuda, generator=gen)
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    out = (torch.empty_like(ex), torch.empty_like(rm))
    cg._dense_launch(ex, rm, nb, *out, slab_words)
    want = cg.gossip_round_dense_plain(ex, rm, nb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("a,e,r", list(rp.K3_PATHS.values()))
@pytest.mark.parametrize("g", [1, 16, 70])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_vclock_kernel_paths_match_plain_on_card(cuda, a, e, r, g, k, masked):
    """K3 on each path of its ring: 4-byte copies (A = 3), bulk copies
    (A = 16) and dots rows staged in column chunks (E = 512, A = 64); G = 70
    walks the launcher's 64-member table in two launches; F in {1, 33}."""
    gen = torch.Generator(device=cuda).manual_seed(a + e + g + k)
    clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32, device=cuda, generator=gen)
    dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32, device=cuda, generator=gen)
    members = (list(clock.unbind(0)), list(dots.unbind(0)))
    sched = cg.vclock_launch_schedule(*members, k)
    assert sched.bulk == (a % 4 == 0)
    assert e != 512 or sched.chunk_words < e * a
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    mask = torch.rand((r, k), device=cuda, generator=gen) > 0.4 if masked else None
    for f in (1, 33):
        rows = torch.randint(0, r, (g, f), device=cuda, generator=gen)
        got, ch = cg.gossip_round_rows_vclock(*members, nb, rows, mask)
        want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ch, ch_w)


@pytest.mark.cuda
def test_vclock_kernel_on_misaligned_members_matches_plain_on_card(cuda):
    """Members 4 bytes off a 16-byte boundary take the 4-byte copy path;
    int64 and int32 rows."""
    g, r, e, a, k = 3, 1000, 64, 16, 3
    gen = torch.Generator(device=cuda).manual_seed(5)
    cbuf = torch.randint(0, 7, (g * r * a + 1,), dtype=torch.int32, device=cuda,
                         generator=gen)
    dbuf = torch.randint(0, 7, (g * r * e * a + 1,), dtype=torch.int32, device=cuda,
                         generator=gen)
    clock, dots = cbuf[1:].view(g, r, a), dbuf[1:].view(g, r, e, a)
    members = (list(clock.unbind(0)), list(dots.unbind(0)))
    assert not cg.vclock_launch_schedule(*members, k).bulk
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
    rows = torch.randint(0, r, (g, 33), device=cuda, generator=gen)
    want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows)
    for rr in (rows, rows.int()):  # int64 and int32 rows are read as they are
        got, ch = cg.gossip_round_rows_vclock(*members, nb, rr)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert ch.dtype == torch.bool and torch.equal(ch, ch_w)


# -- the grouped ingest appliers on the card ----------------------------------


def _ingest_group(device, kind, tables):
    """Apply ``tables`` (one per member) as one group on fresh member
    states on ``device``; returns the states and the changed rows."""
    import numpy as np

    from lasp_tpu_torch.lattice import (
        GCounter, GCounterSpec, GSet, GSetSpec, ORSet, ORSetSpec, ORSWOT,
        ORSWOTSpec,
    )
    from lasp_tpu_torch.lattice.base import replicate
    from lasp_tpu_torch.mesh import ingest
    from lasp_tpu_torch.ops.flatpack import FlatORSet, FlatORSetSpec

    r = 64
    codec, spec = {
        "gset": (GSet, GSetSpec(n_elems=16)),
        "gcounter": (GCounter, GCounterSpec(n_actors=4)),
        "orset": (ORSet, ORSetSpec(n_elems=8, n_actors=4, tokens_per_actor=4)),
        "orset_packed": (FlatORSet, FlatORSetSpec(
            dense=ORSetSpec(n_elems=8, n_actors=4, tokens_per_actor=8))),
        "orswot": (ORSWOT, ORSWOTSpec(n_elems=8, n_actors=4)),
    }[kind]
    states = [replicate(codec.new(spec, device=device), r) for _ in tables]
    arrays = [ingest.IngestTable(kind, f"m{i}", 1,
                                 {k: np.asarray(v) for k, v in t.items()})
              for i, t in enumerate(tables)]
    changed = ingest.apply_group(kind, states, arrays, r)
    return [[x.cpu() for x in st] for st in states], changed


def _ingest_on_card_matches_cpu(cuda, kind, tables):
    import numpy as np

    got, ch_got = _ingest_group(cuda, kind, tables)
    want, ch_want = _ingest_group("cpu", kind, tables)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(ch_got, ch_want))
    return got, ch_got


@pytest.mark.cuda
def test_ingest_unequal_tables_never_send_pads_to_the_card(cuda):
    """Members of one group with tables of 1, 9 and 0 slots (JAX would pad
    them to a bucket of 16 with the out-of-range row): each member gets
    exactly its own rows, the empty one nothing."""
    import numpy as np

    tables = [
        {"rows": np.array([63], np.int32), "elems": np.array([15], np.int32)},
        {"rows": np.arange(9, dtype=np.int32), "elems": np.arange(9, dtype=np.int32)},
        {"rows": np.zeros(0, np.int32), "elems": np.zeros(0, np.int32)},
    ]
    got, changed = _ingest_on_card_matches_cpu(cuda, "gset", tables)
    assert int(got[0][0].sum()) == 1 and bool(got[0][0][63, 15])
    assert int(got[1][0].sum()) == 9 and not got[2][0].any()
    assert np.flatnonzero(changed[1]).tolist() == list(range(9))


@pytest.mark.cuda
def test_ingest_duplicate_targets_on_card(cuda):
    """Repeated targets: G-Set sets and G-Counter adds (constant and
    accumulating writes) land as on the CPU; the dense OR-Set's repeated
    tombstone rows are OR-ed first; a repeated value-carrying target is
    refused before any scatter."""
    import numpy as np

    _ingest_on_card_matches_cpu(cuda, "gset", [
        {"rows": np.array([3, 3, 3], np.int32), "elems": np.array([2, 2, 5], np.int32)}])
    got, _ = _ingest_on_card_matches_cpu(cuda, "gcounter", [
        {"rows": np.array([7, 7, 7], np.int32), "lanes": np.array([1, 1, 2], np.int32),
         "amounts": np.array([2, 3, 4], np.int32)}])
    assert got[0][0][7].tolist() == [0, 5, 4, 0]
    vals = np.zeros((2, 16), bool)
    vals[0, 0], vals[1, 1] = True, True
    got, _ = _ingest_on_card_matches_cpu(cuda, "orset", [{
        "m_rows": np.array([4, 4], np.int32), "m_elems": np.array([1, 1], np.int32),
        "m_slots": np.array([0, 1], np.int32),
        "t_rows": np.array([4, 4], np.int32), "t_elems": np.array([1, 1], np.int32),
        "t_vals": vals}])
    assert got[0][1][4, 1, :2].tolist() == [True, True]
    with pytest.raises(RuntimeError, match="repeats its target"):
        _ingest_group(cuda, "orswot", [{
            "d_rows": np.array([1, 1], np.int32), "d_elems": np.array([0, 0], np.int32),
            "d_vals": np.ones((2, 4), np.int32),
            "c_rows": np.zeros(0, np.int32), "c_lanes": np.zeros(0, np.int32),
            "c_vals": np.zeros(0, np.int32)}])


@pytest.mark.cuda
def test_ingest_packed_bit_31_on_card(cuda):
    """The packed OR-Set's uint32 delta masks land as int32 adds: bit 31
    (the sign bit) and a word that takes bits in both the mint and the
    tombstone scatter come out as on the CPU."""
    import numpy as np

    top = np.uint32(1) << np.uint32(31)
    got, _ = _ingest_on_card_matches_cpu(cuda, "orset_packed", [{
        "m_rows": np.array([0, 5], np.int32), "m_words": np.array([0, 7], np.int32),
        "m_masks": np.array([top | np.uint32(1), top], np.uint32),
        "t_rows": np.array([0], np.int32), "t_words": np.array([0], np.int32),
        "t_masks": np.array([top], np.uint32)}])
    assert got[0][0][0, 0].item() == -(2**31) + 1
    assert got[0][0][5, 7].item() == -(2**31)
    assert got[0][1][0, 0].item() == -(2**31)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(rp.K2_PATHS))
@pytest.mark.parametrize("g", [1, 16])
def test_rows_kernel_under_a_chaos_mask_on_card(cuda, path, g):
    """K2 under a chaos-style mask (``rows_paths.chaos_mask``: ~25% dead
    edges and one row with every edge dead, which the rows always name) on
    every path of its schedule, K = 3 and 5, against its plain version."""
    _dtype, op, *_ = rp.K2_PATHS[path]
    gen = torch.Generator(device=cuda).manual_seed(7 * g + rp.row_bytes(path))
    r = 500
    leaves = rp.k2_leaves(path, g, r, gen)
    for k in (3, 5):
        nb = torch.randint(0, r, (r, k), dtype=torch.int32, device=cuda, generator=gen)
        mask = rp.chaos_mask(r, k, gen)
        rows = torch.randint(0, r, (g, 33), device=cuda, generator=gen)
        rows[:, 1] = 1  # the all-dead row
        want, ch_w = cg.gossip_round_rows_plain(op, leaves, nb, rows, mask)
        got, ch = cg.gossip_round_rows(op, leaves, nb, rows, mask)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(ch, ch_w) and not ch[:, 1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(rp.K3_PATHS))
@pytest.mark.parametrize("g", [1, 16])
def test_vclock_kernel_under_a_chaos_mask_on_card(cuda, path, g):
    """K3 on its 4-byte, bulk and column-chunked paths under a chaos-style
    mask, against its plain version; the all-dead row keeps its state."""
    a, e, r = rp.K3_PATHS[path]
    gen = torch.Generator(device=cuda).manual_seed(a + e + g)
    clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32, device=cuda, generator=gen)
    dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32, device=cuda, generator=gen)
    members = (list(clock.unbind(0)), list(dots.unbind(0)))
    nb = torch.randint(0, r, (r, 3), dtype=torch.int32, device=cuda, generator=gen)
    sched = cg.vclock_launch_schedule(*members, 3)
    assert sched.bulk == (a % 4 == 0)
    mask = rp.chaos_mask(r, 3, gen)
    rows = torch.randint(0, r, (g, 33), device=cuda, generator=gen)
    rows[:, 1] = 1
    want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
    got, ch = cg.gossip_round_rows_vclock(*members, nb, rows, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(ch, ch_w) and not ch[:, 1].any()
