"""The launch logic of the port's CUDA kernels, which stays in Python where
these CPU tests reach it (``lasp_tpu_torch.ops.cuda_gossip``): K1's
column-slab schedule, K2's vector width and team size (and the paths of
its on-card parity table), K3's choice of copy path and stage chunk, the
arguments the wrappers refuse, the row-sparse bound of ``chip_smoke.py``,
and the per-shape launch log. The kernels
themselves run only on the card (tests/test_torch_cuda_kernels.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lasp_tpu_torch.ops import cuda_gossip as cg
from lasp_tpu_torch.ops import rows_paths as rp

REPO = Path(__file__).resolve().parents[1]

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)


def _offset_view(shape, words: int) -> torch.Tensor:
    """An int32 tensor of ``shape`` whose address is ``4 * words`` bytes past
    a 64-byte-aligned allocation."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + words, dtype=torch.int32)
    assert buf.data_ptr() % 16 == 0
    return buf[words:].view(shape)


# -- K1: column slabs ----------------------------------------------------------


@pytest.mark.parametrize("r,d", [
    (1003, 1024), (100_000, 128), (1 << 18, 1024), (65_536, 1024),
    (65_536, 1026), (65_536, 1027), (1 << 22, 2), (7, 3), (1 << 24, 64),
    (32_768, 128), (4_096, 1024), (10_485_760, 1), (10_485_760, 4),
])
def test_dense_schedule_takes_whole_rows_only_when_both_planes_fit(r, d):
    """K1's slab width at any shape: slabs even where both planes fit the
    L2 (the in-budget sweep in PERF.md found slabs faster there too), whole
    rows only when a row is no wider than the narrowest slab."""
    for vec in (v for v in (1, 2, 4) if d % v == 0):
        w = cg.dense_slab_words(r, d, vec)
        assert (w == d) == (d <= max(cg.DENSE_MIN_SLAB_WORDS, vec))
        assert w % vec == 0 and 0 < w <= d
        if w > min(max(cg.DENSE_MIN_SLAB_WORDS, vec), d):  # above the floor:
            assert r * w * 4 <= cg.DENSE_SLAB_BYTES      # within the span
            assert w * cg.DENSE_MIN_SLABS <= d           # and the slab count
        # and the widest such: doubling would break a limit
        assert (w == d or 2 * w * cg.DENSE_MIN_SLABS > d
                or r * 2 * w * 4 > cg.DENSE_SLAB_BYTES)


def test_dense_schedule_at_the_main_path_shapes():
    """The slabs K1's sweep chose (PERF.md): the headline's 4 KB rows
    (2**18 replicas x 1,024 words) in 64-word slabs, the engine's 512-byte
    flat OR-Set rows (100,000 x 128 words) in 32-word slabs; the small
    parity planes (1,003 replicas) in quarter rows; the adcounter's 1- and
    4-word rows (10,485,760 replicas) whole, a row a load."""
    assert cg.dense_slab_words(1 << 18, 1024, 4) == 64
    assert cg.dense_slab_words(100_000, 128, 4) == 32
    assert cg.dense_slab_words(1003, 1024, 4) == 256
    aligned = torch.zeros((8, 4), dtype=torch.int32)
    assert cg.dense_vector_words(1, aligned) == 1
    assert cg.dense_slab_words(10_485_760, 1, 1) == 1
    assert cg.dense_vector_words(4, aligned) == 4
    assert cg.dense_slab_words(10_485_760, 4, 4) == 4


@pytest.mark.parametrize("d,w", [(1024, 16), (1027, 16), (1026, 8), (7, 8),
                                 (32, 32), (100, 64)])
def test_dense_slab_columns_cover_every_word_once(d, w):
    cols = cg.dense_slab_columns(d, w)
    hits = np.zeros(d, dtype=int)
    for start, stop in cols:
        assert 0 < stop - start <= w
        hits[start:stop] += 1
    assert (hits == 1).all()
    assert [c[0] for c in cols] == list(range(0, d, w))


@pytest.mark.parametrize("d,w", [(37, 8), (64, 16), (5, 8)])
def test_round_slab_by_slab_equals_the_whole_round(d, w):
    """The column-slab schedule's premise: each output word depends only on
    the same word of the own row and the neighbour rows, so the round run
    slab by slab is the round."""
    rng = np.random.RandomState(d + w)
    r, k = 300, 3
    ex = torch.as_tensor(rng.randint(-2**31, 2**31 - 1, (r, d), dtype=np.int64).astype(np.int32))
    rm = torch.as_tensor(rng.randint(-2**31, 2**31 - 1, (r, d), dtype=np.int64).astype(np.int32))
    nb = torch.as_tensor(rng.randint(0, r, (r, k)).astype(np.int32))
    want = cg.gossip_round_dense_plain(ex, rm, nb)
    got = (torch.empty_like(ex), torch.empty_like(rm))
    for start, stop in cg.dense_slab_columns(d, w):
        for out, part in zip(got, cg.gossip_round_dense_plain(
                ex[:, start:stop], rm[:, start:stop], nb)):
            out[:, start:stop] = part
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_dense_vector_words_follow_width_and_alignment():
    aligned = torch.zeros((4, 1024), dtype=torch.int32)
    assert cg.dense_vector_words(1024, aligned, aligned) == 4
    assert cg.dense_vector_words(1026, aligned) == 2
    assert cg.dense_vector_words(1027, aligned) == 1
    assert cg.dense_vector_words(1024, aligned, _offset_view((4, 1024), 2)) == 2
    assert cg.dense_vector_words(1024, _offset_view((4, 1024), 1), aligned) == 1


# -- K2: vectors and teams --------------------------------------------------------


@pytest.mark.parametrize("row_bytes,aligned,vec,team", [
    (64, 16, 16, 4),     # the plan's G-Set bool[64] and G-Counter int32[16] rows
    (512, 16, 16, 32),   # a leaf of the engine's packed OR-Set (128 words)
    (128, 16, 16, 8),    # a packed (16, 2)-word leaf
    (5, 16, 1, 8),       # bool[5]
    (12, 16, 4, 4),      # int32[3]
    (24, 16, 8, 4),      # int32[6]
    (64, 8, 8, 8),       # members 8 bytes off a 16-byte boundary
    (64, 4, 4, 16),      # members 4 bytes off
    (64, 1, 1, 32),      # bool members 1 byte off
    (1000, 16, 8, 32),   # wider than a warp's vectors: the team walks the row
    (1200, 16, 16, 32),
    (4, 16, 4, 1),
    (1, 16, 1, 1),
])
def test_rows_schedule_at_the_main_path_and_odd_shapes(row_bytes, aligned, vec, team):
    assert cg.rows_schedule(row_bytes, aligned) == (vec, team)


@pytest.mark.parametrize("row_bytes", [1, 3, 4, 5, 12, 24, 48, 64, 100, 128, 500,
                                       512, 513, 1000, 1024, 1200, 4096])
@pytest.mark.parametrize("aligned", [1, 2, 4, 8, 16])
def test_rows_schedule_vectors_divide_rows_and_addresses(row_bytes, aligned):
    """Every row of every member and output starts on a vector (the vector
    divides the row and every address), 16 bytes only where every address
    allows it; the team is a power of two of at most 32 lanes whose vectors
    cover a row, or a whole warp that walks a wider row."""
    vec, team = cg.rows_schedule(row_bytes, aligned)
    assert vec in (16, 8, 4, 1)
    assert row_bytes % vec == 0 and aligned % vec == 0
    assert vec == 16 or aligned < 16 or row_bytes % 16 != 0
    assert team & (team - 1) == 0 and 1 <= team <= 32
    assert team * vec >= row_bytes or team == 32
    assert team == 1 or (team // 2) * vec < row_bytes  # no idle half-team


def test_rows_schedule_keeps_int32_rows_on_whole_lanes():
    """int32 rows (4-byte multiples, 4-byte aligned) never take the byte
    path, so ``max`` folds whole int32 lanes."""
    for words in range(1, 70):
        for aligned in (4, 8, 16):
            assert cg.rows_schedule(4 * words, aligned).vec_bytes >= 4


def test_address_alignment_reads_every_tensor():
    aligned = torch.zeros((4, 16), dtype=torch.int32)
    assert cg.address_alignment(aligned) == 16
    assert cg.address_alignment(aligned, _offset_view((4, 16), 2)) == 8
    assert cg.address_alignment(_offset_view((4, 16), 1), aligned) == 4
    flags = torch.zeros(65, dtype=torch.bool)
    assert cg.address_alignment(aligned, flags[1:]) == 1
    assert cg.address_alignment(aligned, flags[2:]) == 2


@pytest.mark.parametrize("path", list(rp.K2_PATHS))
def test_card_parity_paths_take_the_schedule_they_name(path):
    """Each path of the on-card K2 parity table is what ``rows_schedule``
    gives its rows at 16-byte-aligned addresses."""
    _dtype, _op, _row, _n, vec, team = rp.K2_PATHS[path]
    assert cg.rows_schedule(rp.row_bytes(path), 16) == (vec, team)


def test_card_parity_paths_cover_every_vector_and_team_width():
    """The table with its four kinds of member (stacked, views, clones,
    misaligned copies) reaches every vector width and every team width of
    the kernel, so the card's parity checks walk every path."""
    taken = set()
    for path in rp.K2_PATHS:
        for kind in rp.MEMBER_KINDS:
            leaves = [rp.k2_members(x, kind) for x in rp.k2_leaves(
                path, 2, 3, torch.Generator().manual_seed(0))]
            members = [m for leaf in leaves for m in cg._members(leaf)]
            taken.add(cg.rows_schedule(rp.row_bytes(path),
                                       cg.address_alignment(*members)))
    assert {v for v, _t in taken} == {16, 8, 4, 1}
    assert {t for _v, t in taken} == {1, 2, 4, 8, 16, 32}


def test_rows_wrapper_refuses_a_join_it_has_no_kernel_for():
    nb = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    rows = torch.zeros((1, 2), dtype=torch.int64)
    for dtype, op in ((torch.bool, "max"), (torch.int64, "or"), (torch.int32, "and")):
        leaf = torch.zeros((1, 4, 16), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="no kernel for"):
            cg.gossip_round_rows(op, [leaf], nb, rows)


def test_rows_bound_counts_the_row_index_dtype_and_byte_flags():
    """``chip_smoke.py``'s bound for K2 / K3 reads each slot's row index in
    its own dtype (8 bytes for the runtime's int64) and writes a 1-byte
    changed flag."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    nbrs = np.array([[1], [2], [0]], dtype=np.int32)
    rows = np.array([[0, 1]], dtype=np.int64)
    b64, g64 = chip_smoke._rows_bound_bytes(rows, nbrs, 16, 1)
    b32, g32 = chip_smoke._rows_bound_bytes(rows.astype(np.int32), nbrs, 16, 1)
    # 3 distinct rows read, 2 written, 2 row indices, 2 neighbour indices, 2 flags
    assert b64 == 3 * 16 + 2 * 16 + 2 * 8 + 2 * 4 + 2
    assert b64 - b32 == g64 - g32 == 2 * 4
    assert g64 == 3 * 2 * 16 + 2 * (8 + 4 + 1)


def test_rows_wrapper_refuses_tensors_off_the_cpu_and_cuda():
    leaf = torch.zeros((1, 4, 16), dtype=torch.bool, device="meta")
    nb = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cg.gossip_round_rows("or", [leaf], nb, torch.zeros((1, 2), dtype=torch.int64))


def test_row_wrappers_refuse_a_mask_that_is_not_bool():
    """The kernels read the mask's bytes as they are, so K2 and K3 take
    only a bool mask of the table's shape."""
    nb = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    rows = torch.zeros((1, 2), dtype=torch.int64)
    leaf = torch.zeros((1, 4, 16), dtype=torch.bool, device="meta")
    clock = torch.zeros((1, 4, 16), dtype=torch.int32, device="meta")
    dots = torch.zeros((1, 4, 8, 16), dtype=torch.int32, device="meta")
    for mask in (torch.ones((4, 2), dtype=torch.uint8, device="meta"),
                 torch.ones((4, 3), dtype=torch.bool, device="meta")):
        with pytest.raises(ValueError, match="edge_mask must be bool"):
            cg.gossip_round_rows("or", [leaf], nb, rows, mask)
        with pytest.raises(ValueError, match="edge_mask must be bool"):
            cg.gossip_round_rows_vclock(clock, dots, nb, rows, mask)


# -- K3: the ring's copy path and chunks -----------------------------------------


def test_vclock_schedule_takes_bulk_copies_only_for_16_byte_rows():
    plan_shape = cg.vclock_schedule(16, 64, 3, aligned=True)
    assert plan_shape == cg.VclockSchedule(bulk=True, chunk_words=1024)
    assert not cg.vclock_schedule(3, 8, 3, aligned=True).bulk
    assert not cg.vclock_schedule(6, 2, 3, aligned=True).bulk
    assert not cg.vclock_schedule(16, 64, 3, aligned=False).bulk


@pytest.mark.parametrize("a,e,k", [(64, 512, 3), (64, 512, 8), (16, 64, 8),
                                   (3, 2000, 1), (16, 64, 31)])
def test_vclock_schedule_chunks_rows_wider_than_a_stage(a, e, k):
    s = cg.vclock_schedule(a, e, k, aligned=True)
    row = e * a
    clock_stride = -(-a // 4) * 4
    dots_stride = -(-s.chunk_words // 4) * 4
    assert (k + 1) * (clock_stride + dots_stride) * 4 <= cg.VCLOCK_STAGE_BYTES
    if s.chunk_words < row:
        assert s.chunk_words % 4 == 0
        # the chunks the kernel walks cover the row once
        starts = range(0, row, s.chunk_words)
        assert sum(min(s.chunk_words, row - c) for c in starts) == row
    else:
        assert s.chunk_words == row


def test_vclock_schedule_refuses_clocks_that_fill_a_stage():
    with pytest.raises(ValueError, match="no room"):
        cg.vclock_schedule(2048, 1, 3, aligned=True)


def test_vclock_launch_schedule_reads_members_and_refuses_bad_ones():
    r, e, a = 10, 8, 16
    clocks = [torch.zeros((r, a), dtype=torch.int32) for _ in range(2)]
    dots = [torch.zeros((r, e, a), dtype=torch.int32) for _ in range(2)]
    assert cg.vclock_launch_schedule(clocks, dots, 3).bulk
    shifted = [clocks[0], _offset_view((r, a), 1)]
    assert not cg.vclock_launch_schedule(shifted, dots, 3).bulk
    odd = ([torch.zeros((r, 3), dtype=torch.int32)],
           [torch.zeros((r, e, 3), dtype=torch.int32)])
    assert not cg.vclock_launch_schedule(*odd, 3).bulk
    with pytest.raises(ValueError, match="int32"):
        cg.vclock_launch_schedule([c.long() for c in clocks], dots, 3)
    with pytest.raises(ValueError, match="int32"):
        cg.vclock_launch_schedule(clocks, [torch.zeros((r, e, a + 1), dtype=torch.int32)], 3)


def test_vclock_wrapper_refuses_tensors_off_the_cpu_and_cuda():
    clock = torch.zeros((1, 4, 16), dtype=torch.int32, device="meta")
    dots = torch.zeros((1, 4, 8, 16), dtype=torch.int32, device="meta")
    nb = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cg.gossip_round_rows_vclock(clock, dots, nb, torch.zeros((1, 2), dtype=torch.int32))


# -- the launch log -----------------------------------------------------------------


def test_launch_log_counts_each_shape_and_resets():
    cg.reset_launches()
    key = (4, 8, 2, 8, 4)
    cg._check_launch("gossip_round_dense", 0, key)
    cg._check_launch("gossip_round_dense", 0, key)
    assert cg.LAUNCHES["gossip_round_dense"] == 2
    assert cg.SHAPES["gossip_round_dense"] == {key: 2}
    assert len(key) == len(cg.SHAPE_FIELDS["gossip_round_dense"])
    with pytest.raises(RuntimeError, match="cudaError 1"):
        cg._check_launch("gossip_round_dense", 1, key)
    assert cg.LAUNCHES["gossip_round_dense"] == 2  # a failed launch counts nothing
    cg.reset_launches()
    assert cg.LAUNCHES["gossip_round_dense"] == 0
    assert not any(cg.SHAPES.values())
    assert set(cg.SHAPE_FIELDS) == set(cg.LAUNCHES) == set(cg.SHAPES)
