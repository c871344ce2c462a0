"""The W8A16 GEMM's wgmma body (``csrc/w8a16_gemm.cu``, ``w8a16_wide_kernel``)
on the CPU: a numpy emulator of how its consumer warps turn the staged
int8 tile into wgmma A fragments, and of how its epilogue puts the
accumulators back in feature order; and the row-tile and split choice of
the wrapper (``w8a16.wide_plan``).  No jax, no card: a few seconds.

The emulator follows the kernel's own formulas: TMA's 128-byte swizzle of
q's [64 x 128] tile, each lane's ``ldmatrix.x4.trans`` row address
(``a_off``), the byte-pair transpose, ``s8x4_to_bf16``'s even/odd split,
wgmma's register layouts for A and D, and the epilogue's feature index.
"""

import math

import numpy as np
import pytest

from production_stack_tpu_torch.engine.ops.kernels import w8a16
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BK, BN = w8a16.WIDE_BK, w8a16.WIDE_BN


def swizzle128(tile: np.ndarray) -> np.ndarray:
    """A [rows, 128]-byte tile as TMA writes it under the 128-byte swizzle:
    16-byte chunk j of row r lands at chunk j ^ (r % 8)."""
    rows, width = tile.shape
    assert width == 128
    out = np.empty(rows * 128, np.uint8)
    for r in range(rows):
        for j in range(8):
            dst = r * 128 + ((j ^ (r % 8)) << 4)
            out[dst:dst + 16] = tile[r, 16 * j:16 * j + 16]
    return out


def ldmatrix_x4_trans(smem: np.ndarray, addrs) -> np.ndarray:
    """``ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: lanes 8i .. 8i + 7
    give the 16-byte rows of matrix i; lane (g, c) receives, in register
    i, b16 elements [2c][g] (low half) and [2c + 1][g] of matrix i.
    Returns [32 lanes, 4 registers, 4 bytes], low byte first."""
    regs = np.empty((32, 4, 4), np.uint8)
    for i in range(4):
        rows = [smem[addrs[8 * i + j]:addrs[8 * i + j] + 16] for j in range(8)]
        for lane in range(32):
            g, c = lane // 4, lane % 4
            regs[lane, i, 0:2] = rows[2 * c][2 * g:2 * g + 2]
            regs[lane, i, 2:4] = rows[2 * c + 1][2 * g:2 * g + 2]
    return regs


def s8x4_to_bf16(word: np.ndarray):
    """The kernel's convert of one register: bytes 0 and 2 are the even
    pair, bytes 1 and 3 the odd one (low half first); exact in bf16."""
    b = word.view(np.int8).astype(np.float32)
    return (b[0], b[2]), (b[1], b[3])


def a_fragments(smem: np.ndarray, cw: int, warp: int, lane: int, kk: int):
    """The four A registers (pairs of values) lane ``lane`` of consumer
    warp ``warp`` in warpgroup ``cw`` hands wgmma at 16-deep step kk, from
    the swizzled q tile ``smem`` (the kernel's ``a_off`` and loop)."""
    p, h = divmod(kk, 2)
    addrs = [p * 32 * BN + ln * BN + (((cw * 4 + warp) ^ (ln % 8)) << 4) for ln in range(32)]
    r = ldmatrix_x4_trans(smem, addrs)[lane]
    e0, o0 = s8x4_to_bf16(r[2 * h])
    e1, o1 = s8x4_to_bf16(r[2 * h + 1])
    return e0, o0, e1, o1


def rebuild_a(q_tile: np.ndarray) -> np.ndarray:
    """Each consumer warpgroup's 64 x 64 A operand ([row, k]) as wgmma
    reads it from the lanes' registers (A fragment layout: lane (g, c) of
    warp w holds rows 16w + g (a0, a2) and 16w + g + 8 (a1, a3), columns
    2c, 2c + 1 and 2c + 8, 2c + 9), for warpgroups 0 and 1."""
    smem = swizzle128(q_tile)
    A = np.full((2, 64, BK), np.nan, np.float32)
    for cw in range(2):
        for warp in range(4):
            for lane in range(32):
                g, c = lane // 4, lane % 4
                for kk in range(BK // 16):
                    a0, a1, a2, a3 = a_fragments(smem, cw, warp, lane, kk)
                    k = 16 * kk + 2 * c
                    A[cw, 16 * warp + g, k:k + 2] = a0
                    A[cw, 16 * warp + g + 8, k:k + 2] = a1
                    A[cw, 16 * warp + g, k + 8:k + 10] = a2
                    A[cw, 16 * warp + g + 8, k + 8:k + 10] = a3
    return A


def feature_of_row(cw: int, row: int) -> int:
    """The permutation: row r < 8 of warp w's 16 holds feature 16w + 2r,
    row 8 + r feature 16w + 2r + 1 (within warpgroup cw's 64)."""
    w, r = divmod(row, 16)
    return 64 * cw + 16 * w + (2 * r if r < 8 else 2 * (r - 8) + 1)


@pytest.fixture(scope="module")
def q_tile():
    rng = np.random.default_rng(0)
    return rng.integers(-128, 128, (BK, BN)).astype(np.int8).view(np.uint8)


def test_a_fragments_rebuild_the_transposed_tile_exactly(q_tile):
    """The registers of every lane, read back through wgmma's A layout and
    un-permuted, are q^T of the staged [64, 128] tile, value for value."""
    A = rebuild_a(q_tile)
    assert not np.isnan(A).any()  # every (row, k) is written once
    qT = np.empty((BN, BK), np.float32)
    for cw in range(2):
        for row in range(64):
            qT[feature_of_row(cw, row)] = A[cw, row]
    np.testing.assert_array_equal(qT, q_tile.view(np.int8).astype(np.float32).T)


def test_ldmatrix_rows_are_conflict_free(q_tile):
    """Under the swizzle the 8 row addresses of each matrix fall in 8
    different 16-byte bank groups (an unswizzled 128-byte-wide tile would
    put all 8 on one)."""
    for cw in range(2):
        for warp in range(4):
            for p in range(2):
                addrs = [p * 32 * BN + ln * BN + (((cw * 4 + warp) ^ (ln % 8)) << 4)
                         for ln in range(32)]
                for i in range(4):
                    groups = {(addrs[8 * i + j] % 128) // 16 for j in range(8)}
                    assert len(groups) == 8


@pytest.mark.parametrize("rows", [16, 176])
def test_epilogue_puts_each_sum_at_its_feature(q_tile, rows):
    """The transposed product D = A . x^T (wgmma's D layout: lane (g, c)
    holds d[4j .. 4j + 3] = rows g, g, g + 8, g + 8 at columns 8j + 2c,
    8j + 2c + 1), staged by the epilogue's formula (feature f = 64 cw + 16
    w + 2g for rows g and f + 1 for g + 8), is x . q of the tile."""
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, (rows, BK)).astype(np.float32)  # sums exact in fp32
    A = rebuild_a(q_tile)
    st = np.full((rows, BN), np.nan, np.float32)
    for cw in range(2):
        D = A[cw] @ x.T  # [64, rows]
        for warp in range(4):
            for lane in range(32):
                g, c = lane // 4, lane % 4
                f = cw * 64 + warp * 16 + 2 * g
                for j in range(rows // 8):
                    d = (D[16 * warp + g, 8 * j + 2 * c], D[16 * warp + g, 8 * j + 2 * c + 1],
                         D[16 * warp + g + 8, 8 * j + 2 * c],
                         D[16 * warp + g + 8, 8 * j + 2 * c + 1])
                    r = 8 * j + 2 * c
                    st[r, f:f + 2] = d[0], d[2]
                    st[r + 1, f:f + 2] = d[1], d[3]
    want = x @ q_tile.view(np.int8).astype(np.float32)
    np.testing.assert_array_equal(st, want)


def test_convert_is_exact_for_every_byte():
    """``s8x4_to_bf16`` (the fp32 magic-number path of ``unpack_word_s8``,
    then the high half) gives every int8 value exactly: emulated in fp32
    bit operations, as the kernel does them."""
    vals = np.arange(-128, 128).astype(np.int8)
    words = vals.view(np.uint8).reshape(-1, 4)
    got = []
    for w in words:
        u = int.from_bytes(bytes(w), "little") ^ 0x80808080
        for i in range(4):
            bits = np.uint32(0x4B000000 | ((u >> (8 * i)) & 0xFF))
            f = np.float32(bits.view(np.float32) - np.float32(8388736.0))
            hi = np.uint32(f.view(np.uint32)) & np.uint32(0xFFFF0000)  # the bf16 half
            got.append(float(hi.view(np.float32)))
    assert got == [float(v) for v in vals]


SHAPES = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
          "down": (14336, 4096), "lm_head": (4096, 128256), "ragged": (4104, 1040)}
# Clusters of 1 .. 8 blocks of the wgmma body an NVIDIA H100 80GB HBM3 holds
# at once (cudaOccupancyMaxActiveClusters, as w8a16_ab.py plan prints it):
# a cluster's blocks share one GPC of 14-18 SMs.
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


EVEN_CLUSTERS = tuple(132 // s for s in range(1, 9))  # clusters placed freely


def test_wide_plan_row_tiles_cover_every_m():
    """From 1 to 16384 rows: the fewest row tiles of at most WIDE_MAX_ROWS
    rows, each a multiple of WIDE_ROW_STEP (wgmma's N: 8 | N <= 256) and
    one of the widths the kernel is built for, none of them empty."""
    for M in range(1, 16385):
        for K, N in (SHAPES["q_o"], SHAPES["k_v"]):
            rows, _ = w8a16.wide_plan(M, N, K, H100_CLUSTERS)
            assert rows % w8a16.WIDE_ROW_STEP == 0 and rows % 8 == 0
            assert w8a16.WIDE_MIN_ROWS <= rows <= w8a16.WIDE_MAX_ROWS <= 256
            m_tiles = math.ceil(M / rows)
            assert m_tiles == math.ceil(M / w8a16.WIDE_MAX_ROWS)
            assert (m_tiles - 1) * rows < M <= m_tiles * rows
    K, N = SHAPES["gate_up"]
    assert w8a16.wide_plan(520, N, K, H100_CLUSTERS) == (176, 1)  # 3 x 176, not 5 x 128


@pytest.mark.parametrize("clusters", [EVEN_CLUSTERS, H100_CLUSTERS])
def test_wide_plan_splits_keep_their_depth(clusters):
    """Every split walks at least WIDE_SPLIT_MIN tiles of K (512 of K),
    none is empty; a split call is clusters of at most WIDE_MAX_SPLITS
    blocks (the portable cluster size, the kernel's bound), as many as
    the card holds in one wave; calls with as many tiles as SMs are not
    split."""
    assert w8a16.WIDE_SPLIT_MIN * w8a16.WIDE_BK == 512
    assert w8a16.WIDE_MAX_SPLITS <= 8
    for K, N in SHAPES.values():
        k_tiles = math.ceil(K / w8a16.WIDE_BK)
        for M in list(range(1, 1100, 7)) + [2048, 4096, 16384]:
            rows, splits = w8a16.wide_plan(M, N, K, clusters)
            tiles = math.ceil(M / rows) * math.ceil(N / w8a16.WIDE_BN)
            per = math.ceil(k_tiles / splits)
            assert 1 <= splits <= w8a16.WIDE_MAX_SPLITS
            assert splits == 1 or per >= w8a16.WIDE_SPLIT_MIN
            assert (splits - 1) * per < k_tiles
            if tiles >= clusters[0]:
                assert splits == 1
            assert splits == 1 or tiles <= clusters[splits - 1]


@pytest.mark.parametrize("proj", ["q_o", "k_v"])
def test_wide_plan_fills_the_card_at_a_mixed_iteration(proj):
    """At 520 rows (a mixed iteration) the short projections run in one
    wave of what an H100 holds: q/o as 3 x 176 rows (96 blocks), k/v as 3
    x 176 rows split 4 ways over K (24 clusters of 4 of the 30 it holds,
    96 blocks, where unsplit its 24 tiles would use 18% of the SMs)."""
    K, N = SHAPES[proj]
    rows, splits = w8a16.wide_plan(520, N, K, H100_CLUSTERS)
    tiles = math.ceil(520 / rows) * math.ceil(N / w8a16.WIDE_BN)
    assert tiles <= H100_CLUSTERS[splits - 1]  # one wave of clusters
    assert 96 <= tiles * splits <= 132


def test_wide_plan_takes_the_sweeps_choices():
    """The plans at the main path's calls (a token step's 8 rows, a mixed
    iteration's 520, a prompt's 2048) on an H100's clusters: those that an
    H100 ran fastest, or within 3%, of every row tiling and split it timed
    (``w8a16_ab.py plan``)."""
    want = {8: {"q_o": (32, 3), "k_v": (32, 8), "gate_up": (32, 1), "down": (32, 3),
                "lm_head": (32, 1)},
            520: {"q_o": (176, 1), "k_v": (176, 4), "gate_up": (176, 1), "down": (176, 1),
                  "lm_head": (176, 1)},
            2048: {"q_o": (256, 1), "k_v": (256, 2), "gate_up": (256, 1), "down": (256, 1),
                   "lm_head": (256, 1)}}
    for M, plans in want.items():
        for proj, plan in plans.items():
            K, N = SHAPES[proj]
            assert w8a16.wide_plan(M, N, K, H100_CLUSTERS) == plan, (M, proj)
