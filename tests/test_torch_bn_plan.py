"""The launch plan of the BN-statistics kernels (``ops/bn.py:bn_launch_plan``),
checked on the CPU at an H100's 132 SMs: the plan is what ``bn_stats.cu``
launches, so its coverage, its scratch and its grid are facts about the
kernel that need no card.

The shapes are the BatchNorm inputs at batch 64 of the flagship
``voc_full_config()`` (25), of MobileNetV2 (``test_model_config()``, 52) and
the GAP dense head's 2-D one (1): the 78 that ``chip_smoke.phase_bn`` times,
written out here rather than built; then ``chip_smoke.BN_ODD_SHAPES`` and
one-row shapes. Each is planned for bf16 and f32, with aligned and with
unaligned pointers (the V = 1 path).
"""

import math

import numpy as np
import pytest

from chip_smoke import BN_ODD_SHAPES
from keras_object_detection_torch.ops.bn import (BN_BLOCKS_PER_SM, BN_THREADS,
                                                 bn_launch_plan)

SMS = 132  # H100 SXM

FLAGSHIP = [(64, 64, 224, 224), (64, 192, 112, 112), (64, 128, 56, 56),
            (64, 256, 56, 56), (64, 256, 56, 56), (64, 512, 56, 56),
            (64, 256, 28, 28), (64, 512, 28, 28), (64, 256, 28, 28),
            (64, 512, 28, 28), (64, 256, 28, 28), (64, 512, 28, 28),
            (64, 256, 28, 28), (64, 512, 28, 28), (64, 512, 28, 28),
            (64, 1024, 28, 28), (64, 512, 14, 14), (64, 1024, 14, 14),
            (64, 512, 14, 14), (64, 1024, 14, 14), (64, 1024, 14, 14),
            (64, 1024, 7, 7), (64, 1024, 7, 7), (64, 1024, 7, 7),
            (64, 1024, 7, 7)]
MOBILENETV2 = [(64, 32, 224, 224), (64, 32, 224, 224), (64, 16, 224, 224),
               (64, 96, 224, 224), (64, 96, 112, 112), (64, 24, 112, 112),
               (64, 144, 112, 112), (64, 144, 112, 112), (64, 24, 112, 112),
               (64, 144, 112, 112), (64, 144, 56, 56), (64, 32, 56, 56),
               (64, 192, 56, 56), (64, 192, 56, 56), (64, 32, 56, 56),
               (64, 192, 56, 56), (64, 192, 56, 56), (64, 32, 56, 56),
               (64, 192, 56, 56), (64, 192, 28, 28), (64, 64, 28, 28),
               (64, 384, 28, 28), (64, 384, 28, 28), (64, 64, 28, 28),
               (64, 384, 28, 28), (64, 384, 28, 28), (64, 64, 28, 28),
               (64, 384, 28, 28), (64, 384, 28, 28), (64, 64, 28, 28),
               (64, 384, 28, 28), (64, 384, 28, 28), (64, 96, 28, 28),
               (64, 576, 28, 28), (64, 576, 28, 28), (64, 96, 28, 28),
               (64, 576, 28, 28), (64, 576, 28, 28), (64, 96, 28, 28),
               (64, 576, 28, 28), (64, 576, 14, 14), (64, 160, 14, 14),
               (64, 960, 14, 14), (64, 960, 14, 14), (64, 160, 14, 14),
               (64, 960, 14, 14), (64, 960, 14, 14), (64, 160, 14, 14),
               (64, 960, 14, 14), (64, 960, 14, 14), (64, 320, 14, 14),
               (64, 1280, 14, 14)]
GAP_DENSE_2D = [(64, 4960)]
ONE_ROW = [(1, 1), (1, 7), (1, 64), (1, 4960), (1, 1024, 1, 1)]

CASES = ([pytest.param(s, id=f"flagship{i}-{s}") for i, s in enumerate(FLAGSHIP)]
         + [pytest.param(s, id=f"mobilenetv2_{i}-{s}")
            for i, s in enumerate(MOBILENETV2)]
         + [pytest.param(s, id=f"gap2d-{s}") for s in GAP_DENSE_2D]
         + [pytest.param(s, id=f"odd-{s}") for s in BN_ODD_SHAPES]
         + [pytest.param(s, id=f"one_row-{s}") for s in ONE_ROW])
PLANS = [(2, True), (2, False), (4, True), (4, False)]  # itemsize, aligned


def rows_of(shape):
    return math.prod(shape) // shape[1], shape[1]


def visited_rows(plan, m: int, loads: int) -> np.ndarray:
    """How often each of the m rows is read by one tile's threadIdx.x, by
    the kernel's loop: block row range [r0, r1), thread ty reads r0 + ty +
    i * loads * ty_count + u * ty_count for u < loads, while below r1."""
    _, ty = plan.block
    rows = plan.rows_per_block
    trips = -(-rows // (loads * ty))
    t = np.arange(ty)[:, None, None]
    i = np.arange(trips)[None, :, None]
    u = np.arange(loads)[None, None, :]
    offsets = (t + i * loads * ty + u * ty).ravel()
    read = []
    for by in range(plan.grid[1]):
        r0 = by * rows
        r = r0 + offsets
        read.append(r[r < min(m, r0 + rows)])
    return np.bincount(np.concatenate(read), minlength=m)


def visited_channels(plan, c: int) -> np.ndarray:
    """How often each channel is read: tile * tx * v + x * v + j, j < v, for
    threads whose first channel is below c."""
    tx, _ = plan.block
    v = plan.v
    counts = np.zeros(c, np.int64)
    for tile in range(plan.grid[0]):
        for x in range(tx):
            ch0 = tile * tx * v + x * v
            if ch0 < c:
                counts[ch0:ch0 + v] += 1
    return counts


@pytest.mark.parametrize("shape", CASES)
def test_plan_reads_every_row_and_channel_exactly_once(shape):
    m, c = rows_of(shape)
    for itemsize, aligned in PLANS:
        plan = bn_launch_plan(m, c, itemsize, SMS, aligned)
        vec = 16 // itemsize
        assert plan.v == (vec if aligned and c % vec == 0 else 1)
        tx, ty = plan.block
        assert 1 <= tx * ty <= BN_THREADS
        groups = c // plan.v
        if 32 % tx == 0:  # whole warps over whole rows of a tile
            assert tx * ty % 32 == 0
            assert tx * plan.v * itemsize <= 128  # a tile is one cache line at most
        else:  # a whole row a tile, where 128-byte tiles would share 64-byte pieces
            assert tx == groups <= 32 and c * itemsize % 64
        assert np.all(visited_channels(plan, c) == 1)
        for loads in (4, 8):  # K3's rows in flight, K2's
            assert np.all(visited_rows(plan, m, loads) == 1)


@pytest.mark.parametrize("shape", CASES)
def test_plan_scratch_is_what_the_kernel_writes(shape):
    """Where gy > 1 each block writes its partial row, the tile's two sums
    at k * tx * v + x * v + j and zeros up to the float4-padded stride, at
    (tile * gy + row block) * stride; the scratch holds exactly those
    floats, each written once. Where gy == 1 there is no scratch and no
    counter. A tile's counter index stays under the 2 * SMs the wrapper
    allocates."""
    m, c = rows_of(shape)
    for itemsize, aligned in PLANS:
        plan = bn_launch_plan(m, c, itemsize, SMS, aligned)
        (tx, _), (gx, gy), v = plan.block, plan.grid, plan.v
        tch = tx * v
        assert plan.stride == -(-2 * tch // 4) * 4
        if gy == 1:
            assert plan.scratch_floats == 0
            assert plan.rows_per_block >= m
            continue
        row = np.zeros(plan.stride, np.int64)
        for k in range(2):
            for x in range(tx):
                row[k * tch + x * v:k * tch + x * v + v] += 1
        row[2 * tch:] += 1  # the padding thread (0, 0) writes
        assert np.all(row == 1)
        written = gx * gy * plan.stride  # rows (tile * gy + by) for all blocks
        assert plan.scratch_floats == written
        assert gx < BN_BLOCKS_PER_SM * SMS  # tile i draws from counter i


@pytest.mark.parametrize("shape", CASES)
def test_plan_fills_the_card(shape):
    """At least 2 blocks per SM (264) wherever the shape holds 264 * 256
    row segments of v channels, one for each thread of 264 full blocks:
    every model shape but the 2-D (64, 4960) one in bf16. A plan of one row
    block is one whose tiles alone fill the card, or one that cannot fill
    it and reads every row in one round of loads (at most 4 a thread)."""
    m, c = rows_of(shape)
    for itemsize, aligned in PLANS:
        plan = bn_launch_plan(m, c, itemsize, SMS, aligned)
        (gx, gy), (_, ty) = plan.grid, plan.block
        enough = m * c // plan.v >= BN_BLOCKS_PER_SM * SMS * BN_THREADS
        if enough:
            assert gx * gy >= BN_BLOCKS_PER_SM * SMS
        if gy == 1:
            assert gx >= BN_BLOCKS_PER_SM * SMS or (not enough and m <= 4 * ty)


def test_every_model_shape_but_the_2d_one_fills_the_card():
    """The fill rule binds at every model shape but one: all 77 NCHW ones
    hold enough row segments, in bf16 and f32; the 2-D one does not, and
    its plan has no partials (one block covers its 64 rows)."""
    for shape in FLAGSHIP + MOBILENETV2:
        m, c = rows_of(shape)
        for itemsize in (2, 4):
            plan = bn_launch_plan(m, c, itemsize, SMS)
            assert m * c // plan.v >= BN_BLOCKS_PER_SM * SMS * BN_THREADS
            assert plan.grid[0] * plan.grid[1] >= BN_BLOCKS_PER_SM * SMS
    plan = bn_launch_plan(64, 4960, 2, SMS)
    assert plan.grid[1] == 1 and plan.scratch_floats == 0
