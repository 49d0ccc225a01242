"""Which body of the port's TV-L1 inner loop runs at which size
(frame2frame_tpu_torch/flow/tvl1_inner.py ``cluster_plan``), and the layout
it gives the cluster body.

The plan is a function of the level's shape alone: ``(blocks,
tiles_per_block, smem_bytes)`` for the cluster body, ``None`` for the
cooperative one. Here, on the CPU, it is held to what the kernel
(csrc/tvl1_inner.cu) needs: at most 16 blocks of at most 9 tiles, a
block's shared memory within the card's 227 KB, whole 8 x 32 tiles in
raster order, every tile and every pixel of the level owned by exactly one
block. Levels of up to 144 tiles take the cluster body (one block up to 4
tiles), larger ones the cooperative body: every solved level of a 540p flow
with the denoising parameters takes the cluster body; 270 x 480 of a 1080p
flow and the flow CLI's default 540 x 960 level take the cooperative one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu_torch.flow import tvl1_inner as ti  # noqa: E402
from frame2frame_tpu_torch.flow.tvl1 import DENOISING_PARAMS  # noqa: E402
from frame2frame_tpu_torch.ops.pyramid import (  # noqa: E402
    num_scales, pyramid_shapes)

SMEM_227KB = 232448  # bytes of shared memory an H100 block may take


def solved_levels(nx, ny, params=DENOISING_PARAMS):
    """(ny, nx) of every level the solver runs the inner loop on."""
    n = num_scales(nx, ny, params["nscales"], params["zfactor"])
    fscale = min(params["fscale"], n)
    return [(h, w) for s, (w, h) in enumerate(
        pyramid_shapes(nx, ny, n, params["zfactor"])) if s >= fscale]


LEVELS_540P = solved_levels(960, 540)
LEVELS_1080P = solved_levels(1920, 1080)


def test_solved_levels():
    """The levels the plan is held at: five of a 540p flow (25 launches
    with five warps each), six of a 1080p flow."""
    assert LEVELS_540P == [(135, 240), (68, 120), (34, 60), (17, 30), (9, 15)]
    assert LEVELS_1080P == [(270, 480)] + LEVELS_540P


def coverage(ny, nx, plan):
    """How many blocks own each pixel of the level under ``plan``."""
    blocks, per, _ = plan
    tx = -(-nx // ti.TILE_W)
    owned = np.zeros((-(-ny // ti.TILE_H) * ti.TILE_H, tx * ti.TILE_W), int)
    for b in range(blocks):
        for t in range(b * per, (b + 1) * per):
            y, x = divmod(t, tx)
            if y * ti.TILE_H < ny:
                owned[y * ti.TILE_H:(y + 1) * ti.TILE_H,
                      x * ti.TILE_W:(x + 1) * ti.TILE_W] += 1
    return owned[:ny, :nx]


@pytest.mark.parametrize("ny,nx", sorted(set(LEVELS_540P + LEVELS_1080P)))
def test_plan_of_every_solved_level(ny, nx):
    plan = ti.cluster_plan(ny, nx)
    tiles = -(-ny // ti.TILE_H) * -(-nx // ti.TILE_W)
    if tiles > ti.MAX_CLUSTER * ti.MAX_TILES_PER_BLOCK:
        assert plan is None, f"{ny}x{nx} ({tiles} tiles) takes the cluster body"
        return
    assert plan is not None, f"{ny}x{nx} takes the cooperative body"
    blocks, per, smem = plan
    assert 1 <= blocks <= ti.MAX_CLUSTER
    assert 1 <= per <= ti.MAX_TILES_PER_BLOCK
    # the tiles [b * per, (b + 1) * per) of the blocks cover the level, and
    # no block is left without a tile
    assert blocks * per >= tiles > (blocks - 1) * per
    assert smem == ti.cluster_smem(blocks, per) <= SMEM_227KB
    owned = coverage(ny, nx, plan)
    assert owned.min() == owned.max() == 1


def test_bodies_of_a_flow():
    """The cluster body for every solved level of a 540p flow, and for all
    of a 1080p flow's but 270 x 480."""
    assert all(ti.cluster_plan(*level) is not None for level in LEVELS_540P)
    assert [ti.cluster_plan(*level) is None for level in LEVELS_1080P] == [
        True] + [False] * len(LEVELS_540P)


@pytest.mark.parametrize("ny,nx,want", [
    (540, 960, None),       # the flow CLI's default fscale=0 at 540p
    (1080, 1920, None),
    (270, 480, None),       # 510 tiles
    (135, 240, (16, 9)),    # 136 tiles: at most 9 a block on 16 blocks
    (1, 1, (1, 1)), (2, 3, (1, 1)), (13, 21, (1, 2)),
    (9, 15, (1, 2)),        # up to 4 tiles: one block, nothing exchanged
    (17, 30, (1, 3)),
    (34, 60, (10, 1)),      # 10 tiles: 16 blocks would take one each
    (68, 120, (12, 3)),     # 36 tiles: at most 3 a block on 16 blocks
])
def test_plan_at_edge_sizes(ny, nx, want):
    plan = ti.cluster_plan(ny, nx)
    if want is None:
        assert plan is None
    else:
        assert plan[:2] == want
        assert coverage(ny, nx, plan).min() == 1


def test_plan_is_the_largest_level_that_fits():
    """The cluster body takes a level up to 9 tiles a block on 16 blocks:
    144 tiles; one tile row more goes to the cooperative body."""
    assert ti.cluster_plan(8 * 18, 32 * 8) == (16, 9, ti.cluster_smem(16, 9))
    assert ti.cluster_plan(8 * 19, 32 * 8) is None


@pytest.mark.parametrize("per", range(1, ti.MAX_TILES_PER_BLOCK + 1))
def test_threads_of_a_block(per):
    """A block's threads take all its tiles at one to three pixels a
    thread, in whole tiles' groups of 256 threads, at most 1024."""
    threads = ti.cluster_threads(per)
    groups, px = threads // 256, -(-per // 4)
    assert threads % 256 == 0 and threads <= 1024 and px <= 3
    assert groups * px >= per > (groups - 1) * px
