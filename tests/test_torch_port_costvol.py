"""Launch configurations of the cost-volume kernels (masked feature warp,
normalised correlation) and the profiler keys of ``chip_smoke.py``.

The kernels run only on the card; these tests check, on the CPU, the pure
Python that decides their grids and staging routes, and that every
profiler key names a kernel of ``csrc/``.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as pcn
from upflow_pytorch_tpu_torch.ops.kernels import correlation as pkc
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as pfw

CSRC = (Path(__file__).resolve().parents[1] / "upflow_pytorch_tpu_torch"
        / "csrc")
SGU_CHANNELS = 32  # the SGU warps the 32-channel 1x1 features


def _level_shapes():
    """(b, c, h, w) of every feature warp and normalised correlation of a
    forward at B=4 384x1280 and B=1 375x1242: decode levels 1-4 at the
    pyramid's channels, and the SGU's 32-channel warps."""
    out = []
    for b, hw in ((4, (384, 1280)), (1, (375, 1242))):
        for level, (h, w) in enumerate(chip_smoke.pyramid_hw(*hw)):
            if level:
                out.append((b, chip_smoke.PYRAMID_CHS[level], h, w))
                out.append((b, SGU_CHANNELS, h, w))
    return out


LEVEL_SHAPES = _level_shapes()
CHANNELS = (1, 2, 3, 5, 7, 8, 9, 31, 32, 33, 64, 96, 100, 128, 196)


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=_ids)
def test_feature_warp_grid_fills_a_wave(shape):
    b, c, h, w = shape
    threads, pixel_blocks, groups, size = pfw.launch_config(b, c, h, w)
    assert threads in pfw.THREADS
    assert pixel_blocks * threads >= h * w > (pixel_blocks - 1) * threads
    assert b * pixel_blocks * groups >= pfw.SMS


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("hw", [(12, 40), (12, 39), (47, 156), (96, 320)])
def test_feature_warp_groups_cover_channels_once(c, hw):
    """Group g warps channels [g * size, min(c, (g + 1) * size)), as the
    kernel computes them: together [0, c), each channel once, no group
    empty; a group is a multiple of the kernel's unroll or smaller."""
    for b in (1, 4):
        _, _, groups, size = pfw.launch_config(b, c, *hw)
        ranges = [(g * size, min(c, (g + 1) * size)) for g in range(groups)]
        assert all(lo < hi for lo, hi in ranges)
        covered = [ch for lo, hi in ranges for ch in range(lo, hi)]
        assert covered == list(range(c))
        assert size <= pfw.UNROLL or size % pfw.UNROLL == 0


def test_feature_warp_one_group_where_pixels_fill_the_card():
    """At 96 x 320 (B=4) the pixels alone fill the target: one group of all
    channels, so the flow and the taps are read and computed once."""
    assert pfw.launch_config(4, 32, 96, 320)[2:] == (1, 32)


def _check_tile_grid(shape):
    b, c, h, w = shape
    rows, cols, splits, blocks = pcn.launch_config(b, c, h, w)
    assert (rows, cols) in pcn.TILES
    assert splits in pcn.SPLITS and splits <= c
    tiles_x, tiles_y = -(-w // cols), -(-h // rows)
    assert tiles_x * cols >= w and tiles_y * rows >= h
    assert blocks == b * tiles_x * tiles_y * splits
    assert blocks >= pcn.SMS


@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=_ids)
def test_corr_norm_grid_fills_a_wave(shape):
    _check_tile_grid(shape)


# decode level 0 (6 x 20 at both sizes), where the plain correlation runs
# on the main path; with if_use_cor_pytorch it runs at every level
LEVEL0_SHAPES = [(4, 196, 6, 20), (1, 196, 6, 20)]


@pytest.mark.parametrize("shape", LEVEL0_SHAPES + LEVEL_SHAPES[::2],
                         ids=_ids)
def test_correlation_grid_fills_a_wave(shape):
    """The plain correlation takes the normalised correlation's grid: every
    SM a block, at level 0 too, where one 32-column tile a row leaves 6
    tiles a batch item."""
    _check_tile_grid(shape)
    assert pkc.launch_config is pcn.launch_config


def test_correlation_configs_of_level0():
    """Level 0: 1-row tiles and 16 splits at B=4; at B=1 16-column tiles,
    the only grid that gives every SM a block there."""
    assert pkc.launch_config(4, 196, 6, 20) == (1, 32, 16, 384)
    assert pkc.launch_config(1, 196, 6, 20) == (1, 16, 16, 192)


def test_corr_norm_configs_of_the_main_path():
    """The 384 x 1280 pyramid (B=4): channel splits only where the tiles
    alone leave SMs idle, the tallest tile where they do not."""
    got = [pcn.launch_config(4, c, h, w)[:3]
           for c, (h, w) in zip(chip_smoke.PYRAMID_CHS[1:],
                                chip_smoke.pyramid_hw(384, 1280)[1:])]
    assert got == [(4, 32, 8), (4, 32, 2), (4, 32, 1), (8, 32, 1)]


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("splits", pcn.SPLITS)
def test_corr_norm_splits_cover_channels_once(c, splits):
    ranges = pcn.channel_ranges(c, splits)
    assert len(ranges) == splits
    covered = [ch for lo, hi in ranges for ch in range(lo, hi)]
    assert covered == list(range(c))


@pytest.mark.parametrize("w,itemsize,ptrs,route", [
    (40, 4, (512, 1024), "vec"), (320, 2, (512, 520), "vec"),
    (156, 4, (512, 512), "vec"), (156, 2, (8, 16), "vec"),
    (39, 4, (512, 512), "word"), (78, 2, (512, 512), "word"),
    (311, 4, (512, 512), "word"), (40, 4, (512, 1028), "word"),
    (40, 2, (512, 516), "word")])
def test_corr_norm_staging_route(w, itemsize, ptrs, route):
    """4-pixel copies only where a row is whole 4-pixel groups and every
    map sits on the copy's alignment (16 bytes fp32, 8 bf16); the ragged
    widths 39, 78 and 311 take 4-byte copies with an edge test per pixel."""
    assert pcn.staging_route(w, itemsize, *ptrs) == route


@pytest.mark.parametrize("shape", LEVEL_SHAPES[::2], ids=_ids)
def test_corr_norm_route_of_model_maps(shape):
    """Fresh contiguous maps: the vector route on the 384 x 1280 pyramid
    and at width 156, the word route at 375 x 1242's other widths."""
    import torch

    b, c, h, w = shape
    maps = [torch.empty((b, c, h, w), dtype=dt) for dt in
            (torch.float32, torch.bfloat16)]
    for t in maps:
        want = "vec" if w % 4 == 0 else "word"
        assert pcn.staging_route(w, t.element_size(), t.data_ptr(),
                                 t.data_ptr()) == want


def _global_functions():
    """Names of the ``__global__`` functions of ``csrc/``, read as text."""
    names = set()
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    for path in sorted(CSRC.glob("*.cu*")):
        names.update(pattern.findall(path.read_text()))
    return names


def test_profiler_keys_name_kernels():
    """Every key of ``chip_smoke.KERNEL_OF`` names a ``__global__``
    function of ``csrc/``, and every such function, as the profiler shows
    an instantiation of it, is attributed to its own kernel by the first
    key that matches it, as phase 4 reads the profiler: no key swallows
    another kernel (``corr_norm_kernel`` is not ``correlation``'s)."""
    kernels = _global_functions()
    assert {"corr_norm_kernel", "corr_plain_kernel", "feature_warp_kernel",
            "warp_kernel"} <= kernels
    assert "corr_kernel" not in kernels  # corr_body.cuh's kernel is gone
    keys = [key for key, _ in chip_smoke.KERNEL_OF]
    assert all(key in kernels for key in keys)
    for name in kernels:
        # the profiler's name of an instantiation
        shown = "void (anonymous namespace)::%s<float, 1, true>(float " \
                "const*, float const*)" % name
        first = next(key for key in keys if key in shown)
        assert first == name
    key_of = dict((n, k) for k, n in chip_smoke.KERNEL_OF)
    assert key_of["correlation"] == "corr_plain_kernel"
    assert key_of["corr_norm"] == "corr_norm_kernel"
