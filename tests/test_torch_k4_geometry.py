"""The launch geometry of the nearest-surface kernel K4
(isdf_tpu_torch/ops/cuda_bounds.py::k4_geometry), on the CPU.

A block takes `points` sample points, `ppt` a thread, in `splits` groups of
`lanes` threads; each group scans its own rows of the surface set, staged
`chunk` rows at a time, keeping a running minimum and recording the run of
rows where it fell; per point the groups are merged in a fixed order and
the winner's run is scored again. The kernel indexes points and surface
rows by this geometry, so it is held here for ragged and exact M and R, R
below the split count and a surface set of several chunks. The last test
replays the kernel's scan and merge on the geometry's rows in torch and
holds the indices to the plain version's."""

import numpy as np
import pytest
import torch

from isdf_tpu_torch.ops import cuda_bounds as CB

SIZES = [(1, 1), (27000, 1000), (5373, 997), (64, 8), (100, 3), (4224, 64),
         (300, 2 * CB.K4_CHUNK + 5)]
SHAPES = [(256, 8, None), (256, 8, 2), (128, 4, 4), (512, 16, 7),
          (256, 16, 3), (512, 8, 8)]


@pytest.mark.parametrize("M,R", SIZES)
@pytest.mark.parametrize("threads,splits,ppt", SHAPES)
def test_every_surface_index_in_one_split_ascending(M, R, threads, splits,
                                                    ppt):
    g = CB.k4_geometry(M, R, threads, splits, ppt)
    assert len(g["rows"]) == splits
    seen = []
    for ranges in g["rows"]:
        ix = [k for kb, ke in ranges for k in range(kb, ke)]
        assert ix == sorted(ix) and len(set(ix)) == len(ix)  # ascending
        seen += ix
    assert sorted(seen) == list(range(R))                  # each once
    assert g["chunk"] <= CB.K4_CHUNK


@pytest.mark.parametrize("M,R", SIZES)
@pytest.mark.parametrize("threads,splits,ppt", SHAPES)
def test_blocks_cover_every_point_once(M, R, threads, splits, ppt):
    g = CB.k4_geometry(M, R, threads, splits, ppt)
    assert g["lanes"] * g["splits"] == g["threads"] == threads
    assert g["points"] == g["lanes"] * g["ppt"]
    # block b, lane l, chain j takes point b * points + l + j * lanes
    pts = sorted(b * g["points"] + l + j * g["lanes"]
                 for b in range(g["blocks"]) for l in range(g["lanes"])
                 for j in range(g["ppt"]))
    assert pts == list(range(g["blocks"] * g["points"]))
    assert g["blocks"] * g["points"] >= M > (g["blocks"] - 1) * g["points"]
    # shared memory: the staged chunk and the groups' (minimum, run) pairs
    assert g["smem"] == g["chunk"] * 16 + splits * g["points"] * 8
    assert g["smem"] <= 48 * 1024


def test_points_per_block_fill_whole_waves():
    """At the trainer's 27,000 points the chosen ppt is the largest that
    fills the SMs within 2% of the best."""
    g = CB.k4_geometry(27000, 1000)
    fills = {p: CB.k4_geometry(27000, 1000, ppt=p)["fill"] for p in CB.PPTS}
    assert g["fill"] >= 0.98 * max(fills.values()) and g["fill"] > 0.9
    assert all(f < 0.98 * max(fills.values()) for p, f in fills.items()
               if p > g["ppt"])
    assert CB.k4_geometry(27000, 1000, ppt=2)["blocks"] == 422


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        CB.k4_geometry(100, 10, threads=100)
    with pytest.raises(ValueError):
        CB.k4_geometry(100, 10, threads=256, splits=3)
    with pytest.raises(ValueError):
        CB.k4_geometry(100, 10, ppt=9)


def _replay(points, surf, valid, g):
    """The kernel's scan and merge, in torch. Per pass and group a running
    minimum, each run of g["run"] rows recorded if it lowered the minimum
    strictly; per point the first group with the smallest minimum, whose
    recorded run is scored again for its first row equal to the minimum,
    if it lowers the earlier passes' result strictly."""
    a = -2.0 * surf
    bias = CB._surface_bias(surf, valid)
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    score = bias + ((x * a[:, 0] + y * a[:, 1]) + z * a[:, 2])
    M, run, inf = points.shape[0], g["run"], float("inf")
    best = torch.full((M,), inf)
    bi = torch.zeros(M, dtype=torch.int64)
    passes = sorted({kb // g["chunk"] for rows in g["rows"]
                     for kb, _ in rows})
    for c in passes:
        gm = torch.full((M,), inf)
        gc = torch.zeros(M, dtype=torch.int64)
        gke = torch.zeros(M, dtype=torch.int64)
        for rows in g["rows"]:         # groups in order
            share = [(kb, ke) for kb, ke in rows if kb // g["chunk"] == c]
            if not share:
                continue
            (kb, ke), = share
            m = torch.full((M,), inf)
            ck = torch.full((M,), -1, dtype=torch.int64)
            for k in range(kb, ke, run):
                mp = m
                m = torch.fmin(m, score[:, k:min(k + run, ke)].min(1).values)
                ck = torch.where(m < mp, k, ck)
            win = m < gm
            gm, gc = torch.where(win, m, gm), torch.where(win, ck, gc)
            gke = torch.where(win, ke, gke)
        found = ~(gm < best)
        for u in range(run):
            ix = gc + u
            hit = ~found & (ix < gke) & (score.gather(
                1, ix.clamp(0, score.shape[1] - 1)[:, None])[:, 0] == gm)
            bi = torch.where(hit, ix, bi)
            found |= hit
        best = torch.where(gm < best, gm, best)
    return bi


@pytest.mark.parametrize("R", [3, 40, 2 * CB.K4_CHUNK + 5])
def test_replayed_split_scan_matches_plain(R):
    """Duplicated surface points in different groups and chunks tie
    exactly: the reduction must keep the first index."""
    rng = np.random.default_rng(R)
    half = (R + 1) // 2
    s = rng.normal(size=(half, 3)).astype(np.float32)
    surf = torch.as_tensor(np.concatenate([s, s])[:R])
    valid = torch.as_tensor(rng.random(R) > 0.2)
    valid[0] = True
    pts = torch.as_tensor(np.concatenate([
        rng.normal(size=(150, 3)).astype(np.float32),
        s[:50] * np.float32(1.0)]))
    for shape in SHAPES:
        g = CB.k4_geometry(pts.shape[0], R, *shape)
        want = CB.closest_surface_ix_plain(pts, surf, valid)
        assert torch.equal(_replay(pts, surf, valid, g), want), shape
