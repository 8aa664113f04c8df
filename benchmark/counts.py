"""The yardstick's arithmetic: the chip's published peaks and the
operations and bytes of the port's kernels and of a query, computed from
shapes alone.

``flop_count`` and ``byte_count`` are frozen copies of chip_smoke.py's
(recounted there from the kernels' code); only the model's sizes enter,
as plain numbers.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit
PEAKS = {
    "bf16_flops": 989.4e12,
    "tf32_flops": 494.7e12,
    "f32_flops": 66.9e12,
    "hbm_bytes": 3.35e12,
}


def flop_count(name: str, n_layers: int, hidden: int, N: int, R: int):
    """(bf16, f32) operations of one call of kernel ``name`` ("K1-pc",
    "K1-ray", "K1-stream", "K2", "K3", "K4") at N points and R surface
    points. Products with a 256x256 matrix per point: K1 3(nh+1) forward,
    v-chain and tangent chain (the skip layer twice), 2(nh-1) backward
    chain, 2(nh+1) dW. f32: the PE build (7 per lane), the scores (7 per
    surface point), the tangent contractions and the output head."""
    name = name.removesuffix("-f32")
    nh = n_layers - 1
    mm = N * 2 * hidden * hidden
    if name.startswith("K1"):
        f32 = N * (2 * 3 * 256 + (7 * 256 if name != "K1-stream" else 0)
                   + (7 * R if name == "K1-pc" else 0))
        return (3 * (nh + 1) + 2 * (nh - 1) + 2 * (nh + 1)) * mm, f32
    if name == "K2":
        return 2 * (nh + 1) * mm, N * (2 * 256 + 2 * 3 * 256)
    if name == "K3":
        return ((nh + 1) * 2 + 2 * (nh - 1) + 2 * (nh + 1)) * mm, \
            N * (2 * 3 * 256 + 2 * 2 * 256)
    return 0, 7 * N * R + 5 * R


def byte_count(name: str, n_layers: int, E: int, N: int, R: int) -> int:
    """Bytes of one call: each input read once, each output written
    once."""
    name = name.removesuffix("-f32")
    L = n_layers
    w = L * 512 * 256 * 4 + L * 256 * 4
    if name == "K4":
        return N * 3 * 4 + R * 3 * 4 + R + N * 8
    if name == "K2":
        return N * E * 4 + w + 3 * 256 * 4 + N * 4 * 4
    if name == "K3":
        return N * E * 4 + N * 4 * 4 + w + 3 * 256 * 4 + w
    per_pt = {"K1-pc": 3 + 1 + 1 + 1 + 3 + 1, "K1-ray": 3 + 1 + 1 + 1 + 3,
              "K1-stream": E + 1 + 1 + 1 + 3}[name]
    ins = N * 4 * per_pt + w + (R * 4 * 4 if name == "K1-pc" else 0)
    return ins + N * 4 + 5 * 4 + w


def peak_seconds(bf16_flops: float, f32_flops: float) -> float:
    """The least time the chip needs for these operations at its peaks."""
    return bf16_flops / PEAKS["bf16_flops"] + f32_flops / PEAKS["f32_flops"]


def query_flops(E: int, hidden: int, blocks: int, n_freqs: int, n: int,
                grad: bool) -> int:
    """f32 operations of an SDF query of n points: the PE (its scene-frame
    map, the 21 projections, the bands and the sines), the MLP's products
    (in, the blocks, the skip layer, the head) and, for a gradient, the
    input gradient's backward chain through the same products."""
    H = hidden
    mlp = 2 * (E * H + 2 * blocks * H * H + (H + E) * H + H)
    pe = 2 * 9 + 2 * 21 * 3 + 21 * n_freqs * 2
    return n * (pe + (2 * mlp if grad else mlp))
