"""The fused train op's operations and bytes at the map's own fan-ins,
from shapes alone.

counts.py counts K1 as the kernel pads it: every product with a 256x256
matrix, the PE 256 lanes, the weight planes [L, 512, 256]. A map with a
wider embedding (n_embed_funcs 8: E = 381, iSDF's live configs) has a
deeper layer 0 and skip layer than that count holds. Here each product is
counted at its fan-in, whatever lanes a kernel pads it to:

    forward, v-chain, tangent chain, each   H (E + (nh - 1) H + E)
        (layer 0 E -> H, the hidden layers H -> H, the skip layer's pe
        rows E -> H; the v-chain the same products transposed)
    backward chain (dh and dt, layers nh - 1 .. 1)   2 (nh - 1) H H
    dW (a and ta of each GEMM)   2 H (E + (nh - 1) H + E)

multiply-adds a point, two operations each, on the tensor cores; with
nh = L - 1 hidden layers. In f32: the PE build (7 a lane over E lanes,
where the op builds it), the pc scores (7 a surface point), the spatial
gradient's contraction and the combined tangent (3 multiply-adds a lane
each over E lanes), the output head (H multiply-adds). Bytes: each input
read once and each output written once, the map's parameters at their
fan-ins in f32 read and their gradient written. At E = 256 the products
are counts.py's 45 a point at L = 7.

``bundle_shape`` reads the shape of the op a traced window's steps
launched from the program's ``step.bundle`` spans.
"""

from __future__ import annotations

from benchmark import program_spans as PS


def k1_products(n_layers: int, hidden: int, E: int) -> int:
    """Multiply-adds a point of the op's tensor-core products."""
    nh, H = n_layers - 1, hidden
    chain = H * (2 * E + (nh - 1) * H)
    return 3 * chain + 2 * (nh - 1) * H * H + 2 * chain


def k1_flops(name: str, n_layers: int, hidden: int, E: int, N: int,
             R: int):
    """(bf16, f32) operations of one call of K1 ``name`` ("K1-pc",
    "K1-ray", "K1-stream") at N points and R surface points."""
    f32 = 2 * 3 * E + 2 * 3 * E + 2 * hidden
    if name != "K1-stream":
        f32 += 7 * E
    if name == "K1-pc":
        f32 += 7 * R
    return 2 * N * k1_products(n_layers, hidden, E), N * f32


def k1_params(n_layers: int, hidden: int, E: int) -> int:
    """The map's trained entries: weights at their fan-ins and biases."""
    nh, H = n_layers - 1, hidden
    return H * (2 * E + (nh - 1) * H) + H + nh * H + 1


def k1_bytes(name: str, n_layers: int, hidden: int, E: int, N: int,
             R: int) -> int:
    """Bytes of one call: the points' inputs, the surface set (pc), the
    parameters read, the per-point loss, the five sums and the gradient
    written."""
    per_pt = {"K1-pc": 3 + 1 + 1 + 1 + 3 + 1, "K1-ray": 3 + 1 + 1 + 1 + 3,
              "K1-stream": E + 1 + 1 + 1 + 3}[name]
    w = 4 * k1_params(n_layers, hidden, E)
    ins = N * 4 * per_pt + w + (R * 4 * 4 if name == "K1-pc" else 0)
    return ins + N * 4 + 5 * 4 + w


def bundle_shape(trace):
    """{name, n_layers, hidden, E, N, R} of the train op the window's
    ``step.bundle`` spans record (utils/profiling.py; the kernel's hidden
    width is 256), or None: without such spans, where a span names no
    kernel variant (an eager or CPU step, or a program that records none),
    or where the spans disagree."""
    bundles = PS.within(trace, "step.bundle")
    if bundles is None:
        return None
    shapes = set()
    for b in bundles:
        c = b.counts
        if not isinstance(c.get("train_op"), str):
            return None
        variant = c["train_op"].split("/")[0].removesuffix("-f32")
        shapes.add((variant.removesuffix("-384"), int(c["layers"]),
                    int(c["embedding"]), int(c["points"]),
                    int(c["surface"])))
    if len(shapes) != 1:
        return None
    name, L, E, N, R = shapes.pop()
    return dict(name=name, n_layers=L, hidden=256, E=E, N=N, R=R)
