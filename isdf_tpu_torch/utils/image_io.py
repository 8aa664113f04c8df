"""The port's image codec: PNG and baseline JPEG, read and written without
cv2 or PIL (the card machine has neither).

It stands in for the cv2 calls of isdf_tpu's readers and writers, with
cv2's conventions: colour arrays are BGR, ``imread`` without flags returns
8-bit BGR, ``IMREAD_UNCHANGED`` the stored depth and channels (uint16 grey
depth PNGs).

* PNG: 8-bit grey, grey + alpha, RGB, RGBA and palette, 16-bit grey; all
  five row filters on read; the Up filter on write; zlib from the
  standard library. 16-bit colour, sub-byte depths and interlaced files
  raise.
* JPEG: baseline (and extended) sequential Huffman, 8-bit, greyscale or
  YCbCr with any sampling factors, restart markers. Samples come from
  libjpeg's integer inverse DCT, chroma from its "fancy" triangle
  upsampling for 2x1 and 2x2 sampling and its fixed-point YCbCr -> RGB
  tables, which is what ``cv2.imread`` computes. Progressive, lossless and
  arithmetic-coded files raise. The writer makes baseline files with the
  standard (Annex K) tables at quality 95 and 4:2:0 chroma, as cv2
  writes them by default.

The sequential byte work (PNG unfiltering, Huffman decoding and encoding)
and the inverse DCT run in host C++ (``csrc/image_codec.cpp``, built by
utils/native.py with g++); numpy does the rest. Where the library does not
build, reading or writing an image raises RuntimeError.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from isdf_tpu_torch.utils import native
from isdf_tpu_torch.utils.profiling import span

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _lib():
    lib = native.load("image_codec")
    if lib is None:
        raise RuntimeError(
            "utils/image_io.py: csrc/image_codec.cpp did not build (g++ is "
            "needed to read and write PNG and JPEG)")
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _read_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, np.ndarray):
        return src.tobytes()
    with span("data.file_read") as sp, open(src, "rb") as f:
        data = f.read()
        sp.count(bytes=len(data))
        return data


# ---------------------------------------------------------------------------
# the cv2-shaped entry points
# ---------------------------------------------------------------------------

def imdecode(buf, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Decode PNG or JPEG bytes, sniffed from their signature."""
    data = _read_bytes(buf)
    if data[:8] == _PNG_SIG:
        return read_png(data, flags)
    if data[:2] == b"\xff\xd8":
        return read_jpeg(data, flags)
    raise ValueError("not a PNG or JPEG stream")


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """cv2.imread for PNG and JPEG files (raises where cv2 returns None)."""
    return imdecode(_read_bytes(path), flags)


def imwrite(path: str, img: np.ndarray) -> bool:
    """cv2.imwrite for .png, .jpg and .jpeg (colour arrays in BGR)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img)
    elif ext in (".jpg", ".jpeg"):
        write_jpeg(path, img)
    else:
        raise ValueError(f"unsupported image extension {ext!r}")
    return True


def _to_flags(img: np.ndarray, flags: int) -> np.ndarray:
    """A decoded grey (H, W), BGR or BGRA array in the layout cv2 returns
    for ``flags``."""
    if flags == IMREAD_UNCHANGED:
        return img
    if flags == IMREAD_COLOR:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            return np.repeat(img[:, :, None], 3, axis=2)
        return np.ascontiguousarray(img[:, :, :3])
    raise ValueError(f"unsupported imread flags {flags} for this image")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    raw = np.frombuffer(raw, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG: image data is truncated")
    raw = np.ascontiguousarray(raw[:h * (stride + 1)])
    lib = _lib()
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(_ptr(raw, ctypes.c_uint8), h, stride, bpp,
                          _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError("PNG: unknown filter type")
    return out


def read_png(src, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """Decode a PNG file or bytes. UNCHANGED: grey (H, W) uint8 or uint16,
    colour BGR / BGRA uint8; COLOR: BGR uint8 (16-bit grey keeps its high
    byte, alpha is dropped)."""
    data = _read_bytes(src)
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG stream")
    pos, ihdr, plte, trns, idat, ended = 8, None, None, None, [], False
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n or pos + 12 + n > len(data):
            raise ValueError("PNG: truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
            break
    if ihdr is None or not ended:
        raise ValueError("PNG: missing IHDR or IEND (truncated file?)")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if interlace:
        raise ValueError("PNG: interlaced (Adam7) files are not supported")
    if depth == 16 and ctype != 0:
        raise ValueError("PNG: 16-bit colour is not supported (16-bit "
                         "greyscale is)")
    if depth not in (8, 16):
        raise ValueError(f"PNG: bit depth {depth} is not supported")
    bpp = channels * depth // 8
    stride = w * bpp
    with span("data.png_inflate") as sp:
        raw = zlib.decompress(b"".join(idat))
        sp.count(bytes=len(raw))
    with span("data.png_unfilter"):
        pix = _unfilter(raw, h, stride, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16).reshape(h, w)
    else:
        img = pix.reshape(h, w, channels)
        if ctype == 3:
            if plte is None:
                raise ValueError("PNG: palette image without PLTE")
            rgb = plte[img[:, :, 0]]
            if trns is not None:
                alpha = np.full(len(plte), 255, np.uint8)
                alpha[:len(trns)] = trns[:len(plte)]
                img = np.concatenate([rgb, alpha[img[:, :, 0]][..., None]],
                                     axis=2)
            else:
                img = rgb
        elif ctype == 0:
            img = img[:, :, 0]
        elif ctype == 4:
            g, a = img[:, :, 0], img[:, :, 1]
            img = np.stack([g, g, g, a], axis=2)
        if img.ndim == 3:   # RGB(A) -> BGR(A), as cv2 returns it
            img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]
    return _to_flags(np.ascontiguousarray(img), flags)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of uint8 grey (H, W), BGR (H, W, 3) or BGRA (H, W, 4), or
    uint16 grey;
    every row Up-filtered; zlib at level 1, cv2's default."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.dtype == np.uint16:
        if img.ndim != 2:
            raise ValueError("PNG: 16-bit colour is not supported")
        depth, ctype = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8:
        depth = 8
        if img.ndim == 2:
            ctype, rows = 0, img
        elif img.shape[2] == 3:
            ctype = 2
            rows = img[:, :, ::-1].reshape(img.shape[0], -1)  # BGR -> RGB
        elif img.shape[2] == 4:
            ctype = 6
            rows = img[:, :, [2, 1, 0, 3]].reshape(img.shape[0], -1)
        else:
            raise ValueError(f"PNG: {img.shape[2]} channels")
    else:
        raise ValueError(f"PNG: dtype {img.dtype} is not supported")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows)
    up = np.empty((h, rows.shape[1] + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = rows[0]
    up[1:, 1:] = rows[1:] - rows[:-1]     # mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# JPEG tables
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 quantisation tables, natural order
STD_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_QUANT_CHROMA = np.full(64, 99)
STD_QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _ac_values(prefix):
    """An Annex K.3 AC table's values: its irregular head, then every
    other run/size symbol in ascending order."""
    every = {0x00, 0xF0} | {(r << 4) | s for r in range(16)
                            for s in range(1, 11)}
    return prefix + sorted(every - set(prefix))


# Annex K.3 Huffman tables: (code-length counts, values)
STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
STD_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
               _ac_values([
                   0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
                   0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
                   0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1,
                   0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
                   0x82]))
STD_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                 _ac_values([
                     0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
                     0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
                     0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1,
                     0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
                     0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1]))


# The writer's quantisation tables: libjpeg's jpeg_quality_scaling of the
# two standard tables at cv2's default quality 95 (scale 200 - 2 * 95 = 10
# per cent), natural order.
QUANT_LUMA, QUANT_CHROMA = (np.clip((t * 10 + 50) // 100, 1, 255).astype(
    np.uint16) for t in (STD_QUANT_LUMA, STD_QUANT_CHROMA))


def _table_bytes(dc, ac) -> np.ndarray:
    """One scan component's tables in the C layout: DC bits[16],
    values[256], AC bits[16], values[256]."""
    out = np.zeros(544, np.uint8)
    for off, (bits, vals) in ((0, dc), (272, ac)):
        out[off:off + 16] = bits
        out[off + 16:off + 16 + len(vals)] = vals
    return out


# ---------------------------------------------------------------------------
# JPEG: entropy decoding and the inverse DCT (in csrc/image_codec.cpp)
# ---------------------------------------------------------------------------

def _segment_end(data: bytes, start: int) -> int:
    """Index of the first marker after ``start`` that is not RSTn."""
    i = start
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            return len(data)
        nxt = data[i + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
            i += 2
            continue
        return i


def _decode_scan(lib, data, start, n_units, units_blocks, block_comp,
                 tables, restart):
    end = _segment_end(data, start)
    seg = data[start:end]
    out = np.empty((n_units * units_blocks, 64), np.int16)
    buf = np.frombuffer(seg, np.uint8)
    bc = np.asarray(block_comp, np.uint8)
    tb = np.ascontiguousarray(tables, np.uint8)
    rc = lib.jpeg_decode_scan(
        _ptr(buf, ctypes.c_uint8), len(seg), n_units, units_blocks,
        _ptr(bc, ctypes.c_uint8), len(tables) // 544,
        _ptr(tb, ctypes.c_uint8), restart, _ptr(out, ctypes.c_int16))
    if rc < 0:
        raise ValueError(f"JPEG: corrupt entropy-coded data ({rc})")
    return out, end


def _idct(lib, coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    coefs = np.ascontiguousarray(coefs, np.int16).reshape(-1, 64)
    q = np.ascontiguousarray(q, np.uint16)
    out = np.empty((coefs.shape[0], 64), np.uint8)
    lib.jpeg_idct_islow(_ptr(coefs, ctypes.c_int16), coefs.shape[0],
                        _ptr(q, ctypes.c_uint16), _ptr(out, ctypes.c_uint8))
    return out


# ---------------------------------------------------------------------------
# JPEG: upsampling and colour (libjpeg's jdsample.c and jdcolor.c)
# ---------------------------------------------------------------------------

def _fancy_h2(x: np.ndarray, bias_lo: int, bias_hi: int,
              shift: int, edge_mul: int) -> np.ndarray:
    """Horizontal triangle filter doubling the columns of x [R, w]
    (int32): output 2i = (3 x_i + x_{i-1} + bias_lo) >> shift, 2i+1 =
    (3 x_i + x_{i+1} + bias_hi) >> shift; the outer edges use edge_mul x
    alone."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    even = (3 * x + left + bias_lo) >> shift
    odd = (3 * x + right + bias_hi) >> shift
    even[:, 0] = (edge_mul * x[:, 0] + bias_lo) >> shift
    odd[:, -1] = (edge_mul * x[:, -1] + bias_hi) >> shift
    out = np.empty((x.shape[0], 2 * x.shape[1]), x.dtype)
    out[:, 0::2], out[:, 1::2] = even, odd
    return out


def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """One component plane [ch, cw] (uint8) upsampled by (hf, vf) as
    libjpeg does with do_fancy_upsampling: triangle filters for 2x1 and
    2x2 (where the plane is wider than 2), replication otherwise."""
    if hf == 1 and vf == 1:
        return plane
    x = plane.astype(np.int32)
    if hf == 2 and vf == 1 and x.shape[1] > 2:
        # h2v1_fancy_upsample
        return _fancy_h2(x, 1, 2, 2, 4).astype(np.uint8)
    if hf == 2 and vf == 2 and x.shape[1] > 2:
        # h2v2_fancy_upsample: column sums 3 * this row + the nearer
        # neighbour row (the edge rows are their own neighbours)
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
        out[0::2] = _fancy_h2(3 * x + above, 8, 7, 4, 4)
        out[1::2] = _fancy_h2(3 * x + below, 8, 7, 4, 4)
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_CI = np.arange(256) - 128
_CR_R = (_fix(1.40200) * _CI + 32768) >> 16
_CB_B = (_fix(1.77200) * _CI + 32768) >> 16
_CR_G = -_fix(0.71414) * _CI
_CB_G = -_fix(0.34414) * _CI + 32768


def _ycc_to_bgr(y, cb, cr) -> np.ndarray:
    """libjpeg's ycc_rgb_convert, in BGR order."""
    y = y.astype(np.int32)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG: the reader
# ---------------------------------------------------------------------------

_UNSUPPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless",
                    0xC5: "differential sequential",
                    0xC6: "differential progressive",
                    0xC7: "differential lossless",
                    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
                    0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
                    0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


def read_jpeg(src, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Decode a baseline JPEG file or bytes. COLOR: BGR (H, W, 3) uint8;
    UNCHANGED: grey (H, W) for one component, else BGR."""
    data = _read_bytes(src)
    with span("data.jpeg_decode", bytes=len(data)):
        return _decode_jpeg(data, flags)


def _decode_jpeg(data: bytes, flags: int) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    lib = _lib()
    qt, dc, ac = {}, {}, {}
    frame, restart, adobe = None, 0, None
    coefs, comp_q = {}, {}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            break
        if pos + 2 > len(data):
            raise ValueError("JPEG: truncated segment")
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + n]
        if len(seg) != n - 2:
            raise ValueError("JPEG: truncated segment")
        pos += n
        if m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                    i += 65
                t = np.zeros(64, np.uint16)
                t[ZIGZAG] = vals
                qt[tq] = t
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = list(seg[i + 1:i + 17])
                vals = list(seg[i + 17:i + 17 + sum(bits)])
                (ac if tc else dc)[th] = (bits, vals)
                i += 17 + sum(bits)
        elif m in (0xC0, 0xC1):
            prec, Y, X, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"JPEG: {prec}-bit samples are not "
                                 "supported")
            if Y == 0:
                raise ValueError("JPEG: DNL-defined height is not supported")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                      seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nf)]
            if nf not in (1, 3):
                raise ValueError(f"JPEG: {nf} components are not supported")
            if any(h < 1 or v < 1 or max(c[1] for c in comps) % h
                   or max(c[2] for c in comps) % v for _, h, v, _ in comps):
                raise ValueError("JPEG: unsupported sampling factors")
            frame = dict(X=X, Y=Y, comps=comps,
                         hmax=max(c[1] for c in comps),
                         vmax=max(c[2] for c in comps))
            frame["mcux"] = _cdiv(X, 8 * frame["hmax"])
            frame["mcuy"] = _cdiv(Y, 8 * frame["vmax"])
            for k, (_cid, h, v, _tq) in enumerate(comps):
                coefs[k] = np.zeros((frame["mcuy"] * v, frame["mcux"] * h,
                                     64), np.int16)
        elif m in _UNSUPPORTED_SOF:
            raise ValueError(f"JPEG: {_UNSUPPORTED_SOF[m]} files are not "
                             "supported (baseline sequential only)")
        elif m == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = seg[0]
            ids = [c[0] for c in frame["comps"]]
            scomp = [(ids.index(seg[1 + 2 * k]), seg[2 + 2 * k] >> 4,
                      seg[2 + 2 * k] & 15) for k in range(ns)]
            tables = np.concatenate([_table_bytes(dc[td], ac[ta])
                                     for _, td, ta in scomp])
            for k, _, _ in scomp:
                comp_q.setdefault(k, qt[frame["comps"][k][3]].copy())
            if ns == 1:
                k = scomp[0][0]
                _cid, h, v, _tq = frame["comps"][k]
                bw = _cdiv(_cdiv(frame["X"] * h, frame["hmax"]), 8)
                bh = _cdiv(_cdiv(frame["Y"] * v, frame["vmax"]), 8)
                out, pos = _decode_scan(lib, data, pos, bw * bh, 1, [0],
                                        tables, restart)
                coefs[k][:bh, :bw] = out.reshape(bh, bw, 64)
            else:
                block_comp = [j for j, (k, _, _) in enumerate(scomp)
                              for _ in range(frame["comps"][k][1]
                                             * frame["comps"][k][2])]
                units = frame["mcux"] * frame["mcuy"]
                out, pos = _decode_scan(lib, data, pos, units,
                                        len(block_comp), block_comp, tables,
                                        restart)
                out = out.reshape(frame["mcuy"], frame["mcux"],
                                  len(block_comp), 64)
                o = 0
                for k, _, _ in scomp:
                    _cid, h, v, _tq = frame["comps"][k]
                    part = out[:, :, o:o + h * v].reshape(
                        frame["mcuy"], frame["mcux"], v, h, 64)
                    coefs[k][:] = part.transpose(0, 2, 1, 3, 4).reshape(
                        coefs[k].shape)
                    o += h * v
    if frame is None or not comp_q:
        raise ValueError("JPEG: no frame or no scan (truncated file?)")
    planes = []
    for k, (_cid, h, v, _tq) in enumerate(frame["comps"]):
        c = coefs[k]
        px = _idct(lib, c.reshape(-1, 64), comp_q[k]).reshape(
            c.shape[0], c.shape[1], 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(8 * c.shape[0],
                                              8 * c.shape[1])
        cw = _cdiv(frame["X"] * h, frame["hmax"])
        ch = _cdiv(frame["Y"] * v, frame["vmax"])
        px = _upsample(px[:ch, :cw], frame["hmax"] // h, frame["vmax"] // v)
        planes.append(px[:frame["Y"], :frame["X"]])
    if len(planes) == 1:
        img = planes[0]
    elif adobe == 0:    # Adobe transform 0: the components are RGB
        img = np.stack(planes[::-1], axis=-1)
    else:
        img = _ycc_to_bgr(*planes)
    return _to_flags(np.ascontiguousarray(img), flags)


# ---------------------------------------------------------------------------
# JPEG: the writer
# ---------------------------------------------------------------------------

_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2.0
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _bgr_to_ycc(img: np.ndarray):
    """libjpeg's rgb_ycc_convert (fixed point, jccolor.c)."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    half, off = 32768, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off
          + half - 1) >> 16
    return [p.astype(np.uint8) for p in (y, cb, cr)]


def _pad_edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quantised DCT blocks [by, bx, 64] (natural order) of a plane whose
    sides are multiples of 8; rounding half away from zero, AC clamped to
    baseline's 10 bits."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.astype(np.float64).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    f = _DCT @ (x - 128.0) @ _DCT.T
    f = f.reshape(by, bx, 64) / q.astype(np.float64)
    qz = np.sign(f) * np.floor(np.abs(f) + 0.5)
    qz[..., 1:] = np.clip(qz[..., 1:], -1023, 1023)
    return qz.astype(np.int16)


def encode_jpeg(img: np.ndarray) -> bytes:
    """Baseline JPEG bytes of uint8 grey (H, W) or BGR (H, W, 3): the
    standard tables at quality 95, chroma subsampled 2x2 (4:2:0), as cv2
    writes them by default."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("JPEG: only 8-bit images are supported")
    H, W = img.shape[:2]
    if img.ndim == 2 or img.shape[2] == 1:
        comps = [(1, 1, 1, 0)]
        planes = [img.reshape(H, W)]
    elif img.shape[2] == 3:
        comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        planes = _bgr_to_ycc(img)
    else:
        raise ValueError(f"JPEG: {img.shape[2]} channels")
    hmax = max(c[1] for c in comps)
    mcux, mcuy = _cdiv(W, 8 * hmax), _cdiv(H, 8 * hmax)
    qs = [QUANT_LUMA, QUANT_CHROMA]
    comp_blocks = []
    for (cid, h, v, tq), p in zip(comps, planes):
        full = _pad_edge(p, mcuy * 8 * hmax, mcux * 8 * hmax)
        if h < hmax:
            # libjpeg's h2v2_downsample: mean of 2x2 with bias 1, 2, 1, ...
            s = full.astype(np.int32)
            s = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                 + s[1::2, 1::2])
            bias = np.tile([1, 2], s.shape[1] // 2 + 1)[:s.shape[1]]
            full = ((s + bias) >> 2).astype(np.uint8)
        comp_blocks.append(_blocks(full, qs[tq]))
    if len(comps) == 1:
        units_blocks, block_comp = 1, [0]
        scan = comp_blocks[0]     # one component: raster order of blocks
        scan = scan.reshape(-1, 64)
    else:
        units_blocks = sum(h * v for _, h, v, _ in comps)
        block_comp = [k for k, (_, h, v, _) in enumerate(comps)
                      for _ in range(h * v)]
        per_comp = []
        for (_, h, v, _), b in zip(comps, comp_blocks):
            per_comp.append(b.reshape(mcuy, v, mcux, h, 64).transpose(
                0, 2, 1, 3, 4).reshape(mcuy, mcux, v * h, 64))
        scan = np.concatenate(per_comp, axis=2).reshape(-1, 64)
    scan = np.ascontiguousarray(scan, np.int16)
    tables = np.concatenate(
        [_table_bytes(STD_DC_LUMA, STD_AC_LUMA) if tq == 0 else
         _table_bytes(STD_DC_CHROMA, STD_AC_CHROMA)
         for _, _, _, tq in comps])
    lib = _lib()
    n_units = scan.shape[0] // units_blocks
    # at most 208 bytes a block (11 + 11 DC bits, 63 x 26 AC bits), twice
    # that with every byte stuffed
    cap = scan.shape[0] * 512 + 4096
    out = np.empty(cap, np.uint8)
    bc = np.asarray(block_comp, np.uint8)
    n = lib.jpeg_encode_scan(
        _ptr(scan, ctypes.c_int16), n_units, units_blocks,
        _ptr(bc, ctypes.c_uint8), len(comps),
        _ptr(tables, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError("JPEG: entropy-coded data overflowed")
    body = out[:n].tobytes()

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload

    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                             b"\x00\x00")
    for tq in sorted({c[3] for c in comps}):
        head += seg(0xDB, bytes([tq]) + qs[tq][ZIGZAG].astype(
            np.uint8).tobytes())
    head += seg(0xC0, struct.pack(">BHHB", 8, H, W, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps))
    for tq in sorted({c[3] for c in comps}):
        dct, act = ((STD_DC_LUMA, STD_AC_LUMA) if tq == 0
                    else (STD_DC_CHROMA, STD_AC_CHROMA))
        for cls, (bits, vals) in ((0x00, dct), (0x10, act)):
            head += seg(0xC4, bytes([cls | tq] + list(bits) + list(vals)))
    head += seg(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, _, tq in comps)
        + b"\x00\x3f\x00")
    return head + body + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray) -> None:
    data = encode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# resizing (cv2.resize with INTER_AREA)
# ---------------------------------------------------------------------------

def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] weights of cv2's true area path along one axis that
    does not grow: the overlap of each output cell with the source pixels
    over the cell's width (the identity where n_dst == n_src)."""
    m = np.zeros((n_dst, n_src))
    scale = n_src / n_dst
    for i in range(n_dst):
        a, b = i * scale, (i + 1) * scale
        for j in range(int(np.floor(a)), min(int(np.ceil(b)), n_src)):
            m[i, j] = (min(b, j + 1) - max(a, j)) / scale
    return m


def _linear_tab(n_src: int, n_dst: int, last: bool):
    """cv2's INTER_AREA coefficients along one axis where either axis
    grows (resize.cpp, the ``area_mode`` branch of the linear path):
    source index sx = floor(dx * scale) with scale = 1 / (n_dst / n_src)
    in double, as cv2 computes it, and the fraction fx = (dx + 1) - (sx +
    1) * inv_scale rounded to float, 0 where not positive, else fx -
    floor(fx). ``last``: an index past the last pixel takes it with
    fraction 0 (cv2's columns); else the fraction stays and the second
    row clamps (cv2's rows). Returns (first, second index, fraction)."""
    inv = n_dst / n_src
    i = np.arange(n_dst)
    sx = np.floor(i * (1.0 / inv)).astype(np.int64)
    fx = ((i + 1) - (sx + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    if last:
        edge = sx >= n_src - 1
        sx, fx = np.where(edge, n_src - 1, sx), np.where(edge, 0, fx)
    return sx, np.minimum(sx + 1, n_src - 1), fx.astype(np.float32)


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2's INTER_AREA where an axis grows: the same interpolating
    coefficients on both axes, the shrinking one included. uint8 in cv2's
    11-bit fixed point (rows as int sums of 11-bit coefficients, columns
    by its vector rounding: each product of a row >> 4 with an 11-bit
    coefficient >> 16, the sum rounded >> 2); other types in float32
    (float64 kept), integers rounded half to even and saturated."""
    H, W = img.shape[:2]
    x0, x1, fx = _linear_tab(W, w, True)
    y0, y1, fy = _linear_tab(H, h, False)
    cx = (slice(None),) + (None,) * (img.ndim - 2)
    cy = (slice(None),) + (None,) * (img.ndim - 1)
    if img.dtype == np.uint8:
        def fixed(f):
            one = np.float32(2048)
            return (np.rint((np.float32(1) - f) * one).astype(np.int64),
                    np.rint(f * one).astype(np.int64))
        (a0, a1), (b0, b1) = fixed(fx), fixed(fy)
        s = img.astype(np.int64)
        rows = s[:, x0] * a0[cx] + s[:, x1] * a1[cx]
        out = ((((rows[y0] >> 4) * b0[cy]) >> 16)
               + (((rows[y1] >> 4) * b1[cy]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    ft = np.float64 if img.dtype == np.float64 else np.float32
    fx, fy = fx.astype(ft), fy.astype(ft)
    s = img.astype(ft)
    rows = s[:, x0] * (1 - fx)[cx] + s[:, x1] * fx[cx]
    out = rows[y0] * (1 - fy)[cy] + rows[y1] * fy[cy]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def resize_area(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(img, size_wh, interpolation=cv2.INTER_AREA). Where
    neither axis grows, cv2's area path: integer factors as block means
    (2x2 rounding half up, as cv2 does), other shrinks by separable area
    weights. Where either axis grows, its interpolating coefficients on
    both axes (_resize_linear)."""
    w, h = int(size_wh[0]), int(size_wh[1])
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img
    if w > W or h > H:
        return _resize_linear(img, w, h)
    if W % w == 0 and H % h == 0 and np.issubdtype(img.dtype, np.integer):
        kx, ky = W // w, H // h
        s = img.astype(np.int64).reshape(h, ky, w, kx, *img.shape[2:]).sum(
            axis=(1, 3))
        area = kx * ky
        out = ((s + 2) >> 2 if area == 4
               else np.rint(s / area).astype(np.int64))
        return out.astype(img.dtype)
    x = np.asarray(img, np.float64)
    x = np.tensordot(_area_weights(H, h), x, axes=(1, 0))
    x = np.moveaxis(np.tensordot(_area_weights(W, w), x, axes=(1, 1)), 0, 1)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(x), info.min, info.max).astype(img.dtype)
    return x.astype(img.dtype)
