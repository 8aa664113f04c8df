"""The port's image codec (utils/image_io.py + csrc/image_codec.cpp) and
depth undistortion against cv2 and isdf_tpu, on the CPU.

* PNG: cv2-written uint16 and RGB files read exactly; hand-built files
  with each of the five row filters read exactly; round trips exact.
* JPEG: cv2-written files (quality 95, 4:2:0, 4:4:4, 4:2:2, restart
  markers, greyscale) decode within max 4 / mean 0.5 levels of
  cv2.imread; cv2 reads the port's files (quality 95, 4:2:0) within mean
  2 levels of the source; the standard tables equal the ones cv2 writes;
  oversubscribed and all-ones Huffman tables raise.
* A codec whose native library did not build raises RuntimeError.
* DepthTransform equals isdf_tpu's (with cv2) exactly on realsense.json's
  camera; INTER_AREA resizing equals cv2's at integer factors.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.utils import native

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(H=48, W=64, seed=0, patches=True):
    """A colour gradient with sensor noise and (``patches``) two saturated
    flat patches with sharp edges, BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([60 + 2.5 * xx, 40 + 3.0 * yy,
                    200 - 1.5 * (xx + yy) / 2], -1)
    if patches:
        img[H // 5:H // 2, W // 4:W // 2] = [30, 200, 90]
        img[H // 2:, W // 2:] = [220, 40, 140]
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def test_png_reads_cv2_files_exactly(tmp_path):
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    depth[10:20] = 0
    img = _image()
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "g.png"), img[..., 1])
    got = IO.imread(str(tmp_path / "d.png"), IO.IMREAD_UNCHANGED)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "d.png"),
                                                  -1))
    for name in ("c.png", "g.png", "d.png"):
        for flags in (IO.IMREAD_COLOR, IO.IMREAD_UNCHANGED):
            np.testing.assert_array_equal(
                IO.imread(str(tmp_path / name), flags),
                cv2.imread(str(tmp_path / name), flags))


def _filter_row(row, prev, ft, bpp):
    """PNG's encoder side of filter ``ft`` for one row (ints)."""
    out = []
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((row[x] - pred) & 255)
    return out


def _png_with_filters(img, depth, ctype):
    """A PNG whose rows cycle through the five filter types."""
    h, w = img.shape[:2]
    if depth == 16:
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        rows = img.reshape(h, -1)
    bpp = rows.shape[1] // w
    raw, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        ft = y % 5
        row = [int(v) for v in rows[y]]
        raw += bytes([ft] + _filter_row(row, prev, ft, bpp))
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey16"])
def test_png_all_five_filters(tmp_path, kind):
    rng = np.random.default_rng(2)
    if kind == "grey16":
        img = rng.integers(0, 65535, (12, 17)).astype(np.uint16)
        data = _png_with_filters(img, 16, 0)
    else:
        ch = 3 if kind == "rgb8" else 4
        img = rng.integers(0, 255, (12, 17, ch)).astype(np.uint8)
        data = _png_with_filters(img, 8, 2 if ch == 3 else 6)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = IO.imread(str(path), IO.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want)
    if kind != "grey16":
        np.testing.assert_array_equal(got[..., :3], img[..., 2::-1])


def test_png_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 65535, (30, 41)).astype(np.uint16),
                rng.integers(0, 255, (30, 41, 3)).astype(np.uint8),
                rng.integers(0, 255, (30, 41)).astype(np.uint8)):
        path = str(tmp_path / "r.png")
        IO.write_png(path, img)
        np.testing.assert_array_equal(IO.imread(path, IO.IMREAD_UNCHANGED),
                                      img)
        np.testing.assert_array_equal(cv2.imread(path, -1), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    rgb16 = np.zeros((4, 5, 3), np.uint16)
    cv2.imwrite(str(tmp_path / "c16.png"), rgb16)
    with pytest.raises(ValueError, match="16-bit colour"):
        IO.imread(str(tmp_path / "c16.png"), IO.IMREAD_UNCHANGED)
    with pytest.raises(ValueError, match="16-bit colour"):
        IO.encode_png(rgb16)
    good = IO.encode_png(np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError):
        IO.imdecode(good[:-20])


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

JPEG_CASES = {
    "420": [cv2.IMWRITE_JPEG_QUALITY, 95],
    "444": [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "restart": [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL,
                3],
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_jpeg_decodes_cv2_files(tmp_path, case, shape):
    img = _image(*shape)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img, JPEG_CASES[case])
    want = cv2.imread(path).astype(int)
    got = IO.imread(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 4 and d.mean() <= 0.5, (d.max(), d.mean())


def test_jpeg_greyscale_and_imdecode(tmp_path):
    img = _image()[..., 1]
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, img)
    got = IO.imread(path, IO.IMREAD_UNCHANGED)
    assert got.shape == img.shape
    d = np.abs(got.astype(int) - cv2.imread(path, -1))
    assert d.max() <= 4 and d.mean() <= 0.5
    with open(path, "rb") as f:
        buf = f.read()
    np.testing.assert_array_equal(IO.imdecode(buf), IO.imread(path))
    np.testing.assert_array_equal(IO.imdecode(IO.encode_png(_image())),
                                  _image())


def test_cv2_reads_the_port_jpeg(tmp_path):
    """On a smooth image cv2 reads the port's file within mean 2 levels of
    the source; on one with saturated colour patches (where 4:2:0 costs
    cv2's own encoder 3.4 levels) the port's error is within 5% of the
    error of cv2's encoder at the same settings (its defaults: quality 95,
    4:2:0)."""
    for img, smooth in ((_image(patches=False), True), (_image(), False)):
        path = str(tmp_path / "w.jpg")
        IO.write_jpeg(path, img)
        back = cv2.imread(path)
        assert back.shape == img.shape
        err = np.abs(back.astype(int) - img).mean()
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        theirs = np.abs(cv2.imdecode(buf, 1).astype(int) - img).mean()
        assert err <= 1.05 * theirs, (err, theirs)
        if smooth:
            assert err <= 2.0, err
        # and the port reads its own file as cv2 does
        d = np.abs(IO.imread(path).astype(int) - back)
        assert d.max() <= 4 and d.mean() <= 0.5
    grey = img[..., 0]
    IO.imwrite(str(tmp_path / "g.jpg"), grey)
    back = cv2.imread(str(tmp_path / "g.jpg"), -1)
    assert back.shape == grey.shape
    assert np.abs(back.astype(int) - grey).mean() <= 2.0


def _segments(data):
    pos, out = 2, []
    while pos < len(data):
        m = data[pos + 1]
        pos += 2
        if m == 0xDA:
            break
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        out.append((m, data[pos + 2:pos + n]))
        pos += n
    return out


def test_standard_tables_equal_cv2s(tmp_path):
    """The quantisation (libjpeg's scaling at quality 95) and Huffman tables
    of the port's files are the ones cv2 writes."""
    img = _image()
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    theirs = _segments(buf.tobytes())
    ours = _segments(IO.encode_jpeg(img))
    for marker in (0xDB, 0xC4, 0xC0):
        a = b"".join(s for m, s in theirs if m == marker)
        b = b"".join(s for m, s in ours if m == marker)
        assert a == b, hex(marker)


def test_jpeg_rejects_progressive(tmp_path):
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, _image(), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        IO.imread(path)


@pytest.mark.parametrize("table,bits0", [(0x00, 3), (0x11, 3), (0x00, 2)],
                         ids=["oversubscribed_dc_luma",
                              "oversubscribed_ac_chroma", "all_ones"])
def test_jpeg_rejects_bad_huffman_tables(table, bits0):
    """A DHT segment whose table (luma DC, or chroma AC, the last one the
    decoder builds) holds three codes of length 1, more than the length
    holds, or two, the second all ones, raises ValueError before any table
    entry is written."""
    data = IO.encode_jpeg(_image())
    i = data.index(b"\xff\xc4")
    while data[i + 4] != table:
        i = data.index(b"\xff\xc4", i + 2)
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    body = bytes([table, bits0] + [0] * 15) + bytes(range(bits0))
    bad = (data[:i] + b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body
           + data[i + 2 + n:])
    with pytest.raises(ValueError, match="Huffman|corrupt"):
        IO.imdecode(bad)


@pytest.mark.parametrize("call", ["png_read", "jpeg_read", "jpeg_write"])
def test_codec_without_its_library_raises(tmp_path, monkeypatch, call):
    """Where csrc/image_codec.cpp did not build, a read or write raises
    RuntimeError naming the source, as the rasterisers do."""
    img = _image()
    path = str(tmp_path / ("a.png" if call == "png_read" else "a.jpg"))
    cv2.imwrite(path, img)
    monkeypatch.setattr(native, "load", lambda name: None)
    with pytest.raises(RuntimeError, match=r"csrc/image_codec\.cpp"):
        if call == "jpeg_write":
            IO.encode_jpeg(img)
        else:
            IO.imread(path)


# ---------------------------------------------------------------------------
# undistortion and resizing
# ---------------------------------------------------------------------------

def test_depth_transform_equals_isdf_tpu_with_cv2():
    from isdf_tpu.data.datasets import DepthTransform as JDT
    from isdf_tpu_torch.data.datasets import DepthTransform as TDT
    from isdf_tpu_torch.data.datasets import undistort_maps
    with open(os.path.join(ROOT, "isdf_tpu", "train", "configs",
                           "realsense.json")) as f:
        cam = json.load(f)["dataset"]["camera"]
    K = [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]]
    dist = [cam[k] for k in ("k1", "k2", "p1", "p2", "k3")]
    mx, my = cv2.initUndistortRectifyMap(
        np.asarray(K), np.asarray(dist), None, np.asarray(K),
        (cam["w"], cam["h"]), cv2.CV_32FC1)
    ax, ay = undistort_maps(K, dist, cam["w"], cam["h"])
    np.testing.assert_array_equal(ax, mx)
    np.testing.assert_array_equal(ay, my)
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 6000, (cam["h"], cam["w"])).astype(np.uint16)
    j = JDT(1e-3, 3.0, camera_matrix=K, distortion=dist)
    t = TDT(1e-3, 3.0, camera_matrix=K, distortion=dist)
    assert j.maps is None and t.maps is None
    want = j(depth)
    assert j.maps is not None        # cv2 ran: undistortion was applied
    np.testing.assert_array_equal(t(depth), want)
    np.testing.assert_array_equal(TDT(1e-3, 3.0)(depth), JDT(1e-3, 3.0)(depth))


@pytest.mark.parametrize("src,wh", [((30, 40, 3), (80, 60)),
                                    ((60, 80), (20, 15)),
                                    ((60, 80, 3), (40, 30))])
def test_resize_area_equals_cv2_at_integer_factors(src, wh):
    rng = np.random.default_rng(6)
    for dt in (np.uint8, np.uint16, np.float32):
        a = rng.integers(0, 255, src).astype(dt)
        np.testing.assert_array_equal(
            IO.resize_area(a, wh), cv2.resize(a, wh,
                                              interpolation=cv2.INTER_AREA))


def test_port_sources_import_no_cv2_pil_or_matplotlib():
    pkg = os.path.join(ROOT, "isdf_tpu_torch")
    bad = []
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    for i, line in enumerate(fh):
                        s = line.strip()
                        if s.startswith(("import ", "from ")) and any(
                                m in s.split()[1].split(".")[0]
                                for m in ("cv2", "PIL", "matplotlib")):
                            bad.append(f"{f}:{i + 1}")
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        src = fh.read()
    assert not bad and "import cv2" not in src, bad
