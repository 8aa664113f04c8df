"""SDF slice images (isdf_tpu/vis/slices.py; reference trainer.py:1558-1759).

Horizontal (up-axis) slices through the meshing grid, coloured with RdBu
through a TwoSlopeNorm centred at 0 (the port's numpy colormap of
data/sdf_util.py, equal to matplotlib's) and written as PNGs with the
reference's file names, so the figure tooling (eval/figs.py) reads them.

The card machine has neither matplotlib nor cv2, so the module carries
matplotlib's 256-entry viridis table as constants and a small rasteriser
for the camera overlay that follows cv2's rules: ``fill_poly`` is
cv2.fillPoly (edges drawn as 8-connected lines, then the scanline fill in
16.16 fixed point) and ``draw_line`` is cv2.line at thickness 1 (8-connected
Bresenham, drawn left to right). Pixels outside the image are dropped; cv2
clips a line's end points first, so the two differ only for shapes that
cross the border.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from isdf_tpu_torch.data.sdf_util import get_colormap
from isdf_tpu_torch.utils import image_io as IO

# matplotlib's viridis (_cm_listed._viridis_data): 256 RGB rows, each
# value in millionths
_VIRIDIS_MILLIONTHS = """
267004 004874 329415 268510 009605 335427 269944 014625 341379 271305
019942 347269 272594 025563 353093 273809 031497 358853 274952 037752
364543 276022 044167 370164 277018 050344 375715 277941 056324 381191
278791 062145 386592 279566 067836 391917 280267 073417 397163 280894
078907 402329 281446 084320 407414 281924 089666 412415 282327 094955
417331 282656 100196 422160 282910 105393 426902 283091 110553 431554
283197 115680 436115 283229 120777 440584 283187 125848 444960 283072
130895 449241 282884 135920 453427 282623 140926 457517 282290 145912
461510 281887 150881 465405 281412 155834 469201 280868 160771 472899
280255 165693 476498 279574 170599 479997 278826 175490 483397 278012
180367 486697 277134 185228 489898 276194 190074 493001 275191 194905
496005 274128 199721 498911 273006 204520 501721 271828 209303 504434
270595 214069 507052 269308 218818 509577 267968 223549 512008 266580
228262 514349 265145 232956 516599 263663 237631 518762 262138 242286
520837 260571 246922 522828 258965 251537 524736 257322 256130 526563
255645 260703 528312 253935 265254 529983 252194 269783 531579 250425
274290 533103 248629 278775 534556 246811 283237 535941 244972 287675
537260 243113 292092 538516 241237 296485 539709 239346 300855 540844
237441 305202 541921 235526 309527 542944 233603 313828 543914 231674
318106 544834 229739 322361 545706 227802 326594 546532 225863 330805
547314 223925 334994 548053 221989 339161 548752 220057 343307 549413
218130 347432 550038 216210 351535 550627 214298 355619 551184 212395
359683 551710 210503 363727 552206 208623 367752 552675 206756 371758
553117 204903 375746 553533 203063 379716 553925 201239 383670 554294
199430 387607 554642 197636 391528 554969 195860 395433 555276 194100
399323 555565 192357 403199 555836 190631 407061 556089 188923 410910
556326 187231 414746 556547 185556 418570 556753 183898 422383 556944
182256 426184 557120 180629 429975 557282 179019 433756 557430 177423
437527 557565 175841 441290 557685 174274 445044 557792 172719 448791
557885 171176 452530 557965 169646 456262 558030 168126 459988 558082
166617 463708 558119 165117 467423 558141 163625 471133 558148 162142
474838 558140 160665 478540 558115 159194 482237 558073 157729 485932
558013 156270 489624 557936 154815 493313 557840 153364 497000 557724
151918 500685 557587 150476 504369 557430 149039 508051 557250 147607
511733 557049 146180 515413 556823 144759 519093 556572 143343 522773
556295 141935 526453 555991 140536 530132 555659 139147 533812 555298
137770 537492 554906 136408 541173 554483 135066 544853 554029 133743
548535 553541 132444 552216 553018 131172 555899 552459 129933 559582
551864 128729 563265 551229 127568 566949 550556 126453 570633 549841
125394 574318 549086 124395 578002 548287 123463 581687 547445 122606
585371 546557 121831 589055 545623 121148 592739 544641 120565 596422
543611 120092 600104 542530 119738 603785 541400 119512 607464 540218
119423 611141 538982 119483 614817 537692 119699 618490 536347 120081
622161 534946 120638 625828 533488 121380 629492 531973 122312 633153
530398 123444 636809 528763 124780 640461 527068 126326 644107 525311
128087 647749 523491 130067 651384 521608 132268 655014 519661 134692
658636 517649 137339 662252 515571 140210 665859 513427 143303 669459
511215 146616 673050 508936 150148 676631 506589 153894 680203 504172
157851 683765 501686 162016 687316 499129 166383 690856 496502 170948
694384 493803 175707 697900 491033 180653 701402 488189 185783 704891
485273 191090 708366 482284 196571 711827 479221 202219 715272 476084
208030 718701 472873 214000 722114 469588 220124 725509 466226 226397
728888 462789 232815 732247 459277 239374 735588 455688 246070 738910
452024 252899 742211 448284 259857 745492 444467 266941 748751 440573
274149 751988 436601 281477 755203 432552 288921 758394 428426 296479
761561 424223 304148 764704 419943 311925 767822 415586 319809 770914
411152 327796 773980 406640 335885 777018 402049 344074 780029 397381
352360 783011 392636 360741 785964 387814 369214 788888 382914 377779
791781 377939 386433 794644 372886 395174 797475 367757 404001 800275
362552 412913 803041 357269 421908 805774 351910 430983 808473 346476
440137 811138 340967 449368 813768 335384 458674 816363 329727 468053
818921 323998 477504 821444 318195 487026 823929 312321 496615 826376
306377 506271 828786 300362 515992 831158 294279 525776 833491 288127
535621 835785 281908 545524 838039 275626 555484 840254 269281 565498
842430 262877 575563 844566 256415 585678 846661 249897 595839 848717
243329 606045 850733 236712 616293 852709 230052 626579 854645 223353
636902 856542 216620 647257 858400 209861 657642 860219 203082 668054
861999 196293 678489 863742 189503 688944 865448 182725 699415 867117
175971 709898 868751 169257 720391 870350 162603 730889 871916 156029
741388 873449 149561 751884 874951 143228 762373 876424 137064 772852
877868 131109 783315 879285 125405 793760 880678 120005 804182 882046
114965 814576 883393 110347 824940 884720 106217 835270 886029 102646
845561 887322 099702 855810 888601 097452 866013 889868 095953 876168
891125 095250 886271 892374 095374 896320 893616 096335 906311 894855
098125 916242 896091 100717 926106 897330 104071 935904 898570 108131
945636 899815 112838 955300 901065 118128 964894 902323 123941 974417
903590 130215 983868 904867 136897 993248 906157 143936
"""
VIRIDIS = (np.array(_VIRIDIS_MILLIONTHS.split(), np.float64) / 1e6
           ).reshape(256, 3)

_XY_SHIFT = 16


def sdf_colormap(sdf: np.ndarray, sdf_range=(-2.0, 2.0)) -> np.ndarray:
    """RGB uint8 of SDF values: RdBu through TwoSlopeNorm(vmin, 0, vmax),
    as isdf_tpu colours them with matplotlib (its slices.py:21-33); NaN
    is black."""
    rgba = get_colormap(sdf_range, surface_cutoff=0.0).to_rgba(
        np.asarray(sdf))
    return (rgba[..., :3] * 255).astype(np.uint8)


def viridis(x: np.ndarray) -> np.ndarray:
    """RGB float of values in [0, 1] through the 256-entry table, as a
    matplotlib ListedColormap indexes it (NaN is black)."""
    xa = np.asarray(x, np.float64) * 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        ix = np.clip(np.where(bad, 0, xa), 0, 255).astype(int)
    out = VIRIDIS[ix]
    out[bad] = 0.0
    return out


def _put(im: np.ndarray, xs, ys, color):
    xs, ys = np.asarray(xs), np.asarray(ys)
    ok = (xs >= 0) & (xs < im.shape[1]) & (ys >= 0) & (ys < im.shape[0])
    im[ys[ok], xs[ok]] = color


def _line_pixels(p0, p1):
    """Pixels of cv2's 8-connected line from p0 to p1 ((x, y) ints):
    LineIterator with leftToRight, err = dx - 2 dy, a minor step where
    err < 0."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    xs, ys = [], []
    x, y = x0, y0
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += int(minor)
        else:
            x += 1
            y += sy if minor else 0
    return xs, ys


def draw_line(im: np.ndarray, p0, p1, color) -> np.ndarray:
    """cv2.line(im, p0, p1, color, 1) in place; p0, p1 are (x, y)."""
    _put(im, *_line_pixels(p0, p1), color)
    return im


def fill_poly(im: np.ndarray, pts: np.ndarray, color) -> np.ndarray:
    """cv2.fillPoly(im, [pts], color) for one convex polygon of int (x, y)
    vertices, in place: each edge drawn as a line, then every row from
    the top vertex down to (not including) the bottom one filled from the
    first pixel at or right of its left edge to the last at or left of its
    right edge, the edges' x run in 16.16 fixed point with a truncated
    slope (CollectPolyEdges and FillEdgeCollection of OpenCV's
    drawing.cpp)."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(pts)
    ceil = (1 << _XY_SHIFT) - 1
    edges = []
    for i in range(n):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        draw_line(im, (x0, y0), (x1, y1), color)
        if y0 == y1:
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        num, den = (int(x1) - int(x0)) << _XY_SHIFT, int(y1 - y0)
        dxf = abs(num) // den * (1 if num >= 0 else -1)  # C's truncation
        edges.append((int(y0), int(y1), int(x0) << _XY_SHIFT, dxf))
    if len(edges) < 2:
        return im
    h, w = im.shape[:2]
    y_top = min(e[0] for e in edges)
    y_end = min(max(e[1] for e in edges), h)
    for y in range(max(y_top, 0), y_end):
        xs = sorted(x + (y - y0) * dxf for y0, y1, x, dxf in edges
                    if y0 <= y < y1)
        for a, b in zip(xs[0::2], xs[1::2]):
            x1, x2 = (a + ceil) >> _XY_SHIFT, b >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                im[y, max(x1, 0):min(x2, w - 1) + 1] = color
    return im


def to_topdown(trainer, pts: np.ndarray, im_size) -> np.ndarray:
    """World points -> top-down slice pixel coords (reference
    trainer.py:1761-1773)."""
    up_ix = getattr(trainer, "up_ix", 1)
    homog = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1)
    td = (homog @ trainer.inv_bounds_transform_np.T)[:, :3] \
        / trainer.scene_scale_np
    td = td / 2 + 0.5
    td = np.concatenate([td[:, :up_ix], td[:, up_ix + 1:]], axis=1)
    return (td * np.asarray(im_size)).astype(int)


def draw_agent(im: np.ndarray, pos_px, rotation: float = 0.0,
               radius_px: int = 8):
    """Triangle agent marker (reference visualisation/draw.py:13-136)."""
    c, s = np.cos(rotation), np.sin(rotation)
    R = np.array([[c, -s], [s, c]])
    tri = np.array([[0, -1.2], [0.8, 0.9], [-0.8, 0.9]]) * radius_px
    tri = (tri @ R.T + np.asarray(pos_px)[::-1]).astype(np.int32)
    return fill_poly(im, tri, (220, 30, 30))


def draw_cams_on_slices(trainer, slice_imgs: List[np.ndarray]):
    """Overlay the trajectory and camera markers on each slice (reference
    trainer.py:1673-1705)."""
    if len(trainer.frames) == 0:
        return slice_imgs
    T = np.stack([f.T_WC for f in trainer.frames.frames])
    im_size = slice_imgs[0].shape[:2][::-1]
    cam_td = to_topdown(trainer, T[:, :3, 3], im_size)
    angs = [float(np.arctan2(r[0, 2], r[0, 0])) for r in T[:, :3, :3]]
    out = []
    for im in slice_imgs:
        im = np.ascontiguousarray(im)
        for j in range(len(cam_td) - 1):
            if not (cam_td[j] == cam_td[j + 1]).all():
                draw_line(im, cam_td[j][::-1], cam_td[j + 1][::-1],
                          (255, 0, 0))
        for p, a in zip(cam_td, angs):
            draw_agent(im, p, rotation=a)
        out.append(im)
    return out


def slice_planes(trainer, n_slices: int) -> torch.Tensor:
    """The grid points of n_slices up-axis planes at linspace(30, dim - 30)
    of trainer.grid_pc (reference trainer.py:1564-1566), on the trainer's
    device: [dim, n_slices, dim, 3] for up axis 1."""
    dim = trainer.grid_dim
    up_ix = getattr(trainer, "up_ix", 1)
    z_ixs = np.clip(np.round(np.linspace(30, dim - 30, n_slices)
                             ).astype(int), 0, dim - 1)
    grid = trainer.grid_pc.reshape(dim, dim, dim, 3)
    return grid.index_select(up_ix, torch.as_tensor(z_ixs,
                                                    device=grid.device))


def compute_slices(trainer, n_slices: int = 6, include_gt: bool = False,
                   include_diff: bool = False, draw_cams: bool = False,
                   ) -> Dict[str, List[np.ndarray]]:
    """The model's SDF on n_slices planes of the meshing grid, coloured;
    one sdf_fn query for all planes. The up axis is the grid's second (y)
    unless the trainer sets ``up_ix``."""
    up_ix = getattr(trainer, "up_ix", 1)
    pc = slice_planes(trainer, n_slices)
    shape = tuple(pc.shape[:-1])
    sdf = trainer.sdf_fn(pc.reshape(-1, 3)).reshape(shape)

    sdf_img = sdf_colormap(sdf)
    out: Dict[str, List[np.ndarray]] = {
        "pred_sdf": [np.take(sdf_img, i, axis=up_ix)
                     for i in range(n_slices)]}
    if draw_cams:
        out["pred_sdf"] = draw_cams_on_slices(trainer, out["pred_sdf"])

    if include_gt and trainer.gt_sdf_fn is not None:
        gt = np.asarray(trainer.gt_sdf_fn(
            pc.reshape(-1, 3).cpu().numpy())).reshape(shape)
        gt_img = sdf_colormap(gt)
        out["gt_sdf"] = [np.take(gt_img, i, axis=up_ix)
                         for i in range(n_slices)]
        if include_diff:
            dn = np.clip(np.abs(gt - sdf) / 0.5, 0, 1)
            dimg = (viridis(dn) * 255).astype(np.uint8)
            out["diff"] = [np.take(dimg, i, axis=up_ix)
                           for i in range(n_slices)]
    return out


def write_slices(trainer, save_path: str, prefix: str = "",
                 n_slices: int = 6, include_gt: bool = False,
                 include_diff: bool = False, draw_cams: bool = False):
    """PNGs with the reference's names (trainer.py:1709-1742):
    ``{prefix}pred_{s}.png``, ``gt_`` and ``diff_``."""
    sl = compute_slices(trainer, n_slices, include_gt, include_diff,
                        draw_cams)
    os.makedirs(save_path, exist_ok=True)
    names = {"pred_sdf": "pred", "gt_sdf": "gt", "diff": "diff"}
    for key, imgs in sl.items():
        for s, im in enumerate(imgs):
            IO.imwrite(os.path.join(save_path,
                                    f"{prefix}{names[key]}_{s}.png"),
                       im[..., ::-1])
    return sl
