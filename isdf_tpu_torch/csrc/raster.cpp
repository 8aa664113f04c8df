// Host rasteriser of the port's offscreen 3-D renders (vis/raster.py).
//
// vis/raster.py projects and orders the primitives as matplotlib's mplot3d
// does (isdf_tpu/vis/viewer.py and vis/composite.py render through it);
// this file fills them, each in turn, over an RGB image of floats in
// [0, 255], as matplotlib's Agg backend composites a path: the colour is
// blended by the fraction of each pixel the path covers. Coverage is
// analytic along x and sampled on NSUB sub-scanlines a pixel row: on each
// sub-scanline a convex piece covers one span, a path covers the union of
// its pieces' spans, and a pixel gets the length of that union inside it.
// Pixel (c, r) is the square [c, c + 1] x [r, r + 1] in image coordinates
// (x right, y down). Primitives with a non-finite coordinate are skipped
// (matplotlib's masked points).
//
// Built with g++ at first use by utils/native.py; plain C interface.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int NSUB = 16;

using Span = std::pair<double, double>;

struct Cover {
    // coverage of the pixels [x0, x1) x [y0, y1), and the spans of each
    // sub-scanline of those rows
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<float> a;
    std::vector<std::vector<Span>> spans;

    bool reset(double bx0, double by0, double bx1, double by1, int W, int H) {
        if (!(bx0 <= bx1) || !(by0 <= by1)) return false;
        x0 = std::max(0, (int)std::floor(bx0));
        y0 = std::max(0, (int)std::floor(by0));
        x1 = std::min(W, (int)std::floor(bx1) + 1);
        y1 = std::min(H, (int)std::floor(by1) + 1);
        if (x0 >= x1 || y0 >= y1) return false;
        a.assign((size_t)(x1 - x0) * (y1 - y0), 0.f);
        size_t n = (size_t)(y1 - y0) * NSUB;
        if (spans.size() < n) spans.resize(n);
        for (size_t i = 0; i < n; ++i) spans[i].clear();
        return true;
    }
    static double sub_y(int row, int k) { return row + (k + 0.5) / NSUB; }

    // the span [xl, xr) on sub-scanline k of pixel row `row`
    void add(int row, int k, double xl, double xr) {
        if (xr > xl) spans[(size_t)(row - y0) * NSUB + k].emplace_back(xl, xr);
    }

    // union of each sub-scanline's spans into the pixels' coverage
    void resolve() {
        const int w = x1 - x0;
        for (int row = y0; row < y1; ++row)
            for (int k = 0; k < NSUB; ++k) {
                auto &s = spans[(size_t)(row - y0) * NSUB + k];
                if (s.empty()) continue;
                if (s.size() > 1) std::sort(s.begin(), s.end());
                float *line = &a[(size_t)(row - y0) * w];
                double cl = s[0].first, cr = s[0].second;
                for (size_t i = 1; i <= s.size(); ++i) {
                    if (i < s.size() && s[i].first <= cr) {
                        cr = std::max(cr, s[i].second);
                        continue;
                    }
                    accumulate(line, cl, cr);
                    if (i < s.size()) { cl = s[i].first; cr = s[i].second; }
                }
            }
    }

    void accumulate(float *line, double xl, double xr) {
        xl = std::max(xl, (double)x0);
        xr = std::min(xr, (double)x1);
        if (xr <= xl) return;
        int ca = (int)std::floor(xl), cb = (int)std::floor(xr);
        if (cb >= x1) cb = x1 - 1;
        for (int c = ca; c <= cb; ++c) {
            double o = std::min(xr, (double)c + 1) - std::max(xl, (double)c);
            if (o > 0) line[c - x0] += (float)(o / NSUB);
        }
    }

    void composite(float *img, int W, const float *rgb) const {
        const int w = x1 - x0;
        for (int row = y0; row < y1; ++row)
            for (int c = x0; c < x1; ++c) {
                float cov = std::min(a[(size_t)(row - y0) * w + c - x0], 1.f);
                if (cov <= 0.f) continue;
                float *p = img + ((size_t)row * W + c) * 3;
                for (int ch = 0; ch < 3; ++ch) p[ch] += (rgb[ch] - p[ch]) * cov;
            }
    }
};

// spans of the convex polygon (n vertices, xy interleaved) on the rows
void convex_spans(Cover &cv, const double *p, int n) {
    double ylo = p[1], yhi = p[1];
    for (int i = 1; i < n; ++i) {
        ylo = std::min(ylo, p[2 * i + 1]);
        yhi = std::max(yhi, p[2 * i + 1]);
    }
    int ra = std::max(cv.y0, (int)std::floor(ylo));
    int rb = std::min(cv.y1 - 1, (int)std::floor(yhi));
    for (int row = ra; row <= rb; ++row)
        for (int k = 0; k < NSUB; ++k) {
            double y = Cover::sub_y(row, k);
            if (y < ylo || y >= yhi) continue;
            double xl = INFINITY, xr = -INFINITY;
            for (int i = 0; i < n; ++i) {
                const double *a = p + 2 * i, *b = p + 2 * ((i + 1) % n);
                double ya = a[1], yb = b[1];
                if (ya == yb) continue;
                if ((y < std::min(ya, yb)) || (y >= std::max(ya, yb))) continue;
                double x = a[0] + (y - ya) * (b[0] - a[0]) / (yb - ya);
                xl = std::min(xl, x);
                xr = std::max(xr, x);
            }
            if (xl < xr) cv.add(row, k, xl, xr);
        }
}

void disc_spans(Cover &cv, double cx, double cy, double r) {
    int ra = std::max(cv.y0, (int)std::floor(cy - r));
    int rb = std::min(cv.y1 - 1, (int)std::floor(cy + r));
    for (int row = ra; row <= rb; ++row)
        for (int k = 0; k < NSUB; ++k) {
            double dy = Cover::sub_y(row, k) - cy;
            if (std::fabs(dy) >= r) continue;
            double h = std::sqrt(r * r - dy * dy);
            cv.add(row, k, cx - h, cx + h);
        }
}

// A path of one convex piece (a triangle, a disc): on each sub-scanline it
// covers a single span, so no union is needed; rows are accumulated and
// composited one at a time in a buffer reused across calls.
struct ConvexFill {
    std::vector<float> line;

    template <class SpanFn>
    void fill(float *img, int H, int W, double ylo, double yhi, double xlo,
              double xhi, SpanFn span, const float *rgb) {
        if (!(ylo <= yhi) || !(xlo <= xhi)) return;
        int ra = std::max(0, (int)std::floor(ylo));
        int rb = std::min(H - 1, (int)std::floor(yhi));
        int ca = std::max(0, (int)std::floor(xlo));
        int cb = std::min(W - 1, (int)std::floor(xhi));
        if (ra > rb || ca > cb) return;
        if ((int)line.size() < W) line.assign(W, 0.f);
        for (int row = ra; row <= rb; ++row) {
            bool any = false;
            for (int k = 0; k < NSUB; ++k) {
                double xl, xr;
                if (!span(Cover::sub_y(row, k), xl, xr)) continue;
                xl = std::max(xl, (double)ca);
                xr = std::min(xr, (double)cb + 1);
                if (xr <= xl) continue;
                any = true;
                int c0 = (int)std::floor(xl), c1 = std::min((int)std::floor(xr), cb);
                if (c0 == c1) { line[c0] += (float)((xr - xl) / NSUB); continue; }
                line[c0] += (float)((c0 + 1 - xl) / NSUB);
                for (int c = c0 + 1; c < c1; ++c) line[c] += 1.f / NSUB;
                line[c1] += (float)((xr - c1) / NSUB);
            }
            if (!any) continue;
            float *p = img + (size_t)row * W * 3;
            for (int c = ca; c <= cb; ++c) {
                float cov = std::min(line[c], 1.f);
                line[c] = 0.f;
                if (cov <= 0.f) continue;
                float *q = p + 3 * c;
                for (int ch = 0; ch < 3; ++ch) q[ch] += (rgb[ch] - q[ch]) * cov;
            }
        }
    }
};

bool finite_all(const double *p, int n) {
    for (int i = 0; i < n; ++i)
        if (!std::isfinite(p[i])) return false;
    return true;
}

// the pieces of a stroked polyline: a rectangle a segment (the ends
// pushed out by half the width where `cap_start` / `cap_end`: projecting
// caps) and a disc at each inner vertex (round joins)
void stroke_spans(Cover &cv, const double *xy, long n, double hw,
                  bool cap_start, bool cap_end) {
    for (long i = 0; i + 1 < n; ++i) {
        double ax = xy[2 * i], ay = xy[2 * i + 1];
        double bx = xy[2 * i + 2], by = xy[2 * i + 3];
        double dx = bx - ax, dy = by - ay, len = std::hypot(dx, dy);
        if (len <= 0) continue;
        double ux = dx / len, uy = dy / len;
        if (cap_start && i == 0) { ax -= ux * hw; ay -= uy * hw; }
        if (cap_end && i + 2 == n) { bx += ux * hw; by += uy * hw; }
        double nx = -uy * hw, ny = ux * hw;
        double q[8] = {ax + nx, ay + ny, bx + nx, by + ny,
                       bx - nx, by - ny, ax - nx, ay - ny};
        convex_spans(cv, q, 4);
    }
    for (long i = 1; i + 1 < n; ++i) disc_spans(cv, xy[2 * i], xy[2 * i + 1], hw);
}

}  // namespace

extern "C" {

// the triangles whose rows meet [r0, r1), in order (one band of the image)
static void tris_band(float *img, int H, int W, const double *xy,
                      const int64_t *faces, const int64_t *order,
                      const float *rgb, long n, int r0, int r1) {
    ConvexFill cf;
    for (long j = 0; j < n; ++j) {
        const long i = order[j];
        const int64_t *f = faces + 3 * i;
        const double p[6] = {xy[2 * f[0]], xy[2 * f[0] + 1], xy[2 * f[1]],
                             xy[2 * f[1] + 1], xy[2 * f[2]], xy[2 * f[2] + 1]};
        if (!finite_all(p, 6)) continue;
        double bx0 = std::min({p[0], p[2], p[4]}), bx1 = std::max({p[0], p[2], p[4]});
        double by0 = std::min({p[1], p[3], p[5]}), by1 = std::max({p[1], p[3], p[5]});
        if (by1 < r0 || by0 >= r1) continue;
        auto span = [p](double y, double &xl, double &xr) {
            xl = INFINITY;
            xr = -INFINITY;
            for (int e = 0; e < 3; ++e) {
                const double *a = p + 2 * e, *b = p + 2 * ((e + 1) % 3);
                double ya = a[1], yb = b[1];
                if (ya == yb || y < std::min(ya, yb) || y >= std::max(ya, yb))
                    continue;
                double x = a[0] + (y - ya) * (b[0] - a[0]) / (yb - ya);
                xl = std::min(xl, x);
                xr = std::max(xr, x);
            }
            return xl < xr;
        };
        cf.fill(img, H, W, std::max(by0, (double)r0),
                std::min(by1, std::nextafter((double)r1, 0.0)), bx0, bx1,
                span, rgb + 3 * i);
    }
}

// Filled triangles, each its own path: face order[j] is drawn j-th. xy
// [V, 2] image coordinates of the vertices, faces [F, 3] vertex indices,
// rgb [F, 3] in [0, 255], n the length of order. The image is cut into
// bands of rows, one thread a band: each pixel still sees every triangle
// in order, so the result does not depend on the number of threads.
void raster_tris(float *img, int H, int W, const double *xy,
                 const int64_t *faces, const int64_t *order,
                 const float *rgb, long n) {
    int nt = (int)std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()), 8u);
    if (n < 4096 || H < 2 * nt) nt = 1;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) {
        int r0 = (int)((long)H * t / nt), r1 = (int)((long)H * (t + 1) / nt);
        pool.emplace_back(tris_band, img, H, W, xy, faces, order, rgb, n,
                          r0, r1);
    }
    for (auto &th : pool) th.join();
}

// Discs of one radius (scatter markers 'o'), each its own path, in the
// order given. xy [n, 2]; rgb [n, 3].
void raster_discs(float *img, int H, int W, const double *xy,
                  const float *rgb, long n, double radius) {
    ConvexFill cf;
    const double r = radius;
    for (long i = 0; i < n; ++i) {
        const double *p = xy + 2 * i;
        if (!finite_all(p, 2)) continue;
        const double cx = p[0], cy = p[1];
        auto span = [cx, cy, r](double y, double &xl, double &xr) {
            double dy = y - cy;
            if (std::fabs(dy) >= r) return false;
            double h = std::sqrt(r * r - dy * dy);
            xl = cx - h;
            xr = cx + h;
            return true;
        };
        cf.fill(img, H, W, cy - r, cy + r, cx - r, cx + r, span, rgb + 3 * i);
    }
}

// One stroked polyline as one path: xy [n, 2], width in pixels, round
// joins; cap 1 projecting, 0 butt. A non-finite vertex breaks the line.
void raster_polyline(float *img, int H, int W, const double *xy, long n,
                     double width, const float *rgb, int cap) {
    const double hw = width / 2;
    Cover cv;
    double bx0 = INFINITY, by0 = INFINITY, bx1 = -INFINITY, by1 = -INFINITY;
    for (long i = 0; i < n; ++i) {
        if (!finite_all(xy + 2 * i, 2)) continue;
        bx0 = std::min(bx0, xy[2 * i]); bx1 = std::max(bx1, xy[2 * i]);
        by0 = std::min(by0, xy[2 * i + 1]); by1 = std::max(by1, xy[2 * i + 1]);
    }
    if (!cv.reset(bx0 - width, by0 - width, bx1 + width, by1 + width, W, H))
        return;
    long s = 0;
    while (s < n) {
        while (s < n && !finite_all(xy + 2 * s, 2)) ++s;
        long e = s;
        while (e < n && finite_all(xy + 2 * e, 2)) ++e;
        if (e - s >= 2) stroke_spans(cv, xy + 2 * s, e - s, hw, cap == 1, cap == 1);
        s = e;
    }
    cv.resolve();
    cv.composite(img, W, rgb);
}

// Segments, each its own path with butt caps (a line collection):
// xy [n, 2, 2]; one colour and width.
void raster_segments(float *img, int H, int W, const double *xy, long n,
                     double width, const float *rgb) {
    for (long i = 0; i < n; ++i) {
        const double *p = xy + 4 * i;
        if (!finite_all(p, 4)) continue;
        raster_polyline(img, H, W, p, 2, width, rgb, 0);
    }
}

}  // extern "C"
