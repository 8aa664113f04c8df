// Host rasteriser of the port's 2-D figures (vis/plot.py).
//
// vis/plot.py lays a figure out as matplotlib's Agg backend does and hands
// each path here in turn: filled rings (areas, patches, glyph outlines:
// exact signed-area coverage, as Agg's rasteriser computes it) or stroked
// polylines (a quad a segment, butt or projecting caps, round or square
// joins: coverage exact along x and sampled on NSUB sub-scanlines a pixel
// row, the pieces' spans merged on each sub-scanline so that no pixel is
// counted twice). The colour is then blended over an RGB image of whole
// levels in [0, 255] with Agg's integer arithmetic (8-bit cover and alpha,
// matplotlib's plain-RGBA blender). Pixel (c, r) is the square
// [c, c + 1] x [r, r + 1] in image coordinates (x right, y down). `clip`
// is the integer pixel box [x0, y0, x1, y1) outside which nothing is drawn
// (Agg's clip box).
//
// Built with g++ at first use by utils/native.py; plain C interface.

#include <algorithm>
#include <cmath>
#include <utility>
#include <vector>

namespace {

constexpr int NSUB = 16;
using Span = std::pair<double, double>;

struct Cover {
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<float> a;
    std::vector<std::vector<Span>> spans;

    bool reset(double bx0, double by0, double bx1, double by1, const int *clip) {
        if (!(bx0 <= bx1) || !(by0 <= by1)) return false;
        x0 = std::max(clip[0], (int)std::floor(bx0));
        y0 = std::max(clip[1], (int)std::floor(by0));
        x1 = std::min(clip[2], (int)std::floor(bx1) + 1);
        y1 = std::min(clip[3], (int)std::floor(by1) + 1);
        if (x0 >= x1 || y0 >= y1) return false;
        a.assign((size_t)(x1 - x0) * (y1 - y0), 0.f);
        spans.assign((size_t)(y1 - y0) * NSUB, {});
        return true;
    }
    static double sub_y(int row, int k) { return row + (k + 0.5) / NSUB; }
    void add(int row, int k, double xl, double xr) {
        if (row < y0 || row >= y1) return;
        if (xr > xl) spans[(size_t)(row - y0) * NSUB + k].emplace_back(xl, xr);
    }
    void accumulate(float *line, double xl, double xr) {
        xl = std::max(xl, (double)x0);
        xr = std::min(xr, (double)x1);
        if (xr <= xl) return;
        int ca = (int)std::floor(xl), cb = std::min((int)std::floor(xr), x1 - 1);
        for (int c = ca; c <= cb; ++c) {
            double o = std::min(xr, (double)c + 1) - std::max(xl, (double)c);
            if (o > 0) line[c - x0] += (float)(o / NSUB);
        }
    }
    void resolve() {
        const int w = x1 - x0;
        for (int row = y0; row < y1; ++row)
            for (int k = 0; k < NSUB; ++k) {
                auto &s = spans[(size_t)(row - y0) * NSUB + k];
                if (s.empty()) continue;
                std::sort(s.begin(), s.end());
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
    // Agg's integer blend over an opaque pixel: the cover as 8 bits
    // (floor(coverage * 256), at most 255), times the colour's 8-bit alpha
    // (rgba8::multiply), then matplotlib's fixed_blender_rgba_plain.
    void composite(float *img, int W, const float *rgb, double alpha) const {
        const int w = x1 - x0;
        const int a8 = (int)std::lround(alpha * 255.0);
        int c8[3];
        for (int ch = 0; ch < 3; ++ch) c8[ch] = (int)std::lround(rgb[ch]);
        for (int row = y0; row < y1; ++row)
            for (int c = x0; c < x1; ++c) {
                float cov = a[(size_t)(row - y0) * w + c - x0];
                int cover = std::min(255, (int)std::floor(cov * 256.0f));
                if (cover <= 0) continue;
                int t = a8 * cover + 128;
                int al = ((t >> 8) + t) >> 8;
                if (al == 0) continue;
                float *p = img + ((size_t)row * W + c) * 3;
                const long den = 255L * 256 + al;
                for (int ch = 0; ch < 3; ++ch) {
                    long r = (long)std::lround(p[ch]) * 255;
                    p[ch] = (float)((((long)c8[ch] << 8) - r) * al + (r << 8)) / den;
                    p[ch] = std::floor(p[ch]);
                }
            }
    }
};

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
                if (y < std::min(ya, yb) || y >= std::max(ya, yb)) continue;
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

bool bounds(const double *xy, long n, double pad, double b[4]) {
    b[0] = b[1] = INFINITY;
    b[2] = b[3] = -INFINITY;
    for (long i = 0; i < n; ++i) {
        double x = xy[2 * i], y = xy[2 * i + 1];
        if (!std::isfinite(x) || !std::isfinite(y)) continue;
        b[0] = std::min(b[0], x); b[2] = std::max(b[2], x);
        b[1] = std::min(b[1], y); b[3] = std::max(b[3], y);
    }
    b[0] -= pad; b[1] -= pad; b[2] += pad; b[3] += pad;
    return b[0] <= b[2];
}

}  // namespace

extern "C" {

// Rings (offs[i]..offs[i+1] of xy [*, 2], each closed implicitly) filled as
// one path by the nonzero rule as Agg's scanline rasteriser applies it: each
// edge adds its signed area to the cells it crosses, a row's running sum is
// the winding-weighted coverage, and a pixel gets its absolute value, at
// most 1. The areas are exact (not sampled).
void plot_fill(float *img, int H, int W, const double *xy, const long *offs,
               long n_rings, const float *rgb, double alpha, const int *clip) {
    (void)H;
    const long n = offs[n_rings];
    double b[4];
    Cover cv;
    if (!bounds(xy, n, 0.0, b) || !cv.reset(b[0], b[1], b[2], b[3], clip)) return;
    const int w = cv.x1 - cv.x0, h = cv.y1 - cv.y0;
    std::vector<double> acc((size_t)h * (w + 2), 0.0);
    const double xlo = cv.x0, xhi = cv.x1;
    auto line = [&](double ax, double ay, double bx, double by) {
        if (ay == by) return;
        double dir = 1.0;
        if (ay > by) { std::swap(ax, bx); std::swap(ay, by); dir = -1.0; }
        const double dxdy = (bx - ax) / (by - ay);
        int r0 = std::max(cv.y0, (int)std::floor(ay));
        int r1 = std::min(cv.y1, (int)std::ceil(by));
        for (int row = r0; row < r1; ++row) {
            double ya = std::max((double)row, ay), yb = std::min((double)row + 1, by);
            if (yb <= ya) continue;
            double xa = ax + (ya - ay) * dxdy, xb = ax + (yb - ay) * dxdy;
            xa = std::min(std::max(xa, xlo), xhi) - xlo;
            xb = std::min(std::max(xb, xlo), xhi) - xlo;
            double *a = &acc[(size_t)(row - cv.y0) * (w + 2)];
            const double d = (yb - ya) * dir;
            double x0 = std::min(xa, xb), x1 = std::max(xa, xb);
            double x0f = std::floor(x0);
            int x0i = (int)x0f, x1i = (int)std::ceil(x1);
            if (x1i <= x0i + 1) {
                double xmf = 0.5 * (xa + xb) - x0f;
                a[x0i] += d - d * xmf;
                a[x0i + 1] += d * xmf;
            } else {
                double sc = 1.0 / (x1 - x0);
                double fx0 = x0 - x0f;
                double a0 = 0.5 * sc * (1.0 - fx0) * (1.0 - fx0);
                double fx1 = x1 - x1i + 1.0;
                double am = 0.5 * sc * fx1 * fx1;
                a[x0i] += d * a0;
                if (x1i == x0i + 2) {
                    a[x0i + 1] += d * (1.0 - a0 - am);
                } else {
                    double a1 = sc * (1.5 - fx0);
                    a[x0i + 1] += d * (a1 - a0);
                    for (int xi = x0i + 2; xi < x1i - 1; ++xi) a[xi] += d * sc;
                    double a2 = a1 + (x1i - x0i - 3) * sc;
                    a[x1i - 1] += d * (1.0 - a2 - am);
                }
                a[x1i] += d * am;
            }
        }
    };
    for (long r = 0; r < n_rings; ++r) {
        const long s = offs[r], e = offs[r + 1];
        for (long i = s; i < e; ++i) {
            const double *p = xy + 2 * i, *q = xy + 2 * (i + 1 < e ? i + 1 : s);
            if (!std::isfinite(p[0] + p[1] + q[0] + q[1])) continue;
            line(p[0], p[1], q[0], q[1]);
        }
    }
    for (int row = 0; row < h; ++row) {
        double run = 0.0;
        const double *a = &acc[(size_t)row * (w + 2)];
        float *out = &cv.a[(size_t)row * w];
        for (int c = 0; c < w; ++c) {
            run += a[c];
            out[c] = (float)std::min(1.0, std::fabs(run));
        }
    }
    cv.composite(img, W, rgb, alpha);
}

// Polylines (offs[i]..offs[i+1] of xy) stroked as one path, `width` pixels
// wide. cap: 0 butt, 1 projecting; join: 0 square (each segment
// pushed out by half the width at its joined ends: the miter of a right
// angle), 1 round. A non-finite vertex breaks its line.
void plot_stroke(float *img, int H, int W, const double *xy, const long *offs,
                 long n_lines, double width, const float *rgb, double alpha,
                 int cap, int join, const int *clip) {
    (void)H;
    const double hw = width / 2;
    const long n = offs[n_lines];
    double b[4];
    Cover cv;
    if (!bounds(xy, n, width, b) || !cv.reset(b[0], b[1], b[2], b[3], clip)) return;
    for (long l = 0; l < n_lines; ++l) {
        long s = offs[l];
        const long e_all = offs[l + 1];
        while (s < e_all) {
            while (s < e_all && !std::isfinite(xy[2 * s] + xy[2 * s + 1])) ++s;
            long e = s;
            while (e < e_all && std::isfinite(xy[2 * e] + xy[2 * e + 1])) ++e;
            const long m = e - s;
            const double *p = xy + 2 * s;
            for (long i = 0; i + 1 < m; ++i) {
                double ax = p[2 * i], ay = p[2 * i + 1];
                double bx = p[2 * i + 2], by = p[2 * i + 3];
                double dx = bx - ax, dy = by - ay, len = std::hypot(dx, dy);
                if (len <= 0) continue;
                double ux = dx / len, uy = dy / len;
                bool first = i == 0, last = i + 2 == m;
                if ((first && cap == 1) || (!first && join == 0)) { ax -= ux * hw; ay -= uy * hw; }
                if ((last && cap == 1) || (!last && join == 0)) { bx += ux * hw; by += uy * hw; }
                double nx = -uy * hw, ny = ux * hw;
                double q[8] = {ax + nx, ay + ny, bx + nx, by + ny,
                               bx - nx, by - ny, ax - nx, ay - ny};
                convex_spans(cv, q, 4);
            }
            if (join == 1)
                for (long i = 1; i + 1 < m; ++i) disc_spans(cv, p[2 * i], p[2 * i + 1], hw);
            s = e;
        }
    }
    cv.resolve();
    cv.composite(img, W, rgb, alpha);
}

}  // extern "C"
