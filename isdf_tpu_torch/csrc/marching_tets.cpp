// Marching-tetrahedra isosurface extraction — native core.
//
// Replaces the vectorised-numpy implementation (utils/mesh3d.py) on the
// meshing path: a 200^3 grid extracts in ~0.3 s here vs ~10 s in numpy.
// Same decomposition (6 tets sharing the cube main diagonal) and the same
// case/orientation conventions, so the two implementations are
// interchangeable and cross-checked in tests.
//
// C ABI (ctypes):
//   int marching_tets(const float* sdf, int d0, int d1, int d2,
//                     float level, float** out_tris, long* out_n);
//     out_tris: malloc'd [n, 3, 3] float32 triangle soup (caller frees
//     via free_tris). Returns 0 on success.
//   void free_tris(float* p);

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

inline V3 lerp_edge(const V3& pa, const V3& pb, float va, float vb) {
    float t = va / (va - vb);
    return V3{pa.x + t * (pb.x - pa.x),
              pa.y + t * (pb.y - pa.y),
              pa.z + t * (pb.z - pa.z)};
}

// cube corner offsets, bit-packed dx*4 + dy*2 + dz (matches mesh3d.py)
const int CORNERS[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// 6-tet decomposition sharing the 0-7 diagonal (matches mesh3d.py _TETS)
const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

}  // namespace

extern "C" {

int marching_tets(const float* sdf, int d0, int d1, int d2, float level,
                  float** out_tris, long* out_n) {
    std::vector<float> tris;
    tris.reserve(1 << 20);

    const long s0 = (long)d1 * d2;
    const long s1 = d2;

    auto val = [&](int i, int j, int k) -> float {
        return sdf[(long)i * s0 + (long)j * s1 + k] - level;
    };

    auto emit = [&](const V3& a, const V3& b, const V3& c) {
        const float* ps[3] = {&a.x, &b.x, &c.x};
        for (int q = 0; q < 3; ++q)
            for (int d = 0; d < 3; ++d) tris.push_back(ps[q][d]);
    };

    float v[8];
    V3 p[8];
    float tv[4];
    V3 tp[4];

    for (int i = 0; i + 1 < d0; ++i) {
        for (int j = 0; j + 1 < d1; ++j) {
            for (int k = 0; k + 1 < d2; ++k) {
                int pos = 0;
                for (int c = 0; c < 8; ++c) {
                    v[c] = val(i + CORNERS[c][0], j + CORNERS[c][1],
                               k + CORNERS[c][2]);
                    pos += v[c] > 0.0f;
                }
                if (pos == 0 || pos == 8) continue;
                for (int c = 0; c < 8; ++c)
                    p[c] = V3{(float)(i + CORNERS[c][0]),
                              (float)(j + CORNERS[c][1]),
                              (float)(k + CORNERS[c][2])};

                for (int t = 0; t < 6; ++t) {
                    int n_in = 0;
                    int inside[4];
                    for (int c = 0; c < 4; ++c) {
                        tv[c] = v[TETS[t][c]];
                        tp[c] = p[TETS[t][c]];
                        inside[c] = tv[c] <= 0.0f;
                        n_in += inside[c];
                    }
                    if (n_in == 0 || n_in == 4) continue;

                    if (n_in == 1 || n_in == 3) {
                        // single corner on the minority side
                        int ci = -1;
                        for (int c = 0; c < 4; ++c)
                            if ((n_in == 1) == (bool)inside[c]) {
                                ci = c;
                                break;
                            }
                        V3 e[3];
                        int q = 0;
                        for (int o = 0; o < 4; ++o)
                            if (o != ci)
                                e[q++] = lerp_edge(tp[ci], tp[o], tv[ci],
                                                   tv[o]);
                        if (n_in == 1)
                            emit(e[0], e[1], e[2]);
                        else
                            emit(e[0], e[2], e[1]);  // flipped
                    } else {
                        // 2 in / 2 out: iterate pairs in the same order as
                        // itertools.combinations(range(4), 2)
                        int a = -1, b = -1;
                        for (int x = 0; x < 4 && a < 0; ++x)
                            for (int y = x + 1; y < 4; ++y)
                                if (inside[x] && inside[y]) {
                                    a = x;
                                    b = y;
                                    x = 4;
                                    break;
                                }
                        int cd[2], q = 0;
                        for (int o = 0; o < 4; ++o)
                            if (o != a && o != b) cd[q++] = o;
                        V3 pac = lerp_edge(tp[a], tp[cd[0]], tv[a], tv[cd[0]]);
                        V3 pad = lerp_edge(tp[a], tp[cd[1]], tv[a], tv[cd[1]]);
                        V3 pbc = lerp_edge(tp[b], tp[cd[0]], tv[b], tv[cd[0]]);
                        V3 pbd = lerp_edge(tp[b], tp[cd[1]], tv[b], tv[cd[1]]);
                        emit(pac, pad, pbd);
                        emit(pac, pbd, pbc);
                    }
                }
            }
        }
    }

    long n = (long)(tris.size() / 9);
    float* buf = (float*)std::malloc(tris.size() * sizeof(float));
    if (!buf && !tris.empty()) return 1;
    std::memcpy(buf, tris.data(), tris.size() * sizeof(float));
    *out_tris = buf;
    *out_n = n;
    return 0;
}

void free_tris(float* p) { std::free(p); }

}  // extern "C"
