// Quadric edge-collapse decimation (Garland-Heckbert QEM).
//
// Native replacement for the reference's meshlabserver shell-out
// (reference deps/mesh-fusion/3_simplify.py:56-61 +
// simplification.mlx: TargetFaceNum, QualityThr 0.5, OptimalPlacement,
// PreserveNormal, AutoClean). meshlabserver is unavailable on TPU
// hosts; this is a self-contained implementation of the same algorithm
// family, not a translation of meshlab.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 simplify.cpp -o libsimplify.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Quadric {
    // symmetric 4x4: upper triangle a..j of [[a,b,c,d],[b,e,f,g],
    // [c,f,h,i],[d,g,i,j]]
    double a = 0, b = 0, c = 0, d = 0, e = 0, f = 0, g = 0, h = 0, i = 0,
           j = 0;
    void add(const Quadric& o) {
        a += o.a; b += o.b; c += o.c; d += o.d; e += o.e;
        f += o.f; g += o.g; h += o.h; i += o.i; j += o.j;
    }
    // Q(v) = v^T A v + 2 b^T v + c with v homogeneous
    double eval(const double* v) const {
        double x = v[0], y = v[1], z = v[2];
        return a * x * x + 2 * b * x * y + 2 * c * x * z + 2 * d * x
             + e * y * y + 2 * f * y * z + 2 * g * y
             + h * z * z + 2 * i * z + j;
    }
    // minimise: solve [[a,b,c],[b,e,f],[c,f,h]] x = -[d,g,i]
    bool minimize(double* out) const {
        double m[3][3] = {{a, b, c}, {b, e, f}, {c, f, h}};
        double rhs[3] = {-d, -g, -i};
        // gaussian elimination with partial pivoting
        int idx[3] = {0, 1, 2};
        for (int col = 0; col < 3; ++col) {
            int piv = col;
            for (int r = col + 1; r < 3; ++r)
                if (std::fabs(m[idx[r]][col]) > std::fabs(m[idx[piv]][col]))
                    piv = r;
            std::swap(idx[col], idx[piv]);
            double p = m[idx[col]][col];
            if (std::fabs(p) < 1e-10) return false;
            for (int r = col + 1; r < 3; ++r) {
                double s = m[idx[r]][col] / p;
                for (int cc = col; cc < 3; ++cc)
                    m[idx[r]][cc] -= s * m[idx[col]][cc];
                rhs[idx[r]] -= s * rhs[idx[col]];
            }
        }
        for (int col = 2; col >= 0; --col) {
            double s = rhs[idx[col]];
            for (int cc = col + 1; cc < 3; ++cc)
                s -= m[idx[col]][cc] * out[cc];
            out[col] = s / m[idx[col]][col];
        }
        return std::isfinite(out[0]) && std::isfinite(out[1]) &&
               std::isfinite(out[2]);
    }
};

struct Candidate {
    double cost;
    int32_t v1, v2;     // collapse v2 -> v1 (position replaced by opt)
    uint32_t stamp;     // sum of endpoint versions at push time
    uint8_t retries;    // requeues spent (sliver quality / normal flip)
    double pos[3];
    bool operator<(const Candidate& o) const { return cost > o.cost; }
};

inline void cross3(const double* u, const double* v, double* out) {
    out[0] = u[1] * v[2] - u[2] * v[1];
    out[1] = u[2] * v[0] - u[0] * v[2];
    out[2] = u[0] * v[1] - u[1] * v[0];
}

// normalized triangle quality 4*sqrt(3)*area / sum(edge^2); 1 for
// equilateral, -> 0 for slivers (the QualityThr contract)
double tri_quality(const double* p0, const double* p1, const double* p2) {
    double e0[3], e1[3], e2[3], n[3];
    for (int k = 0; k < 3; ++k) {
        e0[k] = p1[k] - p0[k];
        e1[k] = p2[k] - p0[k];
        e2[k] = p2[k] - p1[k];
    }
    cross3(e0, e1, n);
    double area2 = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    double l = 0;
    for (int k = 0; k < 3; ++k)
        l += e0[k] * e0[k] + e1[k] * e1[k] + e2[k] * e2[k];
    if (l <= 0) return 0.0;
    return 2.0 * std::sqrt(3.0) * 0.5 * area2 / l;
}

struct Mesh {
    std::vector<double> V;                    // nv*3
    std::vector<int32_t> F;                   // nf*3, -1 marks dead face
    std::vector<Quadric> Q;                   // per live vertex
    std::vector<uint32_t> version;            // bumped on every change
    std::vector<std::vector<int32_t>> vfaces; // incident live faces
    int64_t live_faces = 0;

    const double* vp(int32_t v) const { return &V[3 * v]; }

    bool face_alive(int32_t f) const { return F[3 * f] >= 0; }

    void face_normal(int32_t f, double* n) const {
        const double *p0 = vp(F[3 * f]), *p1 = vp(F[3 * f + 1]),
                     *p2 = vp(F[3 * f + 2]);
        double e0[3], e1[3];
        for (int k = 0; k < 3; ++k) {
            e0[k] = p1[k] - p0[k];
            e1[k] = p2[k] - p0[k];
        }
        cross3(e0, e1, n);
    }
};

}  // namespace

extern "C" {

// Decimate (verts, faces) to <= target_faces by QEM edge collapse.
// quality_thr in (0, 1]: collapses producing triangles below this
// normalized quality have their cost inflated (matching the .mlx
// QualityThr semantics of discouraging slivers).
// out_verts/out_faces are caller-allocated at input size (decimation
// never grows a mesh). Returns 0 on success.
int32_t simplify_qem(const float* verts, int64_t nv,
                     const int32_t* faces, int64_t nf,
                     int64_t target_faces, float quality_thr,
                     float* out_verts, int32_t* out_faces,
                     int64_t* out_nv, int64_t* out_nf) {
    if (nv <= 0 || nf <= 0 || target_faces < 1) return 1;

    Mesh M;
    M.V.resize(nv * 3);
    for (int64_t k = 0; k < nv * 3; ++k) M.V[k] = verts[k];
    M.F.assign(faces, faces + nf * 3);
    M.Q.assign(nv, Quadric());
    M.version.assign(nv, 0);
    M.vfaces.assign(nv, {});

    // drop degenerate input faces up front (AutoClean, pre-pass)
    for (int64_t f = 0; f < nf; ++f) {
        int32_t a = M.F[3 * f], b = M.F[3 * f + 1], c = M.F[3 * f + 2];
        if (a == b || b == c || a == c || a < 0 || b < 0 || c < 0 ||
            a >= nv || b >= nv || c >= nv) {
            M.F[3 * f] = -1;
            continue;
        }
        M.live_faces++;
        M.vfaces[a].push_back((int32_t)f);
        M.vfaces[b].push_back((int32_t)f);
        M.vfaces[c].push_back((int32_t)f);
    }

    // per-face plane quadrics, area-weighted, accumulated on vertices
    for (int64_t f = 0; f < nf; ++f) {
        if (!M.face_alive((int32_t)f)) continue;
        double n[3];
        M.face_normal((int32_t)f, n);
        double area2 = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (area2 < 1e-20) continue;
        double inv = 1.0 / area2;
        double w = 0.5 * area2;  // area weighting
        double nx = n[0] * inv, ny = n[1] * inv, nz = n[2] * inv;
        const double* p0 = M.vp(M.F[3 * f]);
        double d = -(nx * p0[0] + ny * p0[1] + nz * p0[2]);
        Quadric q;
        q.a = w * nx * nx; q.b = w * nx * ny; q.c = w * nx * nz;
        q.d = w * nx * d;  q.e = w * ny * ny; q.f = w * ny * nz;
        q.g = w * ny * d;  q.h = w * nz * nz; q.i = w * nz * d;
        q.j = w * d * d;
        for (int k = 0; k < 3; ++k) M.Q[M.F[3 * f + k]].add(q);
    }

    std::priority_queue<Candidate> heap;

    auto push_edge = [&](int32_t v1, int32_t v2) {
        if (v1 == v2) return;
        if (v1 > v2) std::swap(v1, v2);
        Quadric q = M.Q[v1];
        q.add(M.Q[v2]);
        Candidate c;
        c.v1 = v1;
        c.v2 = v2;
        c.stamp = M.version[v1] + M.version[v2];
        c.retries = 0;
        if (!q.minimize(c.pos)) {
            // fall back to the best of the endpoints / midpoint
            double mid[3] = {(M.vp(v1)[0] + M.vp(v2)[0]) * 0.5,
                             (M.vp(v1)[1] + M.vp(v2)[1]) * 0.5,
                             (M.vp(v1)[2] + M.vp(v2)[2]) * 0.5};
            const double* best = mid;
            double bc = q.eval(mid);
            if (q.eval(M.vp(v1)) < bc) { best = M.vp(v1); bc = q.eval(best); }
            if (q.eval(M.vp(v2)) < bc) { best = M.vp(v2); bc = q.eval(best); }
            std::memcpy(c.pos, best, sizeof c.pos);
        }
        c.cost = std::max(0.0, q.eval(c.pos));
        heap.push(c);
    };

    for (int64_t f = 0; f < nf; ++f) {
        if (!M.face_alive((int32_t)f)) continue;
        push_edge(M.F[3 * f], M.F[3 * f + 1]);
        push_edge(M.F[3 * f + 1], M.F[3 * f + 2]);
        push_edge(M.F[3 * f], M.F[3 * f + 2]);
    }

    std::vector<int32_t> scratch;
    while (M.live_faces > target_faces && !heap.empty()) {
        Candidate c = heap.top();
        heap.pop();
        int32_t v1 = c.v1, v2 = c.v2;
        if (c.stamp != M.version[v1] + M.version[v2]) continue;  // stale
        // endpoints must still share a live face (edge still exists)
        bool adjacent = false;
        for (int32_t f : M.vfaces[v2]) {
            if (!M.face_alive(f)) continue;
            for (int k = 0; k < 3; ++k)
                if (M.F[3 * f + k] == v1) { adjacent = true; break; }
            if (adjacent) break;
        }
        if (!adjacent) continue;

        // normal-flip + quality guard over all surviving faces of the
        // merged vertex (PreserveNormal / QualityThr semantics)
        bool reject = false;
        double worst_q = 1.0;
        for (int pass = 0; pass < 2 && !reject; ++pass) {
            int32_t v = pass == 0 ? v1 : v2;
            for (int32_t f : M.vfaces[v]) {
                if (!M.face_alive(f)) continue;
                int32_t a = M.F[3 * f], b = M.F[3 * f + 1],
                        cc = M.F[3 * f + 2];
                bool has1 = a == v1 || b == v1 || cc == v1;
                bool has2 = a == v2 || b == v2 || cc == v2;
                if (has1 && has2) continue;          // face dies
                double old_n[3];
                M.face_normal(f, old_n);
                double p[3][3];
                const int32_t idx[3] = {a, b, cc};
                for (int k = 0; k < 3; ++k) {
                    const double* src = (idx[k] == v1 || idx[k] == v2)
                                            ? c.pos : M.vp(idx[k]);
                    std::memcpy(p[k], src, sizeof p[k]);
                }
                double e0[3], e1[3], new_n[3];
                for (int k = 0; k < 3; ++k) {
                    e0[k] = p[1][k] - p[0][k];
                    e1[k] = p[2][k] - p[0][k];
                }
                cross3(e0, e1, new_n);
                double ol = std::sqrt(old_n[0] * old_n[0] +
                                      old_n[1] * old_n[1] +
                                      old_n[2] * old_n[2]);
                double nl = std::sqrt(new_n[0] * new_n[0] +
                                      new_n[1] * new_n[1] +
                                      new_n[2] * new_n[2]);
                if (ol > 1e-20 && nl > 1e-20) {
                    // flip = orientation reverses by more than 90 deg;
                    // zero-area slivers have no orientation to preserve
                    // (they must stay collapsible or they wedge the
                    // whole neighbourhood shut)
                    double dot = old_n[0] * new_n[0] +
                                 old_n[1] * new_n[1] +
                                 old_n[2] * new_n[2];
                    if (dot <= 0) { reject = true; break; }
                }
                worst_q = std::min(worst_q, tri_quality(p[0], p[1], p[2]));
            }
        }
        // rejections are NOT permanent: a flip/sliver that blocks now
        // can become legal after nearby collapses reshape the 1-ring,
        // and those collapses don't always bump this edge's versions.
        // Bounded requeue with inflated cost lets better collapses go
        // first and retries later instead of draining the heap early
        // (a hard drop stalls well above TargetFaceNum).
        if ((reject || worst_q < (double)quality_thr) && c.retries < 4) {
            Candidate again = c;
            again.retries = c.retries + 1;
            again.cost = (c.cost + 1e-12) *
                         (reject ? 32.0
                                 : 1.0 + (quality_thr - worst_q) * 1e3);
            heap.push(again);
            continue;
        }
        if (reject) continue;   // retries exhausted on a flipping edge

        // commit: move v1, absorb v2
        std::memcpy(&M.V[3 * v1], c.pos, sizeof c.pos);
        M.Q[v1].add(M.Q[v2]);
        M.version[v1]++;
        M.version[v2]++;

        scratch.clear();
        for (int32_t f : M.vfaces[v2]) {
            if (!M.face_alive(f)) continue;
            int32_t* fv = &M.F[3 * f];
            bool has1 = fv[0] == v1 || fv[1] == v1 || fv[2] == v1;
            if (has1) {
                fv[0] = -1;                  // shared face collapses
                M.live_faces--;
            } else {
                for (int k = 0; k < 3; ++k)
                    if (fv[k] == v2) fv[k] = v1;
                scratch.push_back(f);
            }
        }
        for (int32_t f : scratch) M.vfaces[v1].push_back(f);
        M.vfaces[v2].clear();
        // compact v1's incidence list (drops dead faces)
        auto& lst = M.vfaces[v1];
        lst.erase(std::remove_if(lst.begin(), lst.end(),
                                 [&](int32_t f) { return !M.face_alive(f); }),
                  lst.end());

        // re-push v1's edges
        for (int32_t f : lst)
            for (int k = 0; k < 3; ++k) {
                int32_t o = M.F[3 * f + k];
                if (o != v1) push_edge(v1, o);
            }
    }

    // AutoClean: drop dead/degenerate faces + unreferenced vertices
    std::vector<int32_t> remap(nv, -1);
    int64_t onv = 0, onf = 0;
    for (int64_t f = 0; f < nf; ++f) {
        int32_t a = M.F[3 * f], b = M.F[3 * f + 1], c = M.F[3 * f + 2];
        if (a < 0 || a == b || b == c || a == c) continue;
        for (int32_t v : {a, b, c})
            if (remap[v] < 0) {
                remap[v] = (int32_t)onv;
                for (int k = 0; k < 3; ++k)
                    out_verts[3 * onv + k] = (float)M.V[3 * v + k];
                onv++;
            }
        out_faces[3 * onf] = remap[a];
        out_faces[3 * onf + 1] = remap[b];
        out_faces[3 * onf + 2] = remap[c];
        onf++;
    }
    *out_nv = onv;
    *out_nf = onf;
    return 0;
}

}  // extern "C"
