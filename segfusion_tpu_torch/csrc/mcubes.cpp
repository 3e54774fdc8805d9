// Isosurface extraction: marching tetrahedra over a Kuhn 6-tet cube
// subdivision, with edge-welded vertices and gradient normals.
//
// Native replacement for the reference's mesh extraction path
// (skimage.measure.marching_cubes_lewiner in modules/database.py:120-122 and
// the vendored PyMCubes in deps/mesh-fusion/libmcubes/). Marching tetrahedra
// produces a watertight, crack-free isosurface on a uniform lattice (all
// cubes share the same main diagonal) without the 256-case MC tables.
//
// C ABI (ctypes): mt_run() allocates result buffers, mt_free() releases.
//
// Build: g++ -O3 -march=native -shared -fPIC mcubes.cpp -o libmcubes.so

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct V3 { float x, y, z; };

// Kuhn subdivision: 6 tetrahedra around the main diagonal (corner 0 -> 7).
// Cube corners are numbered with bit0 = +x, bit1 = +y, bit2 = +z.
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

// Tet edges as corner index pairs.
static const int TET_EDGES[6][2] = {
    {0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3},
};

// Triangulation per inside-bitmask (bit i set = corner i below iso).
// Each triangle is 3 tet-edge ids; -1 terminates. Complementary cases use
// the same cut edges (orientation handled by gradient normals downstream).
static const int TET_TRIS[16][7] = {
    {-1, -1, -1, -1, -1, -1, -1},            // 0000
    {0, 1, 2, -1, -1, -1, -1},               // 0001: corner 0 in
    {0, 3, 4, -1, -1, -1, -1},               // 0010: corner 1 in
    {1, 2, 3, 3, 2, 4, -1},                  // 0011: 0,1 in (quad e1,e2,e4,e3)
    {1, 3, 5, -1, -1, -1, -1},               // 0100: corner 2 in
    {0, 3, 5, 0, 5, 2, -1},                  // 0101: 0,2 in (quad e0,e3,e5,e2)
    {0, 1, 5, 0, 5, 4, -1},                  // 0110: 1,2 in (quad e0,e1,e5,e4)
    {2, 4, 5, -1, -1, -1, -1},               // 0111: 3 out
    {2, 4, 5, -1, -1, -1, -1},               // 1000: corner 3 in
    {0, 4, 5, 0, 5, 1, -1},                  // 1001: 0,3 in (quad e0,e4,e5,e1)
    {0, 3, 5, 0, 5, 2, -1},                  // 1010: 1,3 in
    {1, 3, 5, -1, -1, -1, -1},               // 1011: 2 out
    {1, 2, 3, 3, 2, 4, -1},                  // 1100: 2,3 in
    {0, 3, 4, -1, -1, -1, -1},               // 1101: 1 out
    {0, 1, 2, -1, -1, -1, -1},               // 1110: 0 out
    {-1, -1, -1, -1, -1, -1, -1},            // 1111
};

struct MeshBuilder {
    const float* vol;
    int64_t nx, ny, nz;
    float iso;
    std::vector<float> verts;   // flat xyz (voxel units)
    std::vector<int32_t> faces;
    std::unordered_map<uint64_t, int32_t> edge_vertex;

    inline float at(int64_t x, int64_t y, int64_t z) const {
        return vol[(x * ny + y) * nz + z];
    }
    inline int64_t lin(int64_t x, int64_t y, int64_t z) const {
        return (x * ny + y) * nz + z;
    }

    // Interpolated vertex on the segment between grid corners a and b.
    int32_t edge_vert(int64_t ax, int64_t ay, int64_t az, float va,
                      int64_t bx, int64_t by, int64_t bz, float vb) {
        int64_t la = lin(ax, ay, az), lb = lin(bx, by, bz);
        uint64_t key = la < lb
            ? (uint64_t)la * 0x100000000ull ^ (uint64_t)lb
            : (uint64_t)lb * 0x100000000ull ^ (uint64_t)la;
        auto it = edge_vertex.find(key);
        if (it != edge_vertex.end()) return it->second;
        float denom = va - vb;
        float t = std::fabs(denom) > 1e-12f ? (va - iso) / denom : 0.5f;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        int32_t idx = (int32_t)(verts.size() / 3);
        verts.push_back((float)ax + t * ((float)bx - (float)ax));
        verts.push_back((float)ay + t * ((float)by - (float)ay));
        verts.push_back((float)az + t * ((float)bz - (float)az));
        edge_vertex.emplace(key, idx);
        return idx;
    }

    void run() {
        int64_t cx[8], cy[8], cz[8];
        float cv[8];
        for (int64_t x = 0; x + 1 < nx; ++x)
        for (int64_t y = 0; y + 1 < ny; ++y)
        for (int64_t z = 0; z + 1 < nz; ++z) {
            for (int c = 0; c < 8; ++c) {
                cx[c] = x + (c & 1);
                cy[c] = y + ((c >> 1) & 1);
                cz[c] = z + ((c >> 2) & 1);
                cv[c] = at(cx[c], cy[c], cz[c]);
            }
            // quick reject: all corners same side
            int below = 0;
            for (int c = 0; c < 8; ++c) below += (cv[c] < iso);
            if (below == 0 || below == 8) continue;

            for (int t = 0; t < 6; ++t) {
                const int* tc = TETS[t];
                int mask = 0;
                for (int c = 0; c < 4; ++c)
                    if (cv[tc[c]] < iso) mask |= 1 << c;
                const int* tri = TET_TRIS[mask];
                for (int k = 0; tri[k] >= 0; k += 3) {
                    int32_t vid[3];
                    for (int e = 0; e < 3; ++e) {
                        int a = tc[TET_EDGES[tri[k + e]][0]];
                        int b = tc[TET_EDGES[tri[k + e]][1]];
                        vid[e] = edge_vert(cx[a], cy[a], cz[a], cv[a],
                                           cx[b], cy[b], cz[b], cv[b]);
                    }
                    if (vid[0] == vid[1] || vid[1] == vid[2] ||
                        vid[0] == vid[2]) continue;  // degenerate
                    faces.push_back(vid[0]);
                    faces.push_back(vid[1]);
                    faces.push_back(vid[2]);
                }
            }
        }
    }

    // Gradient normal at a (voxel-space) vertex via trilinear-sampled
    // central differences; points toward increasing values (outside for
    // a TSDF with positive = free space).
    void normal_at(float px, float py, float pz, float* n) const {
        auto sample = [&](float sx, float sy, float sz) -> float {
            if (sx < 0) sx = 0; if (sx > nx - 1) sx = (float)(nx - 1);
            if (sy < 0) sy = 0; if (sy > ny - 1) sy = (float)(ny - 1);
            if (sz < 0) sz = 0; if (sz > nz - 1) sz = (float)(nz - 1);
            int64_t x0 = (int64_t)sx, y0 = (int64_t)sy, z0 = (int64_t)sz;
            int64_t x1 = x0 + 1 < nx ? x0 + 1 : x0;
            int64_t y1 = y0 + 1 < ny ? y0 + 1 : y0;
            int64_t z1 = z0 + 1 < nz ? z0 + 1 : z0;
            float fx = sx - (float)x0, fy = sy - (float)y0,
                  fz = sz - (float)z0;
            float c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx;
            float c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx;
            float c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx;
            float c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx;
            float c0 = c00 * (1 - fy) + c10 * fy;
            float c1 = c01 * (1 - fy) + c11 * fy;
            return c0 * (1 - fz) + c1 * fz;
        };
        const float h = 0.5f;
        float gx = sample(px + h, py, pz) - sample(px - h, py, pz);
        float gy = sample(px, py + h, pz) - sample(px, py - h, pz);
        float gz = sample(px, py, pz + h) - sample(px, py, pz - h);
        float len = std::sqrt(gx * gx + gy * gy + gz * gz);
        if (len < 1e-12f) { n[0] = 0; n[1] = 0; n[2] = 1; return; }
        n[0] = gx / len; n[1] = gy / len; n[2] = gz / len;
    }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output buffers are malloc'd; release with mt_free.
int mt_run(const float* volume, int64_t nx, int64_t ny, int64_t nz,
           float iso, float spacing,
           float** out_verts, int32_t** out_faces, float** out_normals,
           int64_t* n_verts, int64_t* n_faces) {
    MeshBuilder mb;
    mb.vol = volume;
    mb.nx = nx; mb.ny = ny; mb.nz = nz;
    mb.iso = iso;
    mb.run();

    int64_t nv = (int64_t)(mb.verts.size() / 3);
    int64_t nf = (int64_t)(mb.faces.size() / 3);
    *n_verts = nv;
    *n_faces = nf;
    *out_verts = (float*)std::malloc(sizeof(float) * 3 * (nv ? nv : 1));
    *out_faces = (int32_t*)std::malloc(sizeof(int32_t) * 3 * (nf ? nf : 1));
    *out_normals = (float*)std::malloc(sizeof(float) * 3 * (nv ? nv : 1));
    if (!*out_verts || !*out_faces || !*out_normals) return 1;

    for (int64_t i = 0; i < nv; ++i) {
        float px = mb.verts[3 * i], py = mb.verts[3 * i + 1],
              pz = mb.verts[3 * i + 2];
        (*out_verts)[3 * i] = px * spacing;
        (*out_verts)[3 * i + 1] = py * spacing;
        (*out_verts)[3 * i + 2] = pz * spacing;
        mb.normal_at(px, py, pz, *out_normals + 3 * i);
    }
    for (size_t i = 0; i < mb.faces.size(); ++i)
        (*out_faces)[i] = mb.faces[i];
    return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
