// Headless software depth rasterizer: z-buffered triangle rasterization
// producing a depth map from (vertices, faces, intrinsics, view matrix).
//
// Native replacement for the reference's OpenGL offscreen renderer
// (reference deps/mesh-fusion/librender/offscreen.cpp:7-60,125+ --
// GL/GLUT/GLEW are unavailable on TPU hosts). Used by the offline
// watertight-mesh preprocessing pipeline to render the ~100 synthetic
// views per mesh (reference deps/mesh-fusion/2_fusion.py:99-152).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rasterize.cpp -o librasterize.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// vertices: (n_verts, 3) float32 world coords
// faces: (n_faces, 3) int32
// view: (4, 4) row-major world->camera matrix
// K: (3, 3) row-major intrinsics (u = col, v = row; z forward, y down)
// colors: (n_verts, 3) float32 in [0, 1] or NULL (flat diffuse shading
//         from the face normal, the GL renderer's coloring=false mode --
//         reference deps/mesh-fusion/librender/pyrender.pyx:38-39,
//         offscreen.cpp lighting)
// depth_out: (h, w) float32, 0 where nothing was hit
// mask_out: (h, w) uint8 hit mask, or NULL
// rgb_out: (h, w, 3) uint8, or NULL
static void rasterize_impl(const float* vertices, int64_t n_verts,
                           const int32_t* faces, int64_t n_faces,
                           const float* view, const float* K,
                           const float* colors,
                           int32_t h, int32_t w,
                           float znear, float zfar,
                           float* depth_out, uint8_t* mask_out,
                           uint8_t* rgb_out) {
    for (int64_t i = 0; i < (int64_t)h * w; ++i)
        depth_out[i] = 0.0f;
    if (mask_out)
        for (int64_t i = 0; i < (int64_t)h * w; ++i) mask_out[i] = 0;
    if (rgb_out)
        for (int64_t i = 0; i < (int64_t)h * w * 3; ++i) rgb_out[i] = 0;

    const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];

    auto cam = [&](int32_t vi, float* out) {
        const float* p = vertices + 3 * vi;
        for (int r = 0; r < 3; ++r)
            out[r] = view[4 * r] * p[0] + view[4 * r + 1] * p[1]
                   + view[4 * r + 2] * p[2] + view[4 * r + 3];
    };

    float a[3], b[3], c[3];
    for (int64_t f = 0; f < n_faces; ++f) {
        cam(faces[3 * f], a);
        cam(faces[3 * f + 1], b);
        cam(faces[3 * f + 2], c);
        if (a[2] < znear || b[2] < znear || c[2] < znear) continue;
        if (a[2] > zfar && b[2] > zfar && c[2] > zfar) continue;

        // project to pixel space
        float ua = fx * a[0] / a[2] + cx, va = fy * a[1] / a[2] + cy;
        float ub = fx * b[0] / b[2] + cx, vb = fy * b[1] / b[2] + cy;
        float uc = fx * c[0] / c[2] + cx, vc = fy * c[1] / c[2] + cy;

        int x0 = std::max(0, (int)std::floor(std::min({ua, ub, uc})));
        int x1 = std::min(w - 1, (int)std::ceil(std::max({ua, ub, uc})));
        int y0 = std::max(0, (int)std::floor(std::min({va, vb, vc})));
        int y1 = std::min(h - 1, (int)std::ceil(std::max({va, vb, vc})));
        if (x0 > x1 || y0 > y1) continue;

        // edge functions in pixel space; perspective-correct z via 1/z
        float area = (ub - ua) * (vc - va) - (uc - ua) * (vb - va);
        if (std::fabs(area) < 1e-12f) continue;
        float inv_area = 1.0f / area;
        float za = 1.0f / a[2], zb = 1.0f / b[2], zc = 1.0f / c[2];

        // per-face flat shade for the colors == NULL mode: diffuse from
        // the camera-space normal against the view direction
        float shade = 0.0f;
        if (rgb_out && !colors) {
            float e0[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
            float e1[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
            float nx = e0[1] * e1[2] - e0[2] * e1[1];
            float ny = e0[2] * e1[0] - e0[0] * e1[2];
            float nz = e0[0] * e1[1] - e0[1] * e1[0];
            float nl = std::sqrt(nx * nx + ny * ny + nz * nz);
            shade = nl > 0 ? 0.2f + 0.8f * std::fabs(nz) / nl : 0.2f;
        }
        const float* ca = colors ? colors + 3 * faces[3 * f] : nullptr;
        const float* cb = colors ? colors + 3 * faces[3 * f + 1] : nullptr;
        const float* cc2 = colors ? colors + 3 * faces[3 * f + 2] : nullptr;

        for (int y = y0; y <= y1; ++y) {
            for (int x = x0; x <= x1; ++x) {
                float px = x + 0.5f, py = y + 0.5f;
                float w0 = ((ub - px) * (vc - py) - (uc - px) * (vb - py))
                           * inv_area;
                float w1 = ((uc - px) * (va - py) - (ua - px) * (vc - py))
                           * inv_area;
                float w2 = 1.0f - w0 - w1;
                if (w0 < 0 || w1 < 0 || w2 < 0) continue;
                float inv_z = w0 * za + w1 * zb + w2 * zc;
                if (inv_z <= 0) continue;
                float z = 1.0f / inv_z;
                if (z < znear || z > zfar) continue;
                float& d = depth_out[(int64_t)y * w + x];
                if (d == 0.0f || z < d) {
                    d = z;
                    if (mask_out) mask_out[(int64_t)y * w + x] = 1;
                    if (rgb_out) {
                        uint8_t* px_rgb = rgb_out + 3 * ((int64_t)y * w + x);
                        for (int ch = 0; ch < 3; ++ch) {
                            // perspective-correct barycentric color
                            float val = colors
                                ? (w0 * za * ca[ch] + w1 * zb * cb[ch]
                                   + w2 * zc * cc2[ch]) * z
                                : shade;
                            val = std::min(1.0f, std::max(0.0f, val));
                            px_rgb[ch] = (uint8_t)(val * 255.0f + 0.5f);
                        }
                    }
                }
            }
        }
    }
}

void rasterize_depth(const float* vertices, int64_t n_verts,
                     const int32_t* faces, int64_t n_faces,
                     const float* view, const float* K,
                     int32_t h, int32_t w,
                     float znear, float zfar,
                     float* depth_out) {
    rasterize_impl(vertices, n_verts, faces, n_faces, view, K, nullptr,
                   h, w, znear, zfar, depth_out, nullptr, nullptr);
}

// Full render: depth + hit mask + RGB (the reference librender return
// triple, pyrender.pyx:51). colors may be NULL for flat shading.
void rasterize_full(const float* vertices, int64_t n_verts,
                    const int32_t* faces, int64_t n_faces,
                    const float* view, const float* K,
                    const float* colors,
                    int32_t h, int32_t w,
                    float znear, float zfar,
                    float* depth_out, uint8_t* mask_out,
                    uint8_t* rgb_out) {
    rasterize_impl(vertices, n_verts, faces, n_faces, view, K, colors,
                   h, w, znear, zfar, depth_out, mask_out, rgb_out);
}

}  // extern "C"
