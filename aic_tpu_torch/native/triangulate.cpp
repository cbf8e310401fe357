// Copy of aic_tpu/native/triangulate.cpp, built by aic_tpu_torch/native/__init__.py.
//
// No-T-junction plane triangulator (native host component).
//
// Role of the reference's planar sweep-line triangulator
// (all-is-cubes-mesh/src/block_mesh/planar/, ~991 LoC Rust): merge the
// visible cells of a mesh plane into larger polygons WITHOUT introducing
// T-junctions — the reference explicitly rejects plain greedy meshing for
// exactly this artifact (planar/mod.rs:34-40).
//
// Algorithm (re-derivation, not a translation): greedy maximal-rectangle
// decomposition per block id, then each rectangle is triangulated as a
// FAN from its center to every UNIT segment of its boundary. Every
// lattice point on every rectangle edge is a vertex, so any two adjacent
// rectangles (or a rectangle and the region boundary) subdivide their
// shared edge identically — no T-junctions by construction, while large
// areas still collapse from 2ab unit-quad triangles to 2(a+b) fan
// triangles.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

// mask:   u8[H*W]  (row-major, 1 = emit this cell)
// ids:    u16[H*W] block id per cell (rectangles never span ids)
// out_verts: f32[max_v * 2]  (u, v) lattice coordinates
// out_tris:  i32[max_t * 3]  vertex indices
// out_tri_ids: u16[max_t]    block id per triangle
// Returns 0 on success, -1 if capacity exceeded.
int triangulate_plane(const uint8_t* mask, const uint16_t* ids, int h, int w,
                      float* out_verts, int32_t* out_tris,
                      uint16_t* out_tri_ids, int max_v, int max_t,
                      int* n_verts, int* n_tris) {
  std::vector<uint8_t> used(static_cast<size_t>(h) * w, 0);
  int nv = 0, nt = 0;

  auto add_vert = [&](float u, float v) -> int {
    if (nv >= max_v) return -1;
    out_verts[2 * nv] = u;
    out_verts[2 * nv + 1] = v;
    return nv++;
  };

  for (int u0 = 0; u0 < h; ++u0) {
    for (int v0 = 0; v0 < w; ++v0) {
      size_t idx0 = static_cast<size_t>(u0) * w + v0;
      if (!mask[idx0] || used[idx0]) continue;
      uint16_t id = ids[idx0];

      // Grow along v, then along u (classic greedy maximal rectangle).
      int dv = 1;
      while (v0 + dv < w) {
        size_t i = static_cast<size_t>(u0) * w + (v0 + dv);
        if (!mask[i] || used[i] || ids[i] != id) break;
        ++dv;
      }
      int du = 1;
      while (u0 + du < h) {
        bool ok = true;
        for (int v = v0; v < v0 + dv; ++v) {
          size_t i = static_cast<size_t>(u0 + du) * w + v;
          if (!mask[i] || used[i] || ids[i] != id) { ok = false; break; }
        }
        if (!ok) break;
        ++du;
      }
      for (int u = u0; u < u0 + du; ++u)
        for (int v = v0; v < v0 + dv; ++v)
          used[static_cast<size_t>(u) * w + v] = 1;

      // Fan triangulation: center vertex + boundary ring at unit steps
      // (clockwise in (u, v); the mesher flips winding per face sign).
      float cu = u0 + du * 0.5f;
      float cv = v0 + dv * 0.5f;
      int center = add_vert(cu, cv);
      if (center < 0) return -1;

      // Boundary ring: left edge +v, top edge +u, right edge -v,
      // bottom edge -u.
      std::vector<int> ring;
      ring.reserve(2 * (du + dv));
      for (int v = v0; v < v0 + dv; ++v) ring.push_back(add_vert((float)u0, (float)v));
      for (int u = u0; u < u0 + du; ++u) ring.push_back(add_vert((float)u, (float)(v0 + dv)));
      for (int v = v0 + dv; v > v0; --v) ring.push_back(add_vert((float)(u0 + du), (float)v));
      for (int u = u0 + du; u > u0; --u) ring.push_back(add_vert((float)u, (float)v0));
      for (int k : ring)
        if (k < 0) return -1;

      int n = static_cast<int>(ring.size());
      for (int k = 0; k < n; ++k) {
        if (nt >= max_t) return -1;
        out_tris[3 * nt] = center;
        out_tris[3 * nt + 1] = ring[k];
        out_tris[3 * nt + 2] = ring[(k + 1) % n];
        out_tri_ids[nt] = id;
        ++nt;
      }
    }
  }
  *n_verts = nv;
  *n_tris = nt;
  return 0;
}

}  // extern "C"
