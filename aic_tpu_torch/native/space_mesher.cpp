// Copy of aic_tpu/native/space_mesher.cpp, built by aic_tpu_torch/native/__init__.py.
//
// Native whole-space greedy mesher.
//
// The role of the reference's hot meshing loop (all-is-cubes-mesh/src/
// space_mesh.rs compute + block_mesh analysis): given the palette-indexed
// contents volume and per-palette visibility/opacity tables, emit greedy-
// merged face rectangles for every visible cube face. This is the host
// hot path of mesh generation (the per-plane Python loop it replaces is
// O(volume) interpreted code); quad-list -> vertex-buffer expansion stays
// vectorized numpy on the Python side.
//
// Face order and culling semantics match aic_tpu_torch.mesh.mesher.visible_faces:
// face f of cube c is emitted iff visible[block(c)] and the neighbor across
// f does not have an opaque face toward c (world boundary = open).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 on success, 1 if out_quads was too small.
// out_quads rows: [face, layer, u0, v0, du, dv, block_id] (7 x int32).
int mesh_space_greedy(
    const uint16_t* contents, int sx, int sy, int sz,
    const uint8_t* visible,          // [P] visible_or_animated
    const uint8_t* opaque_faces,     // [P*6]
    int32_t* out_quads, int max_quads, int* out_count)
{
    const int size[3] = {sx, sy, sz};
    const long strides[3] = {(long)sy * sz, (long)sz, 1};
    int count = 0;

    // Scratch plane: block id + 1 where a face is visible, 0 otherwise.
    std::vector<uint32_t> plane;

    for (int f = 0; f < 6; f++) {
        const int axis = f % 3;
        const int u_ax = (axis + 1) % 3;
        const int v_ax = (axis + 2) % 3;
        const int dir = (f < 3) ? -1 : 1;
        const int opp = (f + 3) % 6;

        const int nu = size[u_ax];
        const int nv = size[v_ax];
        plane.assign((size_t)nu * nv, 0u);

        for (int layer = 0; layer < size[axis]; layer++) {
            // Build the visibility plane for this layer.
            for (int u = 0; u < nu; u++) {
                for (int v = 0; v < nv; v++) {
                    long idx = (long)layer * strides[axis] +
                               (long)u * strides[u_ax] + (long)v * strides[v_ax];
                    uint16_t bid = contents[idx];
                    uint32_t cell = 0;
                    if (visible[bid]) {
                        int nl = layer + dir;
                        bool occluded = false;
                        if (nl >= 0 && nl < size[axis]) {
                            long nidx = idx + (long)dir * strides[axis];
                            uint16_t nbid = contents[nidx];
                            occluded = opaque_faces[(long)nbid * 6 + opp] != 0;
                        }
                        if (!occluded) cell = (uint32_t)bid + 1u;
                    }
                    plane[(size_t)u * nv + v] = cell;
                }
            }
            // Greedy rectangle merge over same-id cells.
            for (int u = 0; u < nu; u++) {
                for (int v = 0; v < nv;) {
                    uint32_t id = plane[(size_t)u * nv + v];
                    if (!id) { v++; continue; }
                    int v2 = v;
                    while (v2 + 1 < nv && plane[(size_t)u * nv + v2 + 1] == id) v2++;
                    int u2 = u;
                    for (;;) {
                        if (u2 + 1 >= nu) break;
                        bool rowok = true;
                        for (int vv = v; vv <= v2; vv++) {
                            if (plane[(size_t)(u2 + 1) * nv + vv] != id) { rowok = false; break; }
                        }
                        if (!rowok) break;
                        u2++;
                    }
                    for (int uu = u; uu <= u2; uu++)
                        for (int vv = v; vv <= v2; vv++)
                            plane[(size_t)uu * nv + vv] = 0;
                    if (count >= max_quads) { *out_count = count; return 1; }
                    int32_t* q = out_quads + (long)count * 7;
                    q[0] = f; q[1] = layer; q[2] = u; q[3] = v;
                    q[4] = u2 - u + 1; q[5] = v2 - v + 1; q[6] = (int32_t)(id - 1u);
                    count++;
                    v = v2 + 1;
                }
            }
        }
    }
    *out_count = count;
    return 0;
}

}  // extern "C"
