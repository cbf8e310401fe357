// One Jacobi relight pass over every cube of a space: one thread per cube.
//
// Replaces the TPU kernel aic_tpu/light/pallas_relight.py:338
// `_kernel_factory`; semantics are aic_tpu/light/dense.py `_run_pairs`
// (the reference's LightBuffer::traverse, updater.rs:755-880), and the
// plain PyTorch twin is `relight_pass_plain` in
// aic_tpu_torch/light/relight_kernel.py.
//
// Two variants, as the TPU kernel has (its `dyn` flag): the full pass, and
// the light-only pass (DYN), which leaves out every term that does not read
// stored light -- emission, the sky a ray picks up at its end, the sky
// one-ring outside the bounds, and the total weight. A pass is affine in the
// stored light, so full(ring only) + light_only(interior) = full(interior +
// ring): the convergence loop runs the full pass once and the light-only
// pass per iteration.
//
// Bound on the H100: each step of a ray is a chain of dependent loads
// (contents -> face row -> stored light), so latency, not bandwidth, is
// the limit; the tables are a few MB and stay in L2. The design keeps the
// per-ray state in registers, lets every thread of a warp read the same
// pair entry (the warp walks one ray at a time until its threads diverge
// on where the ray ends), cuts each ray at its end, and accumulates in f32
// registers with no atomics: each thread owns its cube's sums.
//
// Inputs are row-major like the tensors that hold them (cube index
// c = (x*Y + y)*Z + z). Returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kNormals[6][3] = {
    {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}};

struct Light {
  float r, g, b;
};

// Stored light at a cube, or BlockSky::light_outside (sky.rs:96) for the
// one-cube ring outside the bounds: the sky's face light where exactly one
// coordinate is out (by one), 0 elsewhere. The light-only pass reads 0 on
// the ring.
template <bool DYN>
__device__ __forceinline__ Light light_at(const float* __restrict__ light_rgb,
                                          const float* __restrict__ sky_faces,
                                          int x, int y, int z, int X, int Y,
                                          int Z) {
  const bool ox = x < 0 || x >= X, oy = y < 0 || y >= Y, oz = z < 0 || z >= Z;
  if (!ox && !oy && !oz) {
    const float* p = light_rgb + 3 * ((x * Y + y) * Z + z);
    return {p[0], p[1], p[2]};
  }
  if (!DYN && int(ox) + int(oy) + int(oz) == 1) {
    int f = -1;
    if (ox) f = x == -1 ? 0 : (x == X ? 3 : -1);
    if (oy) f = y == -1 ? 1 : (y == Y ? 4 : -1);
    if (oz) f = z == -1 ? 2 : (z == Z ? 5 : -1);
    if (f >= 0) return {sky_faces[3 * f], sky_faces[3 * f + 1], sky_faces[3 * f + 2]};
  }
  return {0.f, 0.f, 0.f};
}

template <bool DYN>
__global__ void relight_pass_kernel(
    const int32_t* __restrict__ contents, const float* __restrict__ light_rgb,
    const float* __restrict__ face_rows, const float* __restrict__ dir_weights,
    const float* __restrict__ alpha0, const bool* __restrict__ origin_opaque,
    const float* __restrict__ sky_faces, const float* __restrict__ cosines,
    const float* __restrict__ sky_ray, const int32_t* __restrict__ ray_start,
    const int32_t* __restrict__ pair_off, const int32_t* __restrict__ pair_face,
    const uint8_t* __restrict__ pair_end, float* __restrict__ incoming,
    float* __restrict__ total, int X, int Y, int Z, int R) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= X * Y * Z) return;
  float ir = 0.f, ig = 0.f, ib = 0.f, tw = 0.f;
  const float a0 = alpha0[c];
  // `_finish` overwrites the result of an opaque origin: skip its walk.
  if (!origin_opaque[c] && a0 > 0.f) {
    const int cx = c / (Y * Z), cy = (c / Z) % Y, cz = c % Z;
    float dw[6];
    for (int f = 0; f < 6; ++f) dw[f] = dir_weights[6 * c + f];
    for (int r = 0; r < R; ++r) {
      const float* cr = cosines + 6 * r;
      float w = dw[0] * cr[0];
      for (int f = 1; f < 6; ++f) w = w + dw[f] * cr[f];
      if (!(w > 0.f)) continue;
      float alpha = a0;
      const int s_end = ray_start[r + 1];
      for (int s = ray_start[r]; s < s_end; ++s) {
        const int px = cx + pair_off[3 * s], py = cy + pair_off[3 * s + 1],
                  pz = cz + pair_off[3 * s + 2];
        const bool inside =
            px >= 0 && px < X && py >= 0 && py < Y && pz >= 0 && pz < Z;
        bool ends = pair_end[s] != 0 || !inside;
        if (!ends) {
          const int face = pair_face[s];
          const float* row =
              face_rows + 8 * (6 * contents[(px * Y + py) * Z + pz] + face);
          const float flags = row[4];
          bool hit_opaque = false;
          if (flags >= 2.f) {  // visible
            const float ha = fminf(fmaxf(row[3], 0.f), 1.f);
            if (ha > 0.f) {  // struck: reflect the light behind the face
              const Light bh =
                  light_at<DYN>(light_rgb, sky_faces, px + kNormals[face][0],
                           py + kNormals[face][1], pz + kNormals[face][2], X, Y, Z);
              const float aw = alpha * w;
              const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                          eb = DYN ? 0.f : row[7];
              ir = ir + (er + fminf(fmaxf(row[0], 0.f), 1.f) * bh.r * ha) * aw;
              ig = ig + (eg + fminf(fmaxf(row[1], 0.f), 1.f) * bh.g * ha) * aw;
              ib = ib + (eb + fminf(fmaxf(row[2], 0.f), 1.f) * bh.b * ha) * aw;
              hit_opaque = fmodf(flags, 2.f) >= 1.f;
              if (!hit_opaque) alpha = alpha * (1.f - ha);
            }
            if (ha < 1.f && !hit_opaque) {  // pass through: own stored light
              const Light own = light_at<DYN>(light_rgb, sky_faces, px, py, pz, X, Y, Z);
              const float aw = alpha * w;
              const float er = DYN ? 0.f : row[5], eg = DYN ? 0.f : row[6],
                          eb = DYN ? 0.f : row[7];
              ir = ir + (er + own.r * ha) * aw;
              ig = ig + (eg + own.g * ha) * aw;
              ib = ib + (eb + own.b * ha) * aw;
              alpha = alpha * (1.f - ha);
            }
          }
          if (hit_opaque) alpha = 0.f;
          ends = hit_opaque || alpha <= 0.f;
        }
        if (ends) {  // the ray picks up the sky along its direction
          if (!DYN) {
            const float aw = alpha * w;
            ir = ir + sky_ray[3 * r] * aw;
            ig = ig + sky_ray[3 * r + 1] * aw;
            ib = ib + sky_ray[3 * r + 2] * aw;
            tw = tw + w;
          }
          break;
        }
      }
    }
  }
  incoming[3 * c] = ir;
  incoming[3 * c + 1] = ig;
  incoming[3 * c + 2] = ib;
  total[c] = tw;
}

}  // namespace

extern "C" int aic_relight_pass(
    const void* contents, const void* light_rgb, const void* face_rows,
    const void* dir_weights, const void* alpha0, const void* origin_opaque,
    const void* sky_faces, const void* cosines, const void* sky_ray,
    const void* ray_start, const void* pair_off, const void* pair_face,
    const void* pair_end, void* incoming, void* total, int X, int Y, int Z,
    int R, int dyn, void* stream) {
  const int threads = 128;
  const int n = X * Y * Z;
  const int blocks = (n + threads - 1) / threads;
  if (n > 0) {
    auto kernel = dyn ? relight_pass_kernel<true> : relight_pass_kernel<false>;
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(contents), static_cast<const float*>(light_rgb),
        static_cast<const float*>(face_rows), static_cast<const float*>(dir_weights),
        static_cast<const float*>(alpha0), static_cast<const bool*>(origin_opaque),
        static_cast<const float*>(sky_faces), static_cast<const float*>(cosines),
        static_cast<const float*>(sky_ray), static_cast<const int32_t*>(ray_start),
        static_cast<const int32_t*>(pair_off), static_cast<const int32_t*>(pair_face),
        static_cast<const uint8_t*>(pair_end), static_cast<float*>(incoming),
        static_cast<float*>(total), X, Y, Z, R);
  }
  return static_cast<int>(cudaGetLastError());
}
