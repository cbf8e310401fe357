// Copy of aic_tpu/native/ref_relight.cpp, built by aic_tpu_torch/native/__init__.py.
//
// Reference-procedure light evaluation, in C++, as the perf DENOMINATOR
// for the "relight >= 10x faster than reference evaluate_light" target
// (BASELINE.md). The reference publishes no absolute numbers and this
// image has no Rust toolchain, so we re-implement the reference's
// algorithm faithfully and measure it on this host's CPU:
//
//   - fast_evaluate_light seed (updater.rs:531-576): column scan from +Y,
//     queue visible/adjacent cubes at Priority::ESTIMATED.
//   - evaluate_light(epsilon=1) (space.rs:1494): pop cubes in priority
//     order, compute each via the 602-ray chart walk (updater.rs:362
//     compute_light / LightBuffer::traverse, updater.rs:755-880), apply,
//     guess-fill uninitialized neighbors (updater.rs:307-335), re-enqueue
//     ray-walk dependencies at Priority::from_difference when the packed
//     difference exceeds 1 (updater.rs:343-354, queue.rs:47).
//   - The reference's threaded updater computes batches of 32 pops in
//     parallel from the same pre-batch field (updater.rs:205-246,
//     `data: [Calc; 32]` on rayon); we do the same with OpenMP.
//
// Conservative-for-the-reference choices (they make the measured
// denominator SMALLER, i.e. understate our speedup): the loop stops as
// soon as max queue priority <= from_difference(epsilon)=1, skipping the
// priority-1 tail the reference still pops in 0.25 s chunks; bucket
// order within a priority is insertion order (no hash overhead).
//
// Chart tables, scene tables, and packed-light encoding are byte-
// identical to what the device kernel uses (light/chart.py,
// space/state.py, math/lightpack.py) so both sides solve the same
// problem instance.

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint8_t STATUS_UNINITIALIZED = 0;
constexpr uint8_t STATUS_NO_RAYS = 1;
constexpr uint8_t STATUS_OPAQUE = 128;
constexpr uint8_t STATUS_VISIBLE = 255;
constexpr uint8_t PRIORITY_ESTIMATED = 200;

constexpr int STEP_END = 1;
constexpr int STEP_PAD = 2;

const int FACE_NORMALS[6][3] = {
    {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}};

// data.rs:222: u8 log scale -> linear.
inline float decode_scalar(uint8_t u) {
  if (u == 0) return 0.0f;
  return std::exp2((float(u) - 144.0f) / 10.0f);
}

// data.rs:213: linear -> u8 log scale (round, saturating).
inline uint8_t encode_scalar(float v) {
  if (!(v > 0.0f)) return 0;
  float raw = std::round(std::log2(v) * 10.0f + 144.0f);
  if (raw < 0.0f) return 0;
  if (raw > 255.0f) return 255;
  return (uint8_t)raw;
}

struct Ctx {
  int sx, sy, sz;
  const int32_t* contents;
  const uint8_t* pal_visible;
  const uint8_t* pal_opaque_all;
  const float* face_rows;     // [P*6*8] rgba, flags, emission[3]
  const float* pal_emission;  // [P*3]
  const float* pal_mean_alpha;
  const float* sky_faces;  // [6*3]
  int n_rays, max_steps;
  const int8_t* offsets;    // [R*S*3]
  const uint8_t* faces_in;  // [R*S]
  const uint8_t* kinds;     // [R*S]
  const float* cosines;     // [R*6]
  std::vector<float> sky_ray;  // [R*3] per-ray sky sample

  uint8_t* light;  // [n*4]

  int n() const { return sx * sy * sz; }
  bool inside(int x, int y, int z) const {
    return x >= 0 && x < sx && y >= 0 && y < sy && z >= 0 && z < sz;
  }
  int flat(int x, int y, int z) const { return (x * sy + y) * sz + z; }

  // Stored light .value() with BlockSky::light_outside semantics
  // (update.py _gather_light_rgb): OOB face-adjacent -> sky face, else 0.
  void light_rgb(int x, int y, int z, float out[3]) const {
    if (inside(x, y, z)) {
      const uint8_t* t = light + 4 * flat(x, y, z);
      out[0] = decode_scalar(t[0]);
      out[1] = decode_scalar(t[1]);
      out[2] = decode_scalar(t[2]);
      return;
    }
    int pos[3] = {x, y, z}, size[3] = {sx, sy, sz};
    int n_out = 0, face = -1;
    for (int a = 0; a < 3; a++) {
      if (pos[a] < 0 || pos[a] >= size[a]) n_out++;
      if (pos[a] == -1) face = (face < 0) ? a : face;
      if (pos[a] == size[a]) face = (face < 0) ? a + 3 : face;
    }
    bool adjacent = face >= 0 &&
                    ((face < 3 && pos[face] == -1) ||
                     (face >= 3 && pos[face - 3] == size[face - 3]));
    if (n_out == 1 && adjacent) {
      out[0] = sky_faces[face * 3 + 0];
      out[1] = sky_faces[face * 3 + 1];
      out[2] = sky_faces[face * 3 + 2];
    } else {
      out[0] = out[1] = out[2] = 0.0f;
    }
  }
};

struct Computed {
  int cube;
  uint8_t value[4];
  std::vector<int32_t> deps;  // flat cube indices whose light the walk read
};

// compute_light (updater.rs:362) for one cube; scalar mirror of
// light/update.py relight_batch.
void compute_light(const Ctx& c, int cube, Computed& out) {
  out.cube = cube;
  out.deps.clear();
  int x = cube / (c.sy * c.sz), y = (cube / c.sz) % c.sy, z = cube % c.sz;
  int idx0 = c.contents[cube];
  bool origin_opaque = c.pal_opaque_all[idx0];
  bool origin_visible = c.pal_visible[idx0];
  const float* emission0 = c.pal_emission + idx0 * 3;
  bool origin_emissive =
      emission0[0] != 0 || emission0[1] != 0 || emission0[2] != 0;

  if (origin_opaque) {
    if (origin_emissive) {
      out.value[0] = encode_scalar(emission0[0]);
      out.value[1] = encode_scalar(emission0[1]);
      out.value[2] = encode_scalar(emission0[2]);
      out.value[3] = STATUS_VISIBLE;
    } else {
      out.value[0] = out.value[1] = out.value[2] = 0;
      out.value[3] = STATUS_OPAQUE;
    }
    return;
  }

  // directions_to_seek_light (updater.rs:663).
  float dir_w[6];
  for (int f = 0; f < 6; f++) {
    if (origin_visible) {
      dir_w[f] = 1.0f;
    } else {
      int nx = x + FACE_NORMALS[f][0], ny = y + FACE_NORMALS[f][1],
          nz = z + FACE_NORMALS[f][2];
      int opp = (f + 3) % 6;
      int nxo = x + FACE_NORMALS[opp][0], nyo = y + FACE_NORMALS[opp][1],
          nzo = z + FACE_NORMALS[opp][2];
      bool opp_visible =
          c.inside(nxo, nyo, nzo) &&
          c.pal_visible[c.contents[c.flat(nxo, nyo, nzo)]];
      bool n_emissive = false;
      if (c.inside(nx, ny, nz)) {
        const float* e = c.pal_emission + c.contents[c.flat(nx, ny, nz)] * 3;
        n_emissive = e[0] != 0 || e[1] != 0 || e[2] != 0;
      }
      dir_w[f] = (opp_visible || n_emissive) ? 1.0f : 0.0f;
    }
  }

  float mean_alpha = c.pal_mean_alpha[idx0];
  if (mean_alpha < 0) mean_alpha = 0;
  if (mean_alpha > 1) mean_alpha = 1;
  bool root_pickup = origin_visible && mean_alpha < 1.0f;

  double incoming[3] = {0, 0, 0};
  double total_w = 0.0;

  for (int r = 0; r < c.n_rays; r++) {
    const float* cosr = c.cosines + r * 6;
    float ray_w = 0.0f;
    for (int f = 0; f < 6; f++) ray_w += dir_w[f] * cosr[f];
    if (root_pickup) {
      incoming[0] += double(emission0[0]) * ray_w;
      incoming[1] += double(emission0[1]) * ray_w;
      incoming[2] += double(emission0[2]) * ray_w;
    }
    if (ray_w <= 0.0f) continue;
    float alpha = root_pickup ? 1.0f - mean_alpha : 1.0f;

    const int8_t* offs = c.offsets + r * c.max_steps * 3;
    const uint8_t* fins = c.faces_in + r * c.max_steps;
    const uint8_t* knds = c.kinds + r * c.max_steps;
    for (int s = 0; s < c.max_steps; s++) {
      int kind = knds[s];
      if (kind == STEP_PAD) break;  // chart guarantees END before PAD
      int px = x + offs[s * 3 + 0], py = y + offs[s * 3 + 1],
          pz = z + offs[s * 3 + 2];
      bool in = c.inside(px, py, pz);
      if (kind == STEP_END || !in) {  // end_of_ray (updater.rs:895)
        const float* sky = c.sky_ray.data() + r * 3;
        incoming[0] += double(sky[0]) * alpha * ray_w;
        incoming[1] += double(sky[1]) * alpha * ray_w;
        incoming[2] += double(sky[2]) * alpha * ray_w;
        total_w += ray_w;
        break;
      }
      int f_in = fins[s];
      int idx = c.contents[c.flat(px, py, pz)];
      const float* row = c.face_rows + (idx * 6 + f_in) * 8;
      float flags = row[4];
      bool visible = flags >= 2.0f;
      if (visible) {
        float hit_alpha = row[3];
        if (hit_alpha < 0) hit_alpha = 0;
        if (hit_alpha > 1) hit_alpha = 1;
        bool opaque_f = std::fmod(flags, 2.0f) >= 1.0f;
        bool hit_opaque = false;
        if (hit_alpha > 0.0f) {  // struck face (updater.rs:794-838)
          int bx = px + FACE_NORMALS[f_in][0], by = py + FACE_NORMALS[f_in][1],
              bz = pz + FACE_NORMALS[f_in][2];
          float behind[3];
          c.light_rgb(bx, by, bz, behind);
          if (c.inside(bx, by, bz)) out.deps.push_back(c.flat(bx, by, bz));
          for (int k = 0; k < 3; k++) {
            float refl = row[k];  // hit_surface_color.clamp()
            if (refl < 0) refl = 0;
            if (refl > 1) refl = 1;
            incoming[k] +=
                double(row[5 + k] + refl * behind[k] * hit_alpha) * alpha *
                ray_w;
          }
          hit_opaque = opaque_f;
          if (!hit_opaque) alpha *= (1.0f - hit_alpha);
        }
        if (hit_alpha < 1.0f && !hit_opaque) {  // pass-through (:852-874)
          float own[3];
          c.light_rgb(px, py, pz, own);
          out.deps.push_back(c.flat(px, py, pz));
          for (int k = 0; k < 3; k++)
            incoming[k] +=
                double(row[5 + k] + own[k] * hit_alpha) * alpha * ray_w;
          alpha *= (1.0f - hit_alpha);
        }
        if (hit_opaque) {
          total_w += ray_w;
          break;
        }
        if (alpha <= 0.0f) {
          total_w += ray_w;
          break;
        }
      }
    }
  }

  // finish (updater.rs:925).
  double denom = total_w > 1.0 ? total_w : 1.0;
  if (total_w > 0.0) {
    out.value[0] = encode_scalar(float(incoming[0] / denom));
    out.value[1] = encode_scalar(float(incoming[1] / denom));
    out.value[2] = encode_scalar(float(incoming[2] / denom));
    out.value[3] = STATUS_VISIBLE;
  } else {
    out.value[0] = out.value[1] = out.value[2] = 0;
    out.value[3] = STATUS_NO_RAYS;
  }
}

// data.rs:193 difference_priority.
inline int difference_priority(const uint8_t* a, const uint8_t* b) {
  int d = 0;
  for (int k = 0; k < 3; k++) {
    int x = std::abs(int(a[k]) - int(b[k]));
    if (x > d) d = x;
  }
  if (a[3] != b[3]) d = d + 63 > 255 ? 255 : d + 63;
  return d;
}

struct Queue {
  // 256 lazy-deletion buckets + per-cube stored priority.
  std::vector<std::vector<int32_t>> buckets;
  std::vector<uint8_t> prio;
  int max_p = 0;
  Queue(int n) : buckets(256), prio(n, 0) {}
  void insert(int cube, uint8_t p) {
    if (p <= prio[cube]) return;
    prio[cube] = p;
    buckets[p].push_back(cube);
    if (p > max_p) max_p = p;
  }
  // Pop up to `want` cubes at the current max priority; returns count.
  int pop_batch(int32_t* out, int want, int min_keep) {
    while (max_p > min_keep) {
      auto& b = buckets[max_p];
      int got = 0;
      while (got < want && !b.empty()) {
        int cube = b.back();
        b.pop_back();
        if (prio[cube] == max_p) {  // not superseded
          prio[cube] = 0;
          out[got++] = cube;
        }
      }
      if (got > 0) return got;
      max_p--;
    }
    return 0;
  }
};

}  // namespace

extern "C" {

// Runs fast_evaluate_light + evaluate_light(1) on the given scene;
// returns elapsed seconds for the evaluate_light phase (= the reference
// criterion bench "eval/full", which starts from the fast seed that
// set_physics installs). out_stats: [updates, threads]. out_light
// (u8[n*4], optional) receives the final field for validation.
double ref_relight_run(
    int sx, int sy, int sz, const int32_t* contents, int n_pal,
    const uint8_t* pal_visible, const uint8_t* pal_opaque_all,
    const float* face_rows, const float* pal_emission,
    const float* pal_mean_alpha, const float* sky_faces, int n_rays,
    int max_steps, const int8_t* offsets, const uint8_t* faces_in,
    const uint8_t* kinds, const float* cosines, int64_t* out_stats,
    uint8_t* out_light) {
  (void)n_pal;
  Ctx c{sx,       sy,           sz,          contents, pal_visible,
        pal_opaque_all, face_rows, pal_emission, pal_mean_alpha,
        sky_faces, n_rays,       max_steps,   offsets,  faces_in,
        kinds,    cosines,      {},          nullptr};
  int n = c.n();

  // Per-ray sky sample (end_of_ray, updater.rs:895; chart.py deviation
  // note: ray's own cosines).
  c.sky_ray.resize(n_rays * 3);
  for (int r = 0; r < n_rays; r++) {
    const float* cosr = cosines + r * 6;
    float cs = 0;
    float acc[3] = {0, 0, 0};
    for (int f = 0; f < 6; f++) {
      cs += cosr[f];
      for (int k = 0; k < 3; k++) acc[k] += cosr[f] * sky_faces[f * 3 + k];
    }
    for (int k = 0; k < 3; k++) c.sky_ray[r * 3 + k] = acc[k] / cs;
  }

  std::vector<uint8_t> light(n * 4);
  c.light = light.data();
  Queue q(n);

  // ---- fast_evaluate_light (updater.rs:531-576) -------------------------
  uint8_t sky_py[4] = {encode_scalar(sky_faces[4 * 3 + 0]),
                       encode_scalar(sky_faces[4 * 3 + 1]),
                       encode_scalar(sky_faces[4 * 3 + 2]), STATUS_VISIBLE};
  std::vector<uint8_t> opaque_flc(n), vis(n);
  for (int i = 0; i < n; i++) {
    int idx = contents[i];
    const float* e = pal_emission + idx * 3;
    bool emissive = e[0] != 0 || e[1] != 0 || e[2] != 0;
    opaque_flc[i] = pal_opaque_all[idx] && !emissive;
    vis[i] = pal_visible[idx];
  }
  for (int x = 0; x < sx; x++)
    for (int z = 0; z < sz; z++) {
      bool covered = false;
      for (int y = sy - 1; y >= 0; y--) {
        int i = c.flat(x, y, z);
        uint8_t* L = light.data() + i * 4;
        bool adj = false;
        for (int f = 0; f < 6 && !adj; f++) {
          int nx = x + FACE_NORMALS[f][0], ny = y + FACE_NORMALS[f][1],
              nz = z + FACE_NORMALS[f][2];
          adj = c.inside(nx, ny, nz) && vis[c.flat(nx, ny, nz)];
        }
        if (opaque_flc[i]) {
          L[0] = L[1] = L[2] = 0;
          L[3] = STATUS_OPAQUE;
          covered = true;
        } else if (vis[i] || adj) {
          if (covered) {
            L[0] = L[1] = L[2] = 0;
            L[3] = STATUS_UNINITIALIZED;
          } else {
            std::memcpy(L, sky_py, 4);
          }
          q.insert(i, PRIORITY_ESTIMATED);
        } else {
          L[0] = L[1] = L[2] = 0;
          L[3] = STATUS_NO_RAYS;
        }
      }
    }

  // ---- evaluate_light(epsilon=1) ---------------------------------------
  auto t0 = std::chrono::steady_clock::now();
  int64_t updates = 0;
  constexpr int BATCH = 32;  // updater.rs:205 `data: [Calc; 32]`
  int32_t batch[BATCH];
  std::vector<Computed> comp(BATCH);
  int threads = 1;
#ifdef _OPENMP
  threads = omp_get_max_threads();
#endif

  // Stop when max priority <= from_difference(1) = 1 (queue.rs:47).
  while (true) {
    int got = q.pop_batch(batch, BATCH, 1);
    if (got == 0) break;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int j = 0; j < got; j++) compute_light(c, batch[j], comp[j]);
    for (int j = 0; j < got; j++) {  // apply serially (updater.rs:240)
      updates++;
      int cube = comp[j].cube;
      uint8_t* old = light.data() + cube * 4;
      int diff = difference_priority(comp[j].value, old);
      if (diff == 0) continue;
      std::memcpy(old, comp[j].value, 4);
      // Guess-fill uninitialized neighbors (updater.rs:312-335).
      int x = cube / (sy * sz), y = (cube / sz) % sy, z = cube % sz;
      for (int f = 0; f < 6; f++) {
        int nx = x + FACE_NORMALS[f][0], ny = y + FACE_NORMALS[f][1],
            nz = z + FACE_NORMALS[f][2];
        if (!c.inside(nx, ny, nz)) continue;
        int ni = c.flat(nx, ny, nz);
        uint8_t* nl = light.data() + ni * 4;
        if (nl[3] == STATUS_UNINITIALIZED && !pal_opaque_all[contents[ni]]) {
          std::memcpy(nl, comp[j].value, 3);
          nl[3] = STATUS_UNINITIALIZED;  // PackedLight::guess
        }
      }
      if (diff > 1) {
        uint8_t p = uint8_t(diff / 2 + 1);
        for (int32_t dep : comp[j].deps) q.insert(dep, p);
      }
    }
  }
  double dt = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
                  .count();
  out_stats[0] = updates;
  out_stats[1] = threads;
  if (out_light) std::memcpy(out_light, light.data(), size_t(n) * 4);
  return dt;
}
}
