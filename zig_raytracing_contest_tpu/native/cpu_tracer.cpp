// Native CPU path tracer: the reference-equivalent baseline renderer.
//
// Purpose (BASELINE.md): the reference publishes no numbers and its Zig
// toolchain is not available here, so the "10x the CPU build" target needs
// a measured denominator.  This is a faithful C++
// re-implementation of the reference's render stage — fork-join threads
// over contiguous pixel blocks (src/stage3.zig:222-256), per-ray grid DDA
// (src/linalg.zig:443-498), Moller-Trumbore with back-face culling
// (src/linalg.zig:696-722), bilinear textures with the frac-of-raw-uv quirk
// (src/stage3.zig:82-123), stochastic alpha and diffuse scatter
// (src/stage3.zig:188-220) — driven by the same baked scene arrays as the
// device path.
//
// It uses OUR counter-hash RNG (ops/rng.py) instead of the reference's
// per-thread sequential PRNG, so its output is directly comparable to the
// device renderer (tests/test_native_tracer.py pins the images near-equal);
// the reference's own output depends on thread count and is irreproducible
// by design (src/stage3.zig:225).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see render/native_cpu.py).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float kInf = __builtin_inff();
constexpr float kMtEps = 1e-8f;       // src/linalg.zig:701
constexpr float kFltEps = 1.1920929e-7f;  // std.math.floatEps(f32)

struct V3 {
  float x, y, z;
};

inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline V3 normalize(V3 a) {
  float inv = 1.0f / std::sqrt(dot(a, a));
  return mul(a, inv);
}
inline V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// ---- counter-hash RNG, bit-identical to ops/rng.py ----
inline uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
inline uint32_t stream_of(uint32_t seed, uint32_t gid) {
  return mix(gid ^ (seed * 0x9E3779B9u) ^ 0x85EBCA6Bu);
}
inline uint32_t bits(uint32_t stream, uint32_t tag, uint32_t word) {
  uint32_t t = tag * 2u + 1u;
  uint32_t w = word * 0x9E3779B9u + 0x6A09E667u;
  return mix(stream ^ (t * 0xB5297A4Du) ^ w);
}
inline float u01(uint32_t b) {
  return (static_cast<float>(b >> 8) + 0.5f) * (1.0f / 16777216.0f);
}
constexpr float kTwoPi = 6.283185307179586f;

// ---- bilinear texture sampling (ops/texture.py float-math semantics) ----
// desc: [offset, w, h, u_lo, u_hi, v_lo, v_hi] as f32 (repeat = lo < 0).
inline void texel_pair(float c, float size_f, float lo, float hi,
                       int32_t* c1, int32_t* c2) {
  if (lo < 0.0f) {  // repeat
    float fc = c - std::floor(c);
    float r1 = std::fmin(std::floor(size_f * fc), size_f - 1.0f);
    float r2 = r1 + 1.0f;
    if (r2 >= size_f) r2 -= size_f;
    *c1 = static_cast<int32_t>(r1);
    *c2 = static_cast<int32_t>(r2);
  } else {  // clamp
    float cc = std::floor(size_f * std::fmin(std::fmax(c, -2.147e9f), 2.147e9f));
    *c1 = static_cast<int32_t>(std::fmin(std::fmax(cc, lo), hi));
    *c2 = static_cast<int32_t>(std::fmin(std::fmax(cc + 1.0f, lo), hi));
  }
}

inline void sample_texture(const float* bank, const float* desc, float u,
                           float v, float out[4]) {
  int32_t off = static_cast<int32_t>(desc[0]);
  int32_t w = static_cast<int32_t>(desc[1]);
  int32_t x1, x2, y1, y2;
  texel_pair(u, desc[1], desc[3], desc[4], &x1, &x2);
  texel_pair(v, desc[2], desc[5], desc[6], &y1, &y2);
  float fu = std::fabs(u - std::trunc(u));  // frac-of-raw-uv quirk
  float fv = std::fabs(v - std::trunc(v));
  const float* p11 = bank + 4 * (off + y1 * w + x1);
  const float* p21 = bank + 4 * (off + y1 * w + x2);
  const float* p12 = bank + 4 * (off + y2 * w + x1);
  const float* p22 = bank + 4 * (off + y2 * w + x2);
  for (int c = 0; c < 4; ++c) {
    float r1 = p11[c] * (1.0f - fu) + p21[c] * fu;
    float r2 = p12[c] * (1.0f - fu) + p22[c] * fu;
    out[c] = r1 * (1.0f - fv) + r2 * fv;
  }
}

// ---- scene ----
struct Scene {
  V3 bbox_min, cell_size;
  int32_t res[3];
  const int32_t* cell_begin;
  const int32_t* cell_end;
  const float* tri_v0;  // (D, 3) duplicated, DDA order
  const float* tri_e1;
  const float* tri_e2;
  const int32_t* dup_to_tri;
  const float* shade_table;  // (T, 32)
  const float* color_data;   // (P, 4)
};

struct Hit {
  float t, u, v;
  int32_t tri;  // unique triangle id
};

// Branchless-sign slab test returning entry t (src/linalg.zig:324-349).
inline bool slab(V3 o, V3 d, V3 bmin, V3 bmax, float* t_entry) {
  float nx = ((d.x < 0 ? bmax.x : bmin.x) - o.x) / d.x;
  float fx = ((d.x < 0 ? bmin.x : bmax.x) - o.x) / d.x;
  float ny = ((d.y < 0 ? bmax.y : bmin.y) - o.y) / d.y;
  float fy = ((d.y < 0 ? bmin.y : bmax.y) - o.y) / d.y;
  float nz = ((d.z < 0 ? bmax.z : bmin.z) - o.z) / d.z;
  float fz = ((d.z < 0 ? bmin.z : bmax.z) - o.z) / d.z;
  float tmin = nx, tmax = fx;
  if (tmin > fy || tmax < ny) return false;
  tmin = std::fmax(tmin, ny);
  tmax = std::fmin(tmax, fy);
  if (tmin > fz || tmax < nz) return false;
  tmin = std::fmax(tmin, nz);
  *t_entry = tmin;
  return true;
}

// Axis pick table (src/linalg.zig:483): index = (t0<t1)<<2 | (t0<t2)<<1 | (t1<t2).
constexpr int kAxisMap[8] = {2, 1, 2, 1, 2, 2, 0, 0};

// Grid DDA + MT nearest hit (src/stage3.zig:152-186 semantics).
// `exclude`: unique-space index of the ray's previous hit, which a
// continuation ray may never re-hit — a same-triangle re-hit from a point
// on the triangle's own plane is always a rounding phantom (the
// reference's t + floatEps nudge is a no-op at t >= 2); excluding it
// keeps this baseline deterministic and consistent with the device paths
// (ops/mxu_intersect.py EXCLUDE_PREV_HIT).
inline bool trace(const Scene& s, V3 o, V3 d, Hit* hit,
                  int32_t exclude = -1) {
  float t_entry;
  if (!slab(o, d, s.bbox_min,
            {s.bbox_min.x + s.cell_size.x * s.res[0],
             s.bbox_min.y + s.cell_size.y * s.res[1],
             s.bbox_min.z + s.cell_size.z * s.res[2]},
            &t_entry))
    return false;
  t_entry = std::fmax(0.0f, t_entry);

  float dir[3] = {d.x, d.y, d.z};
  float csz[3] = {s.cell_size.x, s.cell_size.y, s.cell_size.z};
  float bmn[3] = {s.bbox_min.x, s.bbox_min.y, s.bbox_min.z};
  float hitp[3] = {o.x + d.x * t_entry, o.y + d.y * t_entry,
                   o.z + d.z * t_entry};
  int32_t cell[3], exit_c[3], step[3];
  float t_delta[3], t_next[3];
  for (int a = 0; a < 3; ++a) {
    bool neg = dir[a] < 0.0f;
    step[a] = neg ? -1 : 1;
    exit_c[a] = neg ? 0 : s.res[a] - 1;
    t_delta[a] = std::fabs(csz[a] / dir[a]);
    float local = hitp[a] - bmn[a];
    int32_t c = static_cast<int32_t>(local / csz[a]);
    cell[a] = c < 0 ? 0 : (c >= s.res[a] ? s.res[a] - 1 : c);
    float next_cell = static_cast<float>(cell[a] + (neg ? 0 : 1));
    t_next[a] = t_entry + (next_cell * csz[a] - local) / dir[a];
  }

  float nearest = kInf;
  float nu = 0.0f, nv = 0.0f;
  int32_t ni = -1;

  for (;;) {
    int32_t lin = (cell[2] * s.res[1] + cell[1]) * s.res[0] + cell[0];
    int32_t begin = s.cell_begin[lin], end = s.cell_end[lin];
    for (int32_t i = begin; i < end; ++i) {
      V3 v0 = load3(s.tri_v0 + 3 * i);
      V3 e1 = load3(s.tri_e1 + 3 * i);
      V3 e2 = load3(s.tri_e2 + 3 * i);
      V3 pvec = cross(d, e2);
      float det = dot(e1, pvec);
      if (det < kMtEps) continue;  // back-face cull (src/linalg.zig:705)
      float inv_det = 1.0f / det;
      V3 tvec = sub(o, v0);
      float u = dot(tvec, pvec) * inv_det;
      if (u < 0.0f || u > 1.0f) continue;
      V3 qvec = cross(tvec, e1);
      float v = dot(d, qvec) * inv_det;
      if (v < 0.0f || u + v > 1.0f) continue;
      float t = dot(e2, qvec) * inv_det;
      if (t > 0.0f && t < nearest && s.dup_to_tri[i] != exclude) {
        nearest = t;
        nu = u;
        nv = v;
        ni = i;
      }
    }
    // advance (Iterator.next, src/linalg.zig:478-496)
    int k = ((t_next[0] < t_next[1]) << 2) | ((t_next[0] < t_next[2]) << 1) |
            (t_next[1] < t_next[2]);
    int axis = kAxisMap[k];
    if (cell[axis] == exit_c[axis]) break;  // grid exit: t_crossing = inf
    float t_cross = t_next[axis];
    if (nearest <= t_cross) break;  // settled before next cell
    cell[axis] += step[axis];
    t_next[axis] += t_delta[axis];
  }
  if (ni < 0) return false;
  hit->t = nearest;
  hit->u = nu;
  hit->v = nv;
  hit->tri = s.dup_to_tri[ni];
  return true;
}

// shade_table column layout (scene/types.py)
constexpr int kColNrm = 0, kColUv = 9, kColBase = 15, kColEmis = 23;

}  // namespace

extern "C" int64_t zrc_cpu_render(
    const float* cam,  // 12 floats: origin, lower_left, right, up
    int32_t width, int32_t height, int32_t spp, int32_t max_bounce,
    uint32_t seed, const float* bbox_min, const float* cell_size,
    const int32_t* resolution, const int32_t* cell_begin,
    const int32_t* cell_end, const float* tri_v0, const float* tri_e1,
    const float* tri_e2, const int32_t* dup_to_tri, const float* shade_table,
    const float* color_data, int32_t num_threads, float* framebuffer) {
  Scene s;
  s.bbox_min = load3(bbox_min);
  s.cell_size = load3(cell_size);
  std::memcpy(s.res, resolution, sizeof(s.res));
  s.cell_begin = cell_begin;
  s.cell_end = cell_end;
  s.tri_v0 = tri_v0;
  s.tri_e1 = tri_e1;
  s.tri_e2 = tri_e2;
  s.dup_to_tri = dup_to_tri;
  s.shade_table = shade_table;
  s.color_data = color_data;

  V3 origin = load3(cam), llc = load3(cam + 3);
  V3 right = load3(cam + 6), up = load3(cam + 9);
  int64_t num_pixels = static_cast<int64_t>(width) * height;
  int64_t segments = 0;

#if defined(_OPENMP)
  if (num_threads > 0) omp_set_num_threads(num_threads);
#endif

#pragma omp parallel for schedule(dynamic, 64) reduction(+ : segments)
  for (int64_t pix = 0; pix < num_pixels; ++pix) {
    float x = static_cast<float>(pix % width);
    float y = static_cast<float>(pix / width);
    V3 acc = {0, 0, 0};
    for (int32_t samp = 0; samp < spp; ++samp) {
      uint32_t g = static_cast<uint32_t>(pix * spp + samp);
      uint32_t stream = stream_of(seed, g);
      float jx = u01(bits(stream, 0, 0));
      float jy = u01(bits(stream, 0, 1));
      // Camera.getRay (src/stage3.zig:27-35)
      V3 d = normalize(
          add(llc, add(mul(right, x + jx), mul(up, y + jy))));
      V3 o = origin;
      V3 radiance = {0, 0, 0};
      V3 throughput = {1, 1, 1};
      int32_t prev = -1;  // previous-hit exclusion (see trace())
      for (int32_t b = 0; b < max_bounce; ++b) {
        ++segments;
        Hit hit;
        if (!trace(s, o, d, &hit, prev)) {
          // sky gradient (src/stage3.zig:144-150)
          float t = 0.5f * (d.y + 1.0f);
          radiance.x += throughput.x * (1.0f - 0.5f * t);
          radiance.y += throughput.y * (1.0f - 0.3f * t);
          radiance.z += throughput.z;
          break;
        }
        const float* rec = s.shade_table + 32 * hit.tri;
        prev = hit.tri;
        float w0 = 1.0f - hit.u - hit.v;
        float tcu = rec[kColUv + 0] * w0 + rec[kColUv + 2] * hit.u +
                    rec[kColUv + 4] * hit.v;
        float tcv = rec[kColUv + 1] * w0 + rec[kColUv + 3] * hit.u +
                    rec[kColUv + 5] * hit.v;
        float base[4], emis[4];
        sample_texture(s.color_data, rec + kColBase, tcu, tcv, base);
        sample_texture(s.color_data, rec + kColEmis, tcu, tcv, emis);

        // stochastic alpha (src/stage3.zig:207-213): both branches step
        // the origin past the hit and consume a bounce.
        float rnd = u01(bits(stream, 2 * b + 1, 0));
        float t_step = hit.t + kFltEps;
        o = add(o, mul(d, t_step));
        if (rnd > base[3]) continue;  // pass straight through

        radiance.x += throughput.x * emis[0];
        radiance.y += throughput.y * emis[1];
        radiance.z += throughput.z * emis[2];
        throughput.x *= base[0];
        throughput.y *= base[1];
        throughput.z *= base[2];

        // diffuse: dir = normalize(normal + randomUnitVector)
        // (src/stage3.zig:214-217; Gaussian sphere src/linalg.zig:140-148)
        V3 n = {rec[kColNrm + 0] * w0 + rec[kColNrm + 3] * hit.u +
                    rec[kColNrm + 6] * hit.v,
                rec[kColNrm + 1] * w0 + rec[kColNrm + 4] * hit.u +
                    rec[kColNrm + 7] * hit.v,
                rec[kColNrm + 2] * w0 + rec[kColNrm + 5] * hit.u +
                    rec[kColNrm + 8] * hit.v};
        uint32_t gt = 2 * b + 2;
        float u1 = u01(bits(stream, gt, 0));
        float u2 = u01(bits(stream, gt, 1));
        float u3 = u01(bits(stream, gt, 2));
        float u4 = u01(bits(stream, gt, 3));
        float r1 = std::sqrt(-2.0f * std::log(u1));
        float r2 = std::sqrt(-2.0f * std::log(u3));
        V3 gauss = {r1 * std::cos(kTwoPi * u2), r1 * std::sin(kTwoPi * u2),
                    r2 * std::cos(kTwoPi * u4)};
        d = normalize(add(n, normalize(gauss)));
      }
      acc = add(acc, radiance);
    }
    framebuffer[3 * pix + 0] = acc.x;
    framebuffer[3 * pix + 1] = acc.y;
    framebuffer[3 * pix + 2] = acc.z;
  }
  return segments;
}
