// Mass-splitting Jacobi contact solve of the transposed contact pipeline,
// for Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// `solve_contacts_t` (banggameengine_tpu/physics/contact_t.py) into a few
// loops.  In the port its plain version, `solve_contacts_t_reference` in
// physics/contact_t.py, dispatches ~150 ATen kernels of set-up and ~180 an
// iteration over [C, N] planes (~2,000 a solve of 10 iterations), each one
// launch's latency; this file computes the same function in
// `iterations + 1` launches: one set-up, then one launch a Jacobi sweep.
// With the contact cache given (the all-pairs and static routes of
// physics/step.py), the set-up also matches the warm impulses by feature
// id (`solve_kernel.cached_warm_start`'s one-hot [C, CB, 3, N] sum) and
// the last launch writes the refreshed cache
// (`solve_kernel.refreshed_cache`).
//
// Per contact slot (c, n) of body n (partner c_prt, the ground where < 0):
//   - set-up: the world inverse inertia of both bodies, the lever arms
//     ra and rb, friction and restitution of the pair, the tangents, the
//     effective masses kn, kt1, kt2 and the bias target (restitution
//     bounce or Baumgarte), the warm impulses where given; per body the
//     mass-splitting count of its valid slots, and the warm impulses'
//     velocity change;
//   - each sweep: the relative velocity from the velocities at the
//     sweep's start (the body's own and its partner's), the normal and
//     friction updates of the accumulated impulses (the heavy-ball term
//     with `momentum`), and the body's velocity change by the sum of its
//     slots' impulse increments.  A body writes only its own velocity, and
//     reads only the sweep's input, so a sweep reads one velocity buffer
//     and writes the other.
//
// Exactness: each float is the plain version's expression in its order of
// evaluation, built with --fmad=false (no multiply-add contraction), IEEE
// sqrtf and division, `1.0f / x` where PyTorch takes a reciprocal, and the
// constants' f32 roundings, as PyTorch rounds a Python float against an f32
// tensor.  Sums over the slots follow ATen's reduction of a [C, N] plane
// over dim 0 (one thread an output, four accumulators taking slots c % 4,
// then combined in order: ((a0 + a1) + a2) + a3; ATen keeps that order up
// to at least C = 40 on the card, and the wrapper refuses a wider budget),
// so every output equals the plain version's bit for bit where a body's
// cached feature ids are unique (see cached_impulse).  An invalid slot's
// terms are signed zeros where its normal, tangents and lever arm are
// finite, and adding a signed zero leaves such a sum as it is (a sum that
// starts at +0 never reads -0), so the sweeps skip those slots; the set-up
// marks the others, whose terms are not finite, and the sweeps add them
// as the plain version does.
//
// Design: a block is 32 bodies x 16 slot lanes, a lane taking one slot of
// each chunk of 16, where the grid gives the card's SMs fewer than two
// blocks each (the settled pile: latency, so more threads in flight), else
// 32 x 8 lanes of two slots (the rollout: fewer threads, less overhead a
// slot).  A lane leaves its slots' 6 impulse and torque terms in shared
// memory, and after the barrier 6 lanes a body sum one term each in slot
// order.  An invalid slot costs the set-up its tangents and lever arm
// only, and a sweep one byte.
// The per-slot constants live in a [17, C, N] scratch written by the
// set-up beside a [C, N] byte plane of each slot's mode (skipped, valid,
// invalid with terms to add), the impulses in [3, C, N] (their previous
// iterates in another, with momentum), all coalesced along N; velocities
// ping-pong between two [N, 3] pairs, the last written pair being the
// result.
//
// What bounds it on the card: the least work of a solve reads its inputs
// once and writes its outputs once (~2.8 MB at the settled pile, N = 3,008
// and C = 12; ~61 MB at the rollout's N = 65,536), about as many
// microseconds at peak as ~0.8 and ~18, against ~100 f32 operations a
// valid slot a sweep and ~500 its set-up (~26 and ~98 M): bytes.
// A sweep itself reads ~1 byte a skipped slot and ~125 a valid one, so it
// is latency (the launch, the mode byte, then the slot's rows and its
// partner's velocity, two barriers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBodies = 32;          // bodies a block (threadIdx.x)
constexpr int kChunk = 16;           // slots a pass (a multiple of 4)
constexpr int kTerms = 6;            // impulse x, y, z, torque x, y, z
// slot lanes a body (threadIdx.y): 16 (a slot a lane) where the grid is
// small, 8 (two slots a lane) where it fills the card many times over
constexpr int kWideLanes = 16, kNarrowLanes = 8;

constexpr float kBaumgarte = 0.2f;         // == solver.BAUMGARTE
constexpr float kSlop = 0.005f;            // == solver.PENETRATION_SLOP
constexpr float kRestThreshold = 1.0f;     // == solver.RESTITUTION_THRESHOLD
constexpr float kWarmFactor = 0.85f;       // == solver.WARM_START_FACTOR

// planes of the [kSlotPlanes, C, N] scratch
enum SlotPlane {
  kT1x, kT1y, kT1z, kT2x, kT2y, kT2z, kRax, kRay, kRaz, kRbx, kRby, kRbz,
  kKn, kKt1, kKt2, kTarget, kMu, kSlotPlanes
};
// planes of the [kBodyPlanes, N] scratch: the world inverse inertia, then
// inv_m / count and 1 / count
enum BodyPlane { kInvSplitM = 6, kInvSplit, kBodyPlanes };
// a slot's mode in the sweeps
enum Mode : uint8_t { kSkip, kValid, kAddTerms };

struct Args {
  const float* vel; int vel_stride;     // [N, 3] rows
  const float* ang; int ang_stride;
  const float* pos; int pos_stride;
  const float* quat; int quat_stride;   // [N, 4] rows
  const float* inertia; int inertia_stride;   // body-frame diagonal
  const float* inv_m; int inv_m_stride;       // [N] with a stride
  const float* friction; int friction_stride;
  const float* restitution; int restitution_stride;
  const int* prt;                       // [C, N] contiguous
  const float* pt[3];
  const float* nrm[3];
  const float* dep;
  const uint8_t* valid;
  const float* warm[3]; int warm_stride;   // [C, N] rows, or null
  // the contact cache, or null: this step's feature ids [C, N], the cached
  // ids [CB, N] and impulses [CB, 3, N] (element strides), and the
  // refreshed cache written at the end, ids [N, C] and impulses [N, C, 3]
  const int* c_feat;
  const int* cache_feat; int cf_stride_b, cf_stride_n;
  const float* cache_imp; int ci_stride_b, ci_stride_k, ci_stride_n;
  int cb;
  int* feat_out;
  float* imp_out;
  const float* dt;                          // f32[]
  int n, c;
  float ground_friction, momentum;
  int use_momentum;
  float* slots;   // [kSlotPlanes, C, N]
  uint8_t* mode;  // [C, N]
  float* body;    // [kBodyPlanes, N]
  float* lam;     // [3, C, N]: ln, lt1, lt2
  float* prev;    // [3, C, N]: their previous iterates (momentum only)
};

struct Pair {     // a velocity buffer: [N, 3] rows
  const float* v; int v_stride;
  const float* w; int w_stride;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);            // ATen's clamp_min
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;                        // ATen's clamp
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  if (isnan(a)) return a;                        // ATen's maximum
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// contact_t._sym_mul: (symmetric 3x3 as i00, i01, i02, i11, i12, i22) @ v
__device__ __forceinline__ void sym_mul(const float* i6, const float* v,
                                        float* o) {
  o[0] = i6[0] * v[0] + i6[1] * v[1] + i6[2] * v[2];
  o[1] = i6[1] * v[0] + i6[3] * v[1] + i6[4] * v[2];
  o[2] = i6[2] * v[0] + i6[4] * v[1] + i6[5] * v[2];
}

__device__ __forceinline__ void load3(const float* base, int stride, int i,
                                      float* o) {
  const float* p = base + static_cast<long long>(i) * stride;
  o[0] = p[0], o[1] = p[1], o[2] = p[2];
}

__device__ __forceinline__ float load1(const float* base, int stride,
                                       int i) {
  return base[static_cast<long long>(i) * stride];
}

__device__ __forceinline__ bool finite3(const float* v) {
  return isfinite(v[0]) && isfinite(v[1]) && isfinite(v[2]);
}

// contact_t._inertia_world_comps of body i: R diag(d) R^T, R from
// math3d.quat_to_mat3
__device__ void inertia_world(const Args& a, int i, float* i6) {
  const float* q = a.quat + static_cast<long long>(i) * a.quat_stride;
  float d[3];
  load3(a.inertia, a.inertia_stride, i, d);
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float m[9] = {
      1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy),
      2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx),
      2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)};
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int r = 3 * ij[e][0], s = 3 * ij[e][1];
    i6[e] = m[r] * d[0] * m[s] + m[r + 1] * d[1] * m[s + 1]
            + m[r + 2] * d[2] * m[s + 2];
  }
}

// The effective mass along d (contact_t's k_along), at least 1e-9.
__device__ float k_along(const float* d, const float* ra, const float* rb,
                         const float* ia, const float* ib, float im_a,
                         float im_b) {
  float t[3], u[3], ka[3], kb[3];
  cross(ra, d, t);
  sym_mul(ia, t, u);
  cross(u, ra, ka);
  cross(rb, d, t);
  sym_mul(ib, t, u);
  cross(u, rb, kb);
  return clamp_min(im_a + im_b + dot(d, ka) + dot(d, kb), 1e-9f);
}

// The relative velocity at the contact: (v + w x ra) - gv - gw x rb, the
// partner's (gv, gw) zero for the ground.
__device__ __forceinline__ void rel_vel(const float* v, const float* w,
                                        const float* gv, const float* gw,
                                        const float* ra, const float* rb,
                                        float* r) {
  float ca[3], cb[3];
  cross(w, ra, ca);
  cross(gw, rb, cb);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = v[k] + ca[k] - gv[k] - cb[k];
}

// The partner's velocity from `src`, zero for the ground (c_prt < 0).
__device__ __forceinline__ void partner_vel(const Pair& src, int prt, int n,
                                            float* gv, float* gw) {
  if (prt >= n) __trap();     // the plain version's gather faults there too
  if (prt < 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) gv[k] = 0.0f, gw[k] = 0.0f;
  } else {
    load3(src.v, src.v_stride, prt, gv);
    load3(src.w, src.w_stride, prt, gw);
  }
}

// A slot's terms: the impulse (l0 n + l1 t1) + l2 t2 and its torque ra x
// impulse.
__device__ __forceinline__ void impulse_terms(float l0, float l1, float l2,
                                              const float* nr,
                                              const float* t1,
                                              const float* t2,
                                              const float* ra, float* t) {
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = l0 * nr[k] + l1 * t1[k] + l2 * t2[k];
  cross(ra, t, t + 3);
}

// solve_kernel.cached_warm_start of slot (c, n): the cached impulses whose
// feature id equals this contact's, as the sum over the cache's slots of
// the one-hot match times the impulse.  A body's cached ids are unique but
// for -1, which never matches (the step keeps them so), so at most one term
// is not a signed zero and the sum is that term in any order.  Where an id
// repeats, the matched impulses are summed in slot order, which the plain
// version's [C, CB, 3, N] product need not follow: equal up to the order
// of that sum's rounding.
__device__ void cached_impulse(const Args& a, size_t cn, int n, float* w) {
  const int f = a.c_feat[cn];
  float acc[3][4] = {};
  for (int b0 = 0; b0 < a.cb; b0 += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + j;
      if (b < a.cb) {
        const long long fb = static_cast<long long>(b) * a.cf_stride_b +
                             static_cast<long long>(n) * a.cf_stride_n;
        const float eq = (f == a.cache_feat[fb] && f >= 0) ? 1.0f : 0.0f;
        const float* imp = a.cache_imp +
                           static_cast<long long>(b) * a.ci_stride_b +
                           static_cast<long long>(n) * a.ci_stride_n;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[k][j] += eq * imp[static_cast<long long>(k) * a.ci_stride_k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  }
}

// solve_kernel.refreshed_cache of slot (c, n): its feature id and impulses where
// valid, else -1 and zeros.
__device__ __forceinline__ void write_cache(const Args& a, size_t cn, int c,
                                            int n, bool ok, float l0,
                                            float l1, float l2) {
  const size_t row = static_cast<size_t>(n) * a.c + c;
  a.feat_out[row] = ok ? a.c_feat[cn] : -1;
  a.imp_out[3 * row] = ok ? l0 : 0.0f;
  a.imp_out[3 * row + 1] = ok ? l1 : 0.0f;
  a.imp_out[3 * row + 2] = ok ? l2 : 0.0f;
}

// The shared part of both kernels: each of a body's LANES lanes takes its
// slots of each chunk of kChunk and leaves their terms in `part`; lanes
// 0..5 sum term `lane` in slot order as ATen sums a [C, N] plane over dim 0,
// and the totals land in `sums`.
template <int LANES, typename SlotFn>
__device__ __forceinline__ void sum_slots(const Args& a, bool live,
                                          SlotFn slot_terms,
                                          float (&part)[kTerms][kChunk]
                                                       [kBodies],
                                          float (&sums)[kTerms][kBodies]) {
  static_assert(kChunk % 4 == 0 && kChunk % LANES == 0 && LANES >= kTerms,
                "a chunk keeps the four accumulators' slot groups whole");
  const int b = threadIdx.x, lane = threadIdx.y;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < a.c; c0 += kChunk) {
#pragma unroll
    for (int h = 0; h < kChunk / LANES; ++h) {
      const int j = lane + h * LANES;
      if (live && c0 + j < a.c) {
        float t[kTerms];
        slot_terms(c0 + j, t);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) part[k][j][b] = t[k];
      }
    }
    __syncthreads();
    if (live && lane < kTerms) {
      const int m = min(kChunk, a.c - c0);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < m) acc[j & 3] += part[lane][j][b];
      }
    }
    __syncthreads();
  }
  if (live && lane < kTerms) sums[lane][b] = acc[0] + acc[1] + acc[2] + acc[3];
  __syncthreads();
}

// The velocity update of body n from the summed terms, by lanes 0..5:
// lane k < 3 writes the linear velocity's component k, `own` being that
// component before the update and `inv` inv_m / count; lane 3 + k the
// angular one's, `own` its component and `inv` 1 / count.
__device__ __forceinline__ void write_body(int n, int lane, float own,
                                           const float* ia, float inv,
                                           const float (&sums)[kTerms]
                                                              [kBodies],
                                           float* vel_out, float* ang_out) {
  const int b = threadIdx.x;
  const long long row = static_cast<long long>(n) * 3;
  if (lane < 3) {
    vel_out[row + lane] = own + sums[lane][b] * inv;
  } else {
    const float tq[3] = {sums[3][b], sums[4][b], sums[5][b]};
    float iw[3];
    sym_mul(ia, tq, iw);
    ang_out[row + lane - 3] =
        own + (lane == 3 ? iw[0] : lane == 4 ? iw[1] : iw[2]) * inv;
  }
}

// The tangents of normal nr (the branchless helper of the plain version).
__device__ __forceinline__ void tangents(const float* nr, float* t1,
                                         float* t2) {
  const bool use_x = fabsf(nr[0]) < 0.7f;
  const float h[3] = {use_x ? 1.0f : 0.0f, use_x ? 0.0f : 1.0f, 0.0f};
  cross(nr, h, t1);
  const float t1n = clamp_min(
      sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
  t1[0] = t1[0] / t1n, t1[1] = t1[1] / t1n, t1[2] = t1[2] / t1n;
  cross(nr, t1, t2);
}

template <int LANES>
__global__ void __launch_bounds__(kBodies * LANES)
setup_kernel(const Args a, int last, float* vel_out, float* ang_out) {
  __shared__ float part[kTerms][kChunk][kBodies];
  __shared__ float sums[kTerms][kBodies];
  const int lane = threadIdx.y;
  const int n = blockIdx.x * kBodies + threadIdx.x;
  const bool live = n < a.n;
  const size_t cn_stride = static_cast<size_t>(a.n);
  const size_t plane = static_cast<size_t>(a.c) * a.n;

  float p[3], v[3], w[3], ia[6], im = 0.0f, fr = 0.0f, rs = 0.0f;
  if (live) {
    load3(a.pos, a.pos_stride, n, p);
    load3(a.vel, a.vel_stride, n, v);
    load3(a.ang, a.ang_stride, n, w);
    inertia_world(a, n, ia);
    im = load1(a.inv_m, a.inv_m_stride, n);
    fr = load1(a.friction, a.friction_stride, n);
    rs = load1(a.restitution, a.restitution_stride, n);
  }
  const float baum_k = kBaumgarte / *a.dt;
  const bool warm = a.warm[0] != nullptr || a.cache_feat != nullptr;
  const bool refresh = last && a.feat_out != nullptr;

  auto slot_terms = [&](int c, float* t) {
    const size_t cn = c * cn_stride + n;
    const int prt = a.prt[cn];
    if (prt >= a.n) __trap();   // the plain version's gather faults there
    const bool ok = a.valid[cn] != 0;
    const float pt[3] = {a.pt[0][cn], a.pt[1][cn], a.pt[2][cn]};
    const float nr[3] = {a.nrm[0][cn], a.nrm[1][cn], a.nrm[2][cn]};
    const float ra[3] = {pt[0] - p[0], pt[1] - p[1], pt[2] - p[2]};
    float t1[3], t2[3];
    tangents(nr, t1, t2);
    if (!ok) {
      // no impulse: only terms that are not signed zeros count (the sweeps
      // add them too, from the tangents and lever arm kept here)
      const bool zero = finite3(nr) && finite3(t1) && finite3(t2) &&
                        finite3(ra);
      a.mode[cn] = zero ? kSkip : kAddTerms;
      const float keep[9] = {t1[0], t1[1], t1[2], t2[0], t2[1], t2[2],
                             ra[0], ra[1], ra[2]};
      if (!zero) {
#pragma unroll
        for (int k = 0; k < 9; ++k) a.slots[(kT1x + k) * plane + cn] = keep[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.lam[k * plane + cn] = 0.0f;
        if (a.use_momentum) a.prev[k * plane + cn] = 0.0f;
      }
      if (refresh) write_cache(a, cn, c, n, false, 0.0f, 0.0f, 0.0f);
      if (zero) {
#pragma unroll
        for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
      } else {
        impulse_terms(0.0f, 0.0f, 0.0f, nr, t1, t2, ra, t);
      }
      return;
    }
    a.mode[cn] = kValid;
    const bool ground = prt < 0;
    const int q = ground ? 0 : prt;
    float pq[3], ib[6], gv[3], gw[3];
    load3(a.pos, a.pos_stride, q, pq);
    inertia_world(a, q, ib);
    const float im_q = load1(a.inv_m, a.inv_m_stride, q);
    const float fr_q = load1(a.friction, a.friction_stride, q);
    const float rs_q = load1(a.restitution, a.restitution_stride, q);
    load3(a.vel, a.vel_stride, q, gv);
    load3(a.ang, a.ang_stride, q, gw);
    const float rb[3] = {pt[0] - pq[0], pt[1] - pq[1], pt[2] - pq[2]};
    const float mu = ground ? fr * a.ground_friction : fr * fr_q;
    const float e = ground ? 0.0f : rs * rs_q;

    float ib_m[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ib_m[k] = ground ? 0.0f : ib[k];
    const float im_b = ground ? 0.0f : im_q;
    const float kn = k_along(nr, ra, rb, ia, ib_m, im, im_b);
    const float kt1 = k_along(t1, ra, rb, ia, ib_m, im, im_b);
    const float kt2 = k_along(t2, ra, rb, ia, ib_m, im, im_b);

    if (ground) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gv[k] = 0.0f, gw[k] = 0.0f;
    }
    float r[3];
    rel_vel(v, w, gv, gw, ra, rb, r);
    const float vn0 = dot(r, nr);
    const float bounce = e * clamp_min(-vn0 - kRestThreshold, 0.0f);
    const float baum = baum_k * clamp_min(a.dep[cn] - kSlop, 0.0f);
    const float target = maximum(bounce, baum);

    const float vals[kSlotPlanes] = {
        t1[0], t1[1], t1[2], t2[0], t2[1], t2[2], ra[0], ra[1], ra[2],
        rb[0], rb[1], rb[2], kn, kt1, kt2, target, mu};
#pragma unroll
    for (int k = 0; k < kSlotPlanes; ++k) a.slots[k * plane + cn] = vals[k];

    float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
    if (warm) {
      float wi[3];
      if (a.cache_feat != nullptr) {
        cached_impulse(a, cn, n, wi);
      } else {
        const size_t wn = static_cast<size_t>(c) * a.warm_stride + n;
        wi[0] = a.warm[0][wn], wi[1] = a.warm[1][wn], wi[2] = a.warm[2][wn];
      }
      // Bullet's 0.85 warm-starting factor: damped reuse
      l0 = clamp_min(wi[0], 0.0f) * kWarmFactor;
      l1 = wi[1] * kWarmFactor;
      l2 = wi[2] * kWarmFactor;
    }
    a.lam[cn] = l0, a.lam[plane + cn] = l1, a.lam[2 * plane + cn] = l2;
    if (a.use_momentum) {
      a.prev[cn] = l0, a.prev[plane + cn] = l1, a.prev[2 * plane + cn] = l2;
    }
    if (refresh) write_cache(a, cn, c, n, true, l0, l1, l2);
    impulse_terms(l0, l1, l2, nr, t1, t2, ra, t);
  };
  sum_slots<LANES>(a, live, slot_terms, part, sums);
  if (!live || lane >= kTerms) return;

  int count = 0;
  for (int c = 0; c < a.c; ++c) count += a.valid[c * cn_stride + n] != 0;
  const float cnt = clamp_min(static_cast<float>(count), 1.0f);
  const float inv_split_m = im / cnt;
  const float inv_split = 1.0f / cnt;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a.body[k * cn_stride + n] = ia[k];
    a.body[kInvSplitM * cn_stride + n] = inv_split_m;
    a.body[kInvSplit * cn_stride + n] = inv_split;
  }
  const float own = lane == 0 ? v[0] : lane == 1 ? v[1] : lane == 2 ? v[2]
                  : lane == 3 ? w[0] : lane == 4 ? w[1] : w[2];
  if (warm) {
    write_body(n, lane, own, ia, lane < 3 ? inv_split_m : inv_split, sums,
               vel_out, ang_out);
  } else {
    (lane < 3 ? vel_out : ang_out)[static_cast<long long>(n) * 3 +
                                   lane % 3] = own;
  }
}

template <int LANES>
__global__ void __launch_bounds__(kBodies * LANES)
sweep_kernel(const Args a, int last, const Pair src, float* vel_out,
             float* ang_out) {
  __shared__ float part[kTerms][kChunk][kBodies];
  __shared__ float sums[kTerms][kBodies];
  const int lane = threadIdx.y;
  const int n = blockIdx.x * kBodies + threadIdx.x;
  const bool live = n < a.n;
  const size_t cn_stride = static_cast<size_t>(a.n);
  const size_t plane = static_cast<size_t>(a.c) * a.n;
  const bool refresh = last && a.feat_out != nullptr;

  // what lanes 0..5 update at the end, read ahead of the slots
  float own = 0.0f, inv = 0.0f, ia[6] = {};
  if (live && lane < kTerms) {
    own = lane < 3 ? src.v[static_cast<long long>(n) * src.v_stride + lane]
                   : src.w[static_cast<long long>(n) * src.w_stride + lane - 3];
    inv = a.body[(lane < 3 ? kInvSplitM : kInvSplit) * cn_stride + n];
    if (lane >= 3) {
#pragma unroll
      for (int k = 0; k < 6; ++k) ia[k] = a.body[k * cn_stride + n];
    }
  }

  auto slot_terms = [&](int c, float* t) {
    const size_t cn = c * cn_stride + n;
    const uint8_t mode = a.mode[cn];
    if (mode == kSkip) {
#pragma unroll
      for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
      if (refresh) write_cache(a, cn, c, n, false, 0.0f, 0.0f, 0.0f);
      return;
    }
    const float* s = a.slots + cn;
    const float nr[3] = {a.nrm[0][cn], a.nrm[1][cn], a.nrm[2][cn]};
    const float t1[3] = {s[kT1x * plane], s[kT1y * plane], s[kT1z * plane]};
    const float t2[3] = {s[kT2x * plane], s[kT2y * plane], s[kT2z * plane]};
    const float ra[3] = {s[kRax * plane], s[kRay * plane], s[kRaz * plane]};
    float* lam = a.lam + cn;
    float ln = lam[0], lt1 = lam[plane], lt2 = lam[2 * plane];
    float dln = 0.0f, dlt1 = 0.0f, dlt2 = 0.0f;
    if (mode == kValid) {
      const float rb[3] = {s[kRbx * plane], s[kRby * plane],
                           s[kRbz * plane]};
      float v[3], w[3], gv[3], gw[3], r[3];
      load3(src.v, src.v_stride, n, v);
      load3(src.w, src.w_stride, n, w);
      partner_vel(src, a.prt[cn], a.n, gv, gw);
      rel_vel(v, w, gv, gw, ra, rb, r);
      const float mom = a.momentum;

      const float vn = dot(r, nr);
      float ln_new = clamp_min(ln + -(vn - s[kTarget * plane]) /
                                        s[kKn * plane], 0.0f);
      if (a.use_momentum) {
        // heavy-ball extrapolation over the lambda iterates
        ln_new = clamp_min(ln_new + mom * (ln_new - a.prev[cn]), 0.0f);
      }
      const float vt1 = dot(r, t1);
      const float vt2 = dot(r, t2);
      const float max_f = s[kMu * plane] * ln_new;
      float lt1_new = lt1 - vt1 / s[kKt1 * plane];
      float lt2_new = lt2 - vt2 / s[kKt2 * plane];
      if (a.use_momentum) {
        lt1_new = lt1_new + mom * (lt1_new - a.prev[plane + cn]);
        lt2_new = lt2_new + mom * (lt2_new - a.prev[2 * plane + cn]);
      }
      lt1_new = clamp(lt1_new, -max_f, max_f);
      lt2_new = clamp(lt2_new, -max_f, max_f);
      dln = ln_new - ln;
      dlt1 = lt1_new - lt1;
      dlt2 = lt2_new - lt2;
      if (a.use_momentum) {
        a.prev[cn] = ln, a.prev[plane + cn] = lt1;
        a.prev[2 * plane + cn] = lt2;
      }
      ln = ln_new, lt1 = lt1_new, lt2 = lt2_new;
      lam[0] = ln, lam[plane] = lt1, lam[2 * plane] = lt2;
    }
    if (refresh) write_cache(a, cn, c, n, mode == kValid, ln, lt1, lt2);
    impulse_terms(dln, dlt1, dlt2, nr, t1, t2, ra, t);
  };
  sum_slots<LANES>(a, live, slot_terms, part, sums);
  if (!live || lane >= kTerms) return;
  write_body(n, lane, own, ia, inv, sums, vel_out, ang_out);
}

template <int LANES>
void launch(const Args& a, int iterations, float* const (&out)[2][2],
            cudaStream_t s) {
  const dim3 block(kBodies, LANES);
  const int grid = (a.n + kBodies - 1) / kBodies;
  setup_kernel<LANES><<<grid, block, 0, s>>>(a, iterations == 0, out[0][0],
                                             out[0][1]);
  for (int i = 0; i < iterations; ++i) {
    const Pair src{out[i & 1][0], 3, out[i & 1][1], 3};
    sweep_kernel<LANES><<<grid, block, 0, s>>>(
        a, i == iterations - 1, src, out[(i + 1) & 1][0],
        out[(i + 1) & 1][1]);
  }
}

}  // namespace

// Launches the set-up and `iterations` sweeps on `stream`; the velocities
// go to (vel_a, ang_a) after the set-up and alternate between the two
// pairs after each sweep, so the result is pair a for an even count of
// sweeps and pair b for an odd one.  A slot a lane while two slots a lane
// would leave the card's SMs fewer than two blocks each, else two.
// Returns cudaGetLastError() as an int (0 = launched).  The wrapper
// (solve_kernel.py) checks the arguments.
extern "C" int contact_solve_launch(const void* args, int iterations,
                                    float* vel_a, float* ang_a, float* vel_b,
                                    float* ang_b, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  float* const out[2][2] = {{vel_a, ang_a}, {vel_b, ang_b}};
  if ((a.n + kBodies - 1) / kBodies < 2 * sms) {
    launch<kWideLanes>(a, iterations, out, s);
  } else {
    launch<kNarrowLanes>(a, iterations, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* contact_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
