// Box-box and ground contacts of the transposed contact pipeline, compacted
// per body, for Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// `box_contacts_t` (banggameengine_tpu/physics/contact_t.py) into a few
// loops.  In the port its plain version, `box_contacts_t_reference` in
// physics/contact_t.py, dispatches ~2,000 ATen kernels over [K, N] and
// [17, K, N] planes, each one launch's latency or a full pass over a plane;
// this kernel computes the same function in one launch after a 4-byte
// memset of the overflow count.
//
// For body i (the row, box a) and each slot k of its neighbor list (box b):
//   - the 15-axis SAT (a's face axes, b's, then the 9 edge cross products,
//     each skipped where its edges are parallel, length <= 1e-4), keeping
//     the axis of least overlap on a strict `<`, its normal turned to point
//     from b toward a;
//   - 17 candidate slots: a's 8 corners inside b's slab and volume (0..7),
//     b's 8 corners inside a's (8..15), and slot 16: the closest points of
//     the two edges for an edge axis, else the support midpoint where no
//     corner holds;
//   - the first 4 valid candidates (valid with depth > 0) in slot order.
// Then per body: its 8 corners against the ground plane y = 0 (the first 4
// below it, where the body may touch the ground), and the compaction of the
// pair candidates in the order c * K + k (c = 0..3, k = 0..K-1), then the
// ground's, into `budget` rows of the [budget, N] outputs, with feature ids
// (orig_partner + 1) * 64 + slot for pairs and the bare corner for the
// ground.  The overflow count adds the candidates dropped by the 4-point
// cap, by the ground's cap and by the budget.
//
// Exactness: each float is the plain version's expression in its order of
// evaluation, built with --fmad=false (no multiply-add contraction), IEEE
// sqrtf and division, `1.0f / x` where PyTorch takes a reciprocal (`1.0 / t`
// is `t.reciprocal() * 1.0` there), and the constants' f32 roundings, as
// PyTorch rounds a Python float against an f32 tensor.  Every output equals
// the plain version's on the card bit for bit (up to the sign of a zero).
//
// Design: one thread a (body, partner slot) pair, kThreads / K bodies a
// block, so a block's pairs are one run of nb_idx.  A pair thread runs the
// SAT and the 17 slots in registers and leaves its first 4 candidates,
// their slots, its normal and its count in shared memory.  After the
// barrier one thread a body finds its ground corners and walks its pairs'
// candidates in the compaction order, writing output row s of all the
// block's bodies at once: the [budget, N] planes are written once,
// coalesced along N.  Nothing else goes to device memory.  A list longer
// than a block (K > kThreads) takes `box_contacts_wide_kernel`: one body a
// block, its list in chunks of kThreads pairs, swept twice (the counts
// that place each level of the compaction order, then the rows), so any K
// runs.
//
// What bounds it on the card: ~1,300 f32 operations a pair with a contact
// (~600 for a pair the SAT separates) and ~80 bytes a pair read (the
// partner's pose and extents, its list entry and id) against 37 bytes a
// (row, body) written; at 24k pairs (the settled pile) that is a few
// microseconds of either peak, so what is left is latency: the dependent
// chain of the SAT and the slots in one thread, and the block's barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // pairs a block
constexpr int kCap = 4;              // points kept a pair (Bullet's manifold cache)
constexpr int kCorners = 8;
constexpr int kFeatStride = 64;      // == state.FEAT_STRIDE
constexpr float kMargin = 0.02f;     // == contact_t._LATERAL_MARGIN

struct Box {
  float p[3];   // centre
  float h[3];   // half extents
  float m[9];   // rotation, row-major
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

__device__ __forceinline__ float sign_eps(float x) {
  return x > 1e-5f ? 1.0f : (x < -1e-5f ? -1.0f : 0.0f);
}

// math3d.quat_to_mat3, (x, y, z, w) -> row-major R
__device__ __forceinline__ void load_box(const float* __restrict__ pos,
                                         int pos_stride,
                                         const float* __restrict__ quat,
                                         int quat_stride,
                                         const float* __restrict__ half,
                                         int half_stride, int i, Box& b) {
  const float* p = pos + static_cast<long long>(i) * pos_stride;
  const float* q = quat + static_cast<long long>(i) * quat_stride;
  const float* h = half + static_cast<long long>(i) * half_stride;
  b.p[0] = p[0], b.p[1] = p[1], b.p[2] = p[2];
  b.h[0] = h[0], b.h[1] = h[1], b.h[2] = h[2];
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  b.m[0] = 1.0f - 2.0f * (yy + zz);
  b.m[1] = 2.0f * (xy - wz);
  b.m[2] = 2.0f * (xz + wy);
  b.m[3] = 2.0f * (xy + wz);
  b.m[4] = 1.0f - 2.0f * (xx + zz);
  b.m[5] = 2.0f * (yz - wx);
  b.m[6] = 2.0f * (xz - wy);
  b.m[7] = 2.0f * (yz + wx);
  b.m[8] = 1.0f - 2.0f * (xx + yy);
}

// Corner c of a box (sign bits x, y, z = bits 2, 1, 0; contact_t._SIGNS).
__device__ __forceinline__ void corner(const Box& b, int c, float* out) {
  const float ox = (c & 4) ? b.h[0] : -b.h[0];
  const float oy = (c & 2) ? b.h[1] : -b.h[1];
  const float oz = (c & 1) ? b.h[2] : -b.h[2];
  out[0] = b.p[0] + b.m[0] * ox + b.m[1] * oy + b.m[2] * oz;
  out[1] = b.p[1] + b.m[3] * ox + b.m[4] * oy + b.m[5] * oz;
  out[2] = b.p[2] + b.m[6] * ox + b.m[7] * oy + b.m[8] * oz;
}

// The shared-memory record of a block's pairs.
struct PairTile {
  float pt[4][kCap][kThreads];   // x, y, z, depth of each kept candidate
  float n[3][kThreads];          // the pair's normal
  int count[kThreads];           // kept candidates (<= kCap)
  int slots[kThreads];           // their slots, 8 bits each
  int feat[kThreads];            // (orig partner + 1) * kFeatStride
};

// Keeps candidate `slot` at (x, y, z, depth) if the pair has room.
__device__ __forceinline__ void keep(PairTile& t, int p, int& cnt, int slot,
                                     float x, float y, float z, float d) {
  if (cnt < kCap) {
    t.pt[0][cnt][p] = x;
    t.pt[1][cnt][p] = y;
    t.pt[2][cnt][p] = z;
    t.pt[3][cnt][p] = d;
    t.slots[p] |= slot << (8 * cnt);
  }
  ++cnt;
}

// The SAT and the 17 slots of pair p (a against b); returns the valid
// candidates' count, beyond kCap included.
__device__ int pair_candidates(const Box& A, const Box& B, PairTile& t,
                               int p) {
  const float* a = A.m;
  const float* b = B.m;
  const float* ha = A.h;
  const float* hb = B.h;
  const float px = A.p[0], py = A.p[1], pz = A.p[2];
  const float qbx = B.p[0], qby = B.p[1], qbz = B.p[2];

  // ---- SAT: R = Ra^T Rb, t in both frames
  float r[3][3], ar[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[i][j] = a[0 + i] * b[0 + j] + a[3 + i] * b[3 + j] +
                a[6 + i] * b[6 + j];
      ar[i][j] = fabsf(r[i][j]);
    }
  }
  const float twx = qbx - px, twy = qby - py, twz = qbz - pz;
  float ta[3], tb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ta[i] = a[0 + i] * twx + a[3 + i] * twy + a[6 + i] * twz;
    tb[i] = b[0 + i] * twx + b[3 + i] * twy + b[6 + i] * twz;
  }

  float best_d = INFINITY, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int best_ax = 0;
  bool separated = false;
  auto consider = [&](float ov, float axx, float axy, float axz, bool ok,
                      int id) {
    separated |= (ov < 0.0f) & ok;
    if ((ov < best_d) & ok) {
      best_d = ov, bnx = axx, bny = axy, bnz = axz, best_ax = id;
    }
  };
#pragma unroll
  for (int i = 0; i < 3; ++i) {      // a's face axes (Ra column i)
    const float ov = ha[i] + hb[0] * ar[i][0] + hb[1] * ar[i][1] +
                     hb[2] * ar[i][2] - fabsf(ta[i]);
    consider(ov, a[0 + i], a[3 + i], a[6 + i], true, i);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {      // b's face axes (Rb column j)
    const float ov = ha[0] * ar[0][j] + ha[1] * ar[1][j] + ha[2] * ar[2][j] +
                     hb[j] - fabsf(tb[j]);
    consider(ov, b[0 + j], b[3 + j], b[6 + j], true, 3 + j);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {      // cross axes A_i x B_j
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const float ln = sqrtf(clamp_min(1.0f - r[i][j] * r[i][j], 0.0f));
      const bool axis_ok = ln > 1e-4f;
      const float inv_ln = 1.0f / clamp_min(ln, 1e-4f);
      const float ra_ij = ha[i1] * ar[i2][j] + ha[i2] * ar[i1][j];
      const float rb_ij = hb[j1] * ar[i][j2] + hb[j2] * ar[i][j1];
      const float dist = fabsf(ta[i2] * r[i1][j] - ta[i1] * r[i2][j]);
      const float ov = (ra_ij + rb_ij - dist) * inv_ln;
      const float ax = a[0 + i], ay = a[3 + i], az = a[6 + i];
      const float bx = b[0 + j], by = b[3 + j], bz = b[6 + j];
      const float cx = ay * bz - az * by;
      const float cy = az * bx - ax * bz;
      const float cz = ax * by - ay * bx;
      consider(ov, cx * inv_ln, cy * inv_ln, cz * inv_ln, axis_ok,
               6 + 3 * i + j);
    }
  }
  if (separated || !isfinite(best_d)) return 0;   // no candidate is valid

  // orient the normal from b toward a: axis . (-t) > 0 (torch.sign, 0 -> 1)
  const float s = -(bnx * twx + bny * twy + bnz * twz);
  float sgn = static_cast<float>((0.0f < s) - (s < 0.0f));
  if (sgn == 0.0f) sgn = 1.0f;
  bnx = bnx * sgn, bny = bny * sgn, bnz = bnz * sgn;
  const float sat_d = best_d;
  t.n[0][p] = bnx, t.n[1][p] = bny, t.n[2][p] = bnz;

  // ---- manifold candidates: support extents along n, the two planes
  const float na0 = a[0] * bnx + a[3] * bny + a[6] * bnz;   // Ra^T n
  const float na1 = a[1] * bnx + a[4] * bny + a[7] * bnz;
  const float na2 = a[2] * bnx + a[5] * bny + a[8] * bnz;
  const float nb0 = b[0] * bnx + b[3] * bny + b[6] * bnz;   // Rb^T n
  const float nb1 = b[1] * bnx + b[4] * bny + b[7] * bnz;
  const float nb2 = b[2] * bnx + b[5] * bny + b[8] * bnz;
  const float proj_a = ha[0] * fabsf(na0) + ha[1] * fabsf(na1) +
                       ha[2] * fabsf(na2);
  const float proj_b = hb[0] * fabsf(nb0) + hb[1] * fabsf(nb1) +
                       hb[2] * fabsf(nb2);
  const float plane_b = (bnx * qbx + bny * qby + bnz * qbz) + proj_b;
  const float plane_a = (bnx * px + bny * py + bnz * pz) - proj_a;
  const float lim = sat_d + kMargin;

  int cnt = 0;
  bool any_corner = false;
  t.slots[p] = 0;
  for (int c = 0; c < kCorners; ++c) {     // a's corners against b
    float cw[3];
    corner(A, c, cw);
    const float d = plane_b - (bnx * cw[0] + bny * cw[1] + bnz * cw[2]);
    const float dxw = cw[0] - qbx, dyw = cw[1] - qby, dzw = cw[2] - qbz;
    const float lb0 = b[0] * dxw + b[3] * dyw + b[6] * dzw;
    const float lb1 = b[1] * dxw + b[4] * dyw + b[7] * dzw;
    const float lb2 = b[2] * dxw + b[5] * dyw + b[8] * dzw;
    const bool v = (fabsf(lb0) <= hb[0] + kMargin) &
                   (fabsf(lb1) <= hb[1] + kMargin) &
                   (fabsf(lb2) <= hb[2] + kMargin) & (d <= lim);
    any_corner |= v;
    if (v & (d > 0.0f)) keep(t, p, cnt, c, cw[0], cw[1], cw[2], d);
  }
  for (int c = 0; c < kCorners; ++c) {     // b's corners against a
    float cw[3];
    corner(B, c, cw);
    const float d = (bnx * cw[0] + bny * cw[1] + bnz * cw[2]) - plane_a;
    const float dxw = cw[0] - px, dyw = cw[1] - py, dzw = cw[2] - pz;
    const float la0 = a[0] * dxw + a[3] * dyw + a[6] * dzw;
    const float la1 = a[1] * dxw + a[4] * dyw + a[7] * dzw;
    const float la2 = a[2] * dxw + a[5] * dyw + a[8] * dzw;
    const bool v = (fabsf(la0) <= ha[0] + kMargin) &
                   (fabsf(la1) <= ha[1] + kMargin) &
                   (fabsf(la2) <= ha[2] + kMargin) & (d <= lim);
    any_corner |= v;
    if (v & (d > 0.0f)) keep(t, p, cnt, kCorners + c, cw[0], cw[1], cw[2], d);
  }

  // slot 16: the edges' closest points for an edge axis, else the support
  // midpoint where no corner holds
  const bool is_edge = best_ax >= 6;
  if (!((is_edge | !any_corner) & (sat_d > 0.0f))) return cnt;
  if (cnt >= kCap) return cnt + 1;
  const float sa[3] = {sign_eps(na0) * ha[0], sign_eps(na1) * ha[1],
                       sign_eps(na2) * ha[2]};
  const float sb[3] = {sign_eps(nb0) * hb[0], sign_eps(nb1) * hb[1],
                       sign_eps(nb2) * hb[2]};
  float x, y, z;
  if (is_edge) {
    const int ei = (best_ax - 6) / 3, ej = (best_ax - 6) % 3;
    const float uax = a[ei], uay = a[3 + ei], uaz = a[6 + ei];
    const float ubx = b[ej], uby = b[3 + ej], ubz = b[6 + ej];
    // edge centres: the support corners with the edge's component zeroed
    const float za0 = ei == 0 ? 0.0f : sa[0];
    const float za1 = ei == 1 ? 0.0f : sa[1];
    const float za2 = ei == 2 ? 0.0f : sa[2];
    const float pacx = px - (a[0] * za0 + a[1] * za1 + a[2] * za2);
    const float pacy = py - (a[3] * za0 + a[4] * za1 + a[5] * za2);
    const float pacz = pz - (a[6] * za0 + a[7] * za1 + a[8] * za2);
    const float zb0 = ej == 0 ? 0.0f : sb[0];
    const float zb1 = ej == 1 ? 0.0f : sb[1];
    const float zb2 = ej == 2 ? 0.0f : sb[2];
    const float pbcx = qbx + (b[0] * zb0 + b[1] * zb1 + b[2] * zb2);
    const float pbcy = qby + (b[3] * zb0 + b[4] * zb1 + b[5] * zb2);
    const float pbcz = qbz + (b[6] * zb0 + b[7] * zb1 + b[8] * zb2);
    const float wx = pacx - pbcx, wy = pacy - pbcy, wz = pacz - pbcz;
    const float cc = uax * ubx + uay * uby + uaz * ubz;
    const float a1 = uax * wx + uay * wy + uaz * wz;
    const float b1 = ubx * wx + uby * wy + ubz * wz;
    const float den = clamp_min(1.0f - cc * cc, 1e-8f);
    float t_b = (b1 - cc * a1) / den;
    float s_a = cc * t_b - a1;
    s_a = clamp(s_a, -ha[ei], ha[ei]);
    t_b = clamp(t_b, -hb[ej], hb[ej]);
    x = 0.5f * (pacx + s_a * uax + pbcx + t_b * ubx);
    y = 0.5f * (pacy + s_a * uay + pbcy + t_b * uby);
    z = 0.5f * (pacz + s_a * uaz + pbcz + t_b * ubz);
  } else {
    const float supax = px - (a[0] * sa[0] + a[1] * sa[1] + a[2] * sa[2]);
    const float supay = py - (a[3] * sa[0] + a[4] * sa[1] + a[5] * sa[2]);
    const float supaz = pz - (a[6] * sa[0] + a[7] * sa[1] + a[8] * sa[2]);
    const float supbx = qbx + (b[0] * sb[0] + b[1] * sb[1] + b[2] * sb[2]);
    const float supby = qby + (b[3] * sb[0] + b[4] * sb[1] + b[5] * sb[2]);
    const float supbz = qbz + (b[6] * sb[0] + b[7] * sb[1] + b[8] * sb[2]);
    x = 0.5f * (supax + supbx);
    y = 0.5f * (supay + supby);
    z = 0.5f * (supaz + supbz);
  }
  keep(t, p, cnt, 2 * kCorners, x, y, z, sat_d);
  return cnt;
}

// The call's inputs and outputs.  Pointers are device pointers; row r of
// pos, quat and half starts at r * its stride (elements), its columns
// contiguous; `orig_id` is int32 (orig_bytes 4) or int64 (8), or null with
// `feat` null; the outputs are [budget, n] planes, `overflow` zeroed.
struct Args {
  const float* pos;
  int pos_stride;
  const float* quat;
  int quat_stride;
  const float* half;
  int half_stride;
  const int* nb_idx;             // [n, k]
  const uint8_t* nb_valid;       // [n, k]
  const uint8_t* ground_valid;   // [n]
  const void* orig_id;
  int orig_bytes;
  int n, k, budget;
  int* prt;                      // [budget, n]
  float* planes;                 // [7, budget, n]
  uint8_t* valid;                // [budget, n]
  int* feat;                     // [budget, n] or null
  int* overflow;                 // []
};

__device__ __forceinline__ void load_body(const Args& a, int i, Box& b) {
  load_box(a.pos, a.pos_stride, a.quat, a.quat_stride, a.half,
           a.half_stride, i, b);
}

// List entry e (body `body`, one slot of its list) into tile slot p: its
// kept candidates' count and, with feature ids, its partner's id term.
// Returns the candidates the 4-point cap drops.
__device__ int pair_into_tile(const Args& a, int body, long long e,
                              PairTile& t, int p) {
  t.count[p] = 0;
  const int j = a.nb_idx[e];
  if (j >= a.n) __trap();   // the plain version's gather faults there too
  if (!a.nb_valid[e]) return 0;
  const int partner = max(j, 0);           // the plain code's clamp_min(0)
  Box A, B;
  load_body(a, body, A);
  load_body(a, partner, B);
  const int cnt = pair_candidates(A, B, t, p);
  t.count[p] = min(cnt, kCap);
  if (a.feat != nullptr) {
    const int o = a.orig_bytes == 8
        ? static_cast<int>(static_cast<const long long*>(a.orig_id)[partner])
        : static_cast<const int*>(a.orig_id)[partner];
    t.feat[p] = static_cast<int>(
        (static_cast<unsigned>(o) + 1u) * static_cast<unsigned>(kFeatStride));
  }
  return max(cnt - kCap, 0);
}

// A body's corners below the ground plane y = 0 (where it may touch the
// ground): the first kCap of them, 4 bits each, into `slots`; returns
// their count, beyond kCap included.
__device__ __forceinline__ int ground_corners(const Args& a, const Box& A,
                                              int body, int& slots) {
  slots = 0;
  if (!a.ground_valid[body]) return 0;
  int cnt = 0;
  for (int c = 0; c < kCorners; ++c) {
    float cw[3];
    corner(A, c, cw);
    if (-cw[1] > 0.0f) {
      if (cnt < kCap) slots |= c << (4 * cnt);
      ++cnt;
    }
  }
  return cnt;
}

// One output row of a body: partner id, point, normal, depth, validity and
// feature id.
struct Row {
  int id = -1, f = -1;
  float v[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool ok = false;
};

// Candidate c of the pair in tile slot p, list entry e.
__device__ __forceinline__ Row pair_row(const Args& a, const PairTile& t,
                                        int p, int c, long long e) {
  Row r;
  r.id = a.nb_idx[e];
  r.v[0] = t.pt[0][c][p], r.v[1] = t.pt[1][c][p], r.v[2] = t.pt[2][c][p];
  r.v[3] = t.n[0][p], r.v[4] = t.n[1][p], r.v[5] = t.n[2][p];
  r.v[6] = t.pt[3][c][p];
  if (a.feat != nullptr) {                 // int32 arithmetic wraps, as torch's
    r.f = static_cast<int>(static_cast<unsigned>(t.feat[p]) +
                           ((t.slots[p] >> (8 * c)) & 0xffu));
  }
  r.ok = true;
  return r;
}

// Ground corner gc of box A.
__device__ __forceinline__ Row ground_row(const Box& A, int gc) {
  Row r;
  float cw[3];
  corner(A, gc, cw);
  r.v[0] = cw[0], r.v[1] = cw[1], r.v[2] = cw[2];
  r.v[4] = 1.0f;
  r.v[6] = -cw[1];
  r.f = gc;
  r.ok = true;
  return r;
}

__device__ __forceinline__ void write_row(const Args& a, int s, int body,
                                          const Row& r) {
  const long long o = static_cast<long long>(s) * a.n + body;
  const long long plane = static_cast<long long>(a.budget) * a.n;
  a.prt[o] = r.id;
#pragma unroll
  for (int q = 0; q < 7; ++q) a.planes[q * plane + o] = r.v[q];
  a.valid[o] = r.ok;
  if (a.feat != nullptr) a.feat[o] = r.f;
}

// K <= kThreads: kThreads / K bodies a block, one thread a pair, then one
// thread a body writes its rows in order.
__global__ void __launch_bounds__(kThreads) box_contacts_kernel(Args a) {
  __shared__ PairTile tile;
  const int tid = threadIdx.x;
  const int k = a.k;
  const int bodies = kThreads / k;                 // bodies a block
  const int row0 = blockIdx.x * bodies;
  int dropped = 0;                                 // this thread's overflow

  // ---- pairs: thread tid is slot tid % k of body row0 + tid / k
  const int pb = tid / k;
  tile.count[tid] = 0;
  if (pb < bodies && row0 + pb < a.n) {
    dropped += pair_into_tile(a, row0 + pb,
                              static_cast<long long>(row0) * k + tid, tile,
                              tid);
  }
  __syncthreads();

  // ---- bodies: the ground corners, then the compaction, row by row
  const int body = row0 + tid;
  if (tid < bodies && body < a.n) {
    Box A;
    load_body(a, body, A);
    int g_slots;
    const int g_cnt = ground_corners(a, A, body, g_slots);
    const int g_kept = min(g_cnt, kCap);
    dropped += g_cnt - g_kept;

    const int p0 = tid * k;                        // the body's first pair
    int total = g_kept;
    for (int kk = 0; kk < k; ++kk) total += tile.count[p0 + kk];
    dropped += max(total - a.budget, 0);

    int c = 0, kk = 0, g = 0;                      // the compaction's cursor
    for (int s = 0; s < a.budget; ++s) {
      while (c < kCap && c >= tile.count[p0 + kk]) {
        if (++kk == k) kk = 0, ++c;
      }
      Row r;
      if (c < kCap) {                              // pair candidate (kk, c)
        r = pair_row(a, tile, p0 + kk, c,
                     static_cast<long long>(body) * k + kk);
        if (++kk == k) kk = 0, ++c;
      } else if (g < g_kept) {                     // ground corner
        r = ground_row(A, (g_slots >> (4 * g)) & 0xf);
        ++g;
      }
      write_row(a, s, body, r);
    }
  }
  if (dropped != 0) atomicAdd(a.overflow, dropped);
}

// K > kThreads: one body a block, its list in chunks of kThreads, twice.
// The first sweep counts the pairs with more than c candidates (c = 0..3),
// which places each level c of the compaction order; the second computes
// the pairs again and thread 0 writes each kept candidate at its row.
__global__ void __launch_bounds__(kThreads) box_contacts_wide_kernel(Args a) {
  __shared__ PairTile tile;
  __shared__ int level[kCap];
  const int tid = threadIdx.x;
  const int body = blockIdx.x;
  const long long e0 = static_cast<long long>(body) * a.k;
  int dropped = 0;                                 // this thread's overflow
  int lv[kCap] = {0, 0, 0, 0};

  if (tid < kCap) level[tid] = 0;
  for (int k0 = tid; k0 < a.k; k0 += kThreads) {   // sweep 1: the counts
    dropped += pair_into_tile(a, body, e0 + k0, tile, tid);
#pragma unroll
    for (int c = 0; c < kCap; ++c) lv[c] += tile.count[tid] > c;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (lv[c] != 0) atomicAdd(&level[c], lv[c]);
  }
  __syncthreads();

  int row[kCap];                                   // level c's next row
  row[0] = 0;
#pragma unroll
  for (int c = 1; c < kCap; ++c) row[c] = row[c - 1] + level[c - 1];
  const int pairs = row[kCap - 1] + level[kCap - 1];
  for (int k0 = 0; k0 < a.k; k0 += kThreads) {     // sweep 2: the rows
    const int m = min(kThreads, a.k - k0);
    if (tid < m) pair_into_tile(a, body, e0 + k0 + tid, tile, tid);
    __syncthreads();
    if (tid == 0) {
      for (int p = 0; p < m; ++p) {
        for (int c = 0; c < tile.count[p]; ++c) {
          if (row[c] < a.budget) {
            write_row(a, row[c], body,
                      pair_row(a, tile, p, c, e0 + k0 + p));
          }
          ++row[c];
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {                                  // the ground, the rest
    Box A;
    load_body(a, body, A);
    int g_slots;
    const int g_cnt = ground_corners(a, A, body, g_slots);
    const int g_kept = min(g_cnt, kCap);
    dropped += g_cnt - g_kept + max(pairs + g_kept - a.budget, 0);
    for (int s = pairs, g = 0; s < a.budget; ++s, ++g) {
      write_row(a, s, body,
                g < g_kept ? ground_row(A, (g_slots >> (4 * g)) & 0xf)
                           : Row());
    }
  }
  if (dropped != 0) atomicAdd(a.overflow, dropped);
}

}  // namespace

// Zeroes the overflow count and launches the kernel that takes K on
// `stream`; returns cudaGetLastError() as an int (0 = launched).  The
// wrapper (contacts_kernel.py) checks the arguments.
extern "C" int box_contacts_launch(
    const float* pos, int pos_stride, const float* quat, int quat_stride,
    const float* half, int half_stride, const int* nb_idx,
    const uint8_t* nb_valid, const uint8_t* ground_valid,
    const void* orig_id, int orig_bytes, int n, int k, int budget, int* prt,
    float* planes, uint8_t* valid, int* feat, int* overflow, void* stream) {
  const Args a{pos, pos_stride, quat, quat_stride, half, half_stride,
               nb_idx, nb_valid, ground_valid, orig_id, orig_bytes, n, k,
               budget, prt, planes, valid, feat, overflow};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  if (k <= kThreads) {
    const int bodies = kThreads / k;
    box_contacts_kernel<<<(n + bodies - 1) / bodies, kThreads, 0, s>>>(a);
  } else {
    box_contacts_wide_kernel<<<n, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* box_contacts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
