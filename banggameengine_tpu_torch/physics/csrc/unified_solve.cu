// The dense route's unified Jacobi solve (contacts and joint rows) for
// Hopper.
//
// Replaces no TPU kernel: the JAX package has no joints, and XLA fuses its
// contact solve.  In the port the plain version is
// `unified_kernel.solve_unified_reference`: each slot's friction and
// restitution, the world inverse inertias, the warm start matched by
// feature id, `joints.joint_rows` and `solver.solve_contacts_unified`,
// ~1,000 small ATen kernels a step over [J, 7, ...] rows and [N, C, ...]
// slots.  This file computes the same function in `2 iterations + 2`
// launches (`iterations + 1` without joints), each its own launcher call:
//
//   - the joint rows' set-up (`rows_kernel`, a thread a joint): the world
//     frames, anchors, the angles theta, phi, psi and the limit, swing and
//     twist rows they switch on, the rows' Jacobians and targets, the
//     [7, 7] effective mass (inactive rows the identity's, each body's
//     inverse mass and inertia times its split where the set splits masses)
//     and its inverse by Gauss-Jordan without pivoting, the warm impulses
//     and their terms on each side, and the count of limit rows on.  A
//     joint's 7 row records go through shared memory, so that a block's
//     stores are contiguous;
//   - the contacts' set-up (`setup_kernel`, 32 bodies a block and 16 or 8
//     item lanes a body, an item being a slot or one of the body's joint
//     entries): lever arms, tangents, effective masses, the pair's
//     friction and restitution, the restitution and Baumgarte targets, the
//     warm impulses (matched from the contact cache where given), each
//     body's split; then the contacts' warm impulses and the joints' warm
//     terms applied to the velocities, in that order;
//   - each Jacobi sweep, two launches: every joint's rows updated from the
//     velocities at the sweep's start (`joint_sweep_kernel`, 8 threads a
//     joint, a row each, the residuals and each side's terms shared by
//     warp shuffles), then every slot's update and each body's velocity
//     change, its contacts' impulses first, then its joint entries' terms
//     (`sweep_kernel`, the set-up's layout, where the grid leaves the
//     card's SMs fewer than two blocks each; `sweep_serial_kernel`, a
//     thread a body, where it fills the card many times over).
//     Velocities ping-pong between two [N, 3] pairs.
//
// Exactness: each float is the plain version's expression in its order of
// evaluation, built with --fmad=false (no multiply-add contraction), IEEE
// sqrtf and division, the same atan2f and acosf as ATen's (probed bit-
// equal on the card), and the constants' f32 roundings.  ATen's
// `linalg.cross` is compiled with contraction: each component is
// fma(a, b, -(c d)) (probed), which `cross` spells out.  The sums follow
// ATen's reductions as probed on the card: over the last axis of 3,
// (a0 + a2) + a1; of 7, ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + a3) (a
// halving tree over 4 lanes); over another axis (slots, joint entries,
// rows, directions, cached slots), four accumulators over the index mod 4,
// then ((s0 + s1) + s2) + s3; every sum from +0, so a sum of zeros reads
// +0.  So every output equals the plain version's bit for bit where a
// body's cached feature ids are unique and `body_rows` is
// `joints.make_joint_set`'s (each joint once on each side).  A slot that
// is not valid adds signed zeros where its normal, tangents and lever arm
// are finite, which change no sum, so the sweeps skip those; the set-up
// marks the others, whose terms the sweeps add as the plain version does.
//
// What bounds it on the card: latency.  The Ant's 36,864 bodies and
// 32,768 joints read ~15 MB of joint records and a few MB of slots and
// velocities a sweep, a few microseconds at peak against ~22 measured; the
// ragdolls' 1,496 bodies and 1,360 joints fill a fraction of the SMs, each
// launch the length of one thread's chain of dependent loads and flops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBodies = 32;     // bodies a block (threadIdx.x)
constexpr int kChunk = 16;      // items a pass (a multiple of 4)
// item lanes a body (threadIdx.y): 16 (an item a lane) where the grid is
// small, 8 (two items a lane) where it fills the card many times over
constexpr int kWideLanes = 16, kNarrowLanes = 8;
constexpr int kTerms = 6;       // impulse x, y, z, torque x, y, z
constexpr int kRows = 7;        // == joints.ROWS
constexpr int kLimitRow = 5;    // == joints._LIMIT_ROW
constexpr int kRowsThreads = 64;     // the rows' set-up: a thread a joint
constexpr int kSweepThreads = 256;   // the joints' sweeps: 8 a joint
constexpr int kSerialThreads = 128;  // the sweeps' bodies, a thread each

constexpr float kBaumgarte = 0.2f;         // == solver.BAUMGARTE
constexpr float kSlop = 0.005f;            // == solver.PENETRATION_SLOP
constexpr float kRestThreshold = 1.0f;     // == solver.RESTITUTION_THRESHOLD
constexpr float kWarmFactor = 0.85f;       // == solver.WARM_START_FACTOR
constexpr float kLimitBias = 0.3f;         // == joints.LIMIT_BIAS

// planes of the [kSlotPlanes, C, N] scratch
enum SlotPlane {
  kNx, kNy, kNz, kT1x, kT1y, kT1z, kT2x, kT2y, kT2z, kRax, kRay, kRaz,
  kRbx, kRby, kRbz, kKn, kKt1, kKt2, kTarget, kMu, kSlotPlanes
};
// planes of the [kBodyPlanes, N] scratch: the world inverse inertia (row
// major), inv_m / split, split, inv_m / joint split, joint split
enum BodyPlane {
  kInvSplitM = 9, kSplit, kInvJointM, kJointSplit, kBodyPlanes
};
// a joint row's record in the [J, 7, kRowFloats] scratch: ja, jb, the
// row of the effective mass's inverse, the target, 1 where the row is on
enum RowField { kRJa = 0, kRJb = 3, kRInvK = 6, kRTarget = 13, kROn = 14 };
constexpr int kRowFloats = 16;
constexpr int kLamFloats = 8;     // a joint's impulses, padded
constexpr int kSideFloats = 8;    // a joint side's terms, padded
// a slot's mode in the sweeps
enum Mode : uint8_t { kSkip, kValid, kAddTerms };

struct Args {
  // bodies: [N, 3] / [N, 4] / [N], contiguous; the inverse inertia is the
  // body frame's diagonal
  const float* vel;
  const float* ang;
  const float* pos;
  const float* quat;
  const float* inv_m;
  const float* inertia;
  const float* friction;
  const float* restitution;
  const uint8_t* alive;
  // contacts: [N, C] / [N, C, 3], contiguous
  const int* prt;
  const float* pt;
  const float* nrm;
  const float* dep;
  const uint8_t* valid;
  // the contact cache the warm impulses are matched from (none: a cold
  // start): this step's ids [N, C], the cached ids [N, CB] and impulses
  // [N, CB, 3], contiguous
  const int* c_feat;
  const int* cache_feat;
  const float* cache_imp;
  int cb;
  const float* dt;    // f32[]
  int n, c;
  float ground_friction, momentum, sor;
  int use_momentum, use_sor;
  // joints (jb = 0: none): the table [J], [J, 3], [J, 4], each body's
  // entries [N, JB], last step's impulses [J, 7]
  int j, jb, mass_splitting;
  const int* body_a;
  const int* body_b;
  const int8_t* kind;
  const float* origin_a;
  const float* origin_b;
  const float* frame_a;
  const float* frame_b;
  const float* limit_lo;
  const float* limit_hi;
  const int* body_rows;
  const float* impulse;
  // scratch
  float* slots;      // [kSlotPlanes, C, N]
  uint8_t* mode;     // [C, N]
  float* body;       // [kBodyPlanes, N]
  float* lam;        // [3, C, N]: ln, lt1, lt2
  float* prev;       // [3, C, N]: their previous iterates (momentum only)
  float* rows;       // [J, 7, kRowFloats]
  float* jlam;       // [2, J, kLamFloats]: the impulses, their last iterate
  float* table;      // [2J, kSideFloats]: each side's terms (a's, then b's)
  // outputs
  float* lam_out;    // [N, C, 3]
  float* jlam_out;   // [J, 7]
  int* limit_rows;   // int32[], zeroed before the rows' set-up
};

struct Pair {       // a velocity buffer: [N, 3] rows
  const float* v;
  const float* w;
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

// torch.linalg.cross as ATen's kernel computes it: contracted,
// fma(a, b, -(c d)) a component
__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// ATen's sum over a last axis of 3 terms
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return ((a0 + a2) + a1) + 0.0f;
}

// (u * v).sum(dim=-1) of 3-vectors
__device__ __forceinline__ float dot(const float* u, const float* v) {
  return sum3(u[0] * v[0], u[1] * v[1], u[2] * v[2]);
}

// ATen's sum over a last axis of 7 terms
__device__ __forceinline__ float sum7(const float* a) {
  return (((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + a[3])) + 0.0f;
}

// ATen's sum over another axis: four accumulators over the index mod 4
struct Acc4 {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __device__ __forceinline__ void add(int i, float v) { s[i & 3] += v; }
  __device__ __forceinline__ float total() const {
    return ((s[0] + s[1]) + s[2]) + s[3];
  }
};

// solver._matvec: (m * v[..., None, :]).sum(dim=-1), m row major
__device__ __forceinline__ void matvec(const float* m, const float* v,
                                       float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = dot(m + 3 * i, v);
}

__device__ __forceinline__ void load3(const float* p, float* o) {
  o[0] = p[0], o[1] = p[1], o[2] = p[2];
}

__device__ __forceinline__ bool finite3(const float* v) {
  return isfinite(v[0]) && isfinite(v[1]) && isfinite(v[2]);
}

// math3d.quat_mul, xyzw
__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  const float ax = a[0], ay = a[1], az = a[2], aw = a[3];
  const float bx = b[0], by = b[1], bz = b[2], bw = b[3];
  o[0] = aw * bx + ax * bw + ay * bz - az * by;
  o[1] = aw * by - ax * bz + ay * bw + az * bx;
  o[2] = aw * bz + ax * by - ay * bx + az * bw;
  o[3] = aw * bw - ax * bx - ay * by - az * bz;
}

// math3d.quat_to_mat3, row major (columns are the frame's axes)
__device__ __forceinline__ void quat_to_mat3(const float* q, float* m) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1.0f - 2.0f * (yy + zz), m[1] = 2.0f * (xy - wz);
  m[2] = 2.0f * (xz + wy), m[3] = 2.0f * (xy + wz);
  m[4] = 1.0f - 2.0f * (xx + zz), m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy), m[7] = 2.0f * (yz + wx);
  m[8] = 1.0f - 2.0f * (xx + yy);
}

// math3d.quat_rotate: v + 2 (u x (u x v + w v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* o) {
  float c0[3], c1[3], c2[3];
  cross(q, v, c0);
#pragma unroll
  for (int k = 0; k < 3; ++k) c1[k] = c0[k] + q[3] * v[k];
  cross(q, c1, c2);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * c2[k];
}

// solver.inv_inertia_world of body i: R diag(d) R^T, row major
__device__ __forceinline__ void inertia_world(const Args& a, int i,
                                              float* out) {
  float r[9], d[3];
  quat_to_mat3(a.quat + static_cast<size_t>(i) * 4, r);
  load3(a.inertia + static_cast<size_t>(i) * 3, d);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float rd[3] = {r[3 * p] * d[0], r[3 * p + 1] * d[1],
                         r[3 * p + 2] * d[2]};
#pragma unroll
    for (int q = 0; q < 3; ++q) out[3 * p + q] = dot(rd, r + 3 * q);
  }
}

__device__ __forceinline__ float floor_of(int r) {
  return r >= kLimitRow ? 0.0f : -INFINITY;
}

// ---- the joint rows' set-up ------------------------------------------------

// Each body's split (its valid contacts and its joints, at least 1), as
// joints.joint_rows and solve_contacts_unified count it.
__device__ float body_split(const Args& a, int i) {
  int cnt = 0;
  for (int c = 0; c < a.c; ++c) {
    cnt += a.valid[static_cast<size_t>(i) * a.c + c] != 0;
  }
  int joints = 0;
  for (int k = 0; k < a.jb; ++k) {
    joints += a.body_rows[static_cast<size_t>(i) * a.jb + k] < 2 * a.j;
  }
  return clamp_min(static_cast<float>(cnt) + static_cast<float>(joints),
                   1.0f);
}

// Each side's terms of a joint's impulse changes (JointRows.body_impulse:
// -lin and ja's torque on side a, lin and jb's on side b), from each row
// thread's products `mine` (dl jl_r, dl ja_r, dl jb_r), summed over the
// rows with four accumulators r mod 4, into `table`.
__device__ __forceinline__ void write_sides(const Args& a, int jj, bool live,
                                            int r, unsigned base,
                                            const float (&mine)[9]) {
  Acc4 acc[9];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      acc[q].add(s, __shfl_sync(0xffffffffu, mine[q], base + s));
    }
  }
  // thread r < 6 writes term r of both sides (no dynamic index: registers)
  float side_a = 0.0f, side_b = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (r == q) {
      const float l = acc[q].total();
      side_a = -l, side_b = l;
    } else if (r == 3 + q) {
      side_a = acc[3 + q].total(), side_b = acc[6 + q].total();
    }
  }
  if (live && r < kTerms) {
    a.table[static_cast<size_t>(jj) * kSideFloats + r] = side_a;
    a.table[(static_cast<size_t>(a.j) + jj) * kSideFloats + r] = side_b;
  }
}

__global__ void __launch_bounds__(kRowsThreads)
rows_kernel(const Args a, int write_out) {
  // the block's row records, staged so that their stores coalesce
  __shared__ float4 staged[kRowsThreads * kRows * kRowFloats / 4];
  __shared__ int block_limits;
  const int j0 = blockIdx.x * kRowsThreads;
  const int t = threadIdx.x;
  const bool live = j0 + t < a.j;
  const int jj = live ? j0 + t : j0;    // a dead thread computes the first
  if (t == 0) block_limits = 0;
  const int ia_ = a.body_a[jj], ib_ = a.body_b[jj];
  if (ia_ < 0 || ia_ >= a.n || ib_ < 0 || ib_ >= a.n) __trap();
  float im_a = a.inv_m[ia_], im_b = a.inv_m[ib_];
  float ia[9], ib[9];
  inertia_world(a, ia_, ia);
  inertia_world(a, ib_, ib);
  if (a.mass_splitting) {
    const float sa = body_split(a, ia_), sb = body_split(a, ib_);
    im_a = im_a * sa, im_b = im_b * sb;
#pragma unroll
    for (int k = 0; k < 9; ++k) ia[k] = ia[k] * sa, ib[k] = ib[k] * sb;
  }
  float qa[4], qb[4], fra[4], frb[4], fa[4], fb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k] = a.quat[static_cast<size_t>(ia_) * 4 + k];
    qb[k] = a.quat[static_cast<size_t>(ib_) * 4 + k];
    fra[k] = a.frame_a[static_cast<size_t>(jj) * 4 + k];
    frb[k] = a.frame_b[static_cast<size_t>(jj) * 4 + k];
  }
  quat_mul(qa, fra, fa);
  quat_mul(qb, frb, fb);
  float ma[9], mb[9];
  quat_to_mat3(fa, ma);
  quat_to_mat3(fb, mb);
  const float xa[3] = {ma[0], ma[3], ma[6]}, ya[3] = {ma[1], ma[4], ma[7]};
  const float za[3] = {ma[2], ma[5], ma[8]};
  const float xb[3] = {mb[0], mb[3], mb[6]}, zb[3] = {mb[2], mb[5], mb[8]};
  float oa[3], ob[3], r_a[3], r_b[3];
  load3(a.origin_a + static_cast<size_t>(jj) * 3, oa);
  load3(a.origin_b + static_cast<size_t>(jj) * 3, ob);
  quat_rotate(qa, oa, r_a);
  quat_rotate(qb, ob, r_b);
  float gap[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gap[k] = (a.pos[static_cast<size_t>(ib_) * 3 + k] + r_b[k]) -
             (a.pos[static_cast<size_t>(ia_) * 3 + k] + r_a[k]);
  }
  const float erp = kBaumgarte / *a.dt;
  const float bias = kLimitBias / *a.dt;
  const bool hinge = a.kind[jj] == 0;
  const bool cone = !hinge;
  const float lo = a.limit_lo[jj], hi = a.limit_hi[jj];

  float ja[kRows][3], jb[kRows][3], target[kRows];
  // rows 0-2: the point, along the world axes
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float e[3] = {q == 0 ? 1.0f : 0.0f, q == 1 ? 1.0f : 0.0f,
                        q == 2 ? 1.0f : 0.0f};
    float ca[3], cb[3];
    cross(r_a, e, ca);
    cross(r_b, e, cb);
#pragma unroll
    for (int k = 0; k < 3; ++k) ja[q][k] = -ca[k], jb[q][k] = cb[k];
    target[q] = -erp * gap[q];
  }
  // rows 3-4: the hinge axis held along A's
  float zz[3];
  cross(za, zb, zz);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ja[3][k] = -xa[k], jb[3][k] = xa[k];
    ja[4][k] = -ya[k], jb[4][k] = ya[k];
  }
  target[3] = -erp * dot(zz, xa);
  target[4] = -erp * dot(zz, ya);
  // row 5: the hinge's limit, or the cone's swing
  const float theta = atan2f(dot(xb, ya), dot(xb, xa));
  const bool below = theta < lo, above = theta > hi;
  const float limit_err = below ? lo - theta : theta - hi;
  float cv[3];
  cross(xa, xb, cv);
  const float c_len = sqrtf(dot(cv, cv));
  const bool has_n = c_len > 1e-6f;
  const float c_div = clamp_min(c_len, 1e-6f);
  const float phi = acosf(clamp(dot(xa, xb), -1.0f, 1.0f));
  const bool swing_on = cone && phi > lo;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float limit_dir = below ? -za[k] : za[k];
    const float swing_n = has_n ? cv[k] / c_div : ya[k];
    const float d = hinge ? limit_dir : swing_n;
    ja[5][k] = d, jb[5][k] = -d;
  }
  const float r5_err = hinge ? limit_err : phi - lo;
  const bool r5_on = hinge ? (below || above) : swing_on;
  // row 6: the cone's twist, the x part of FA^-1 FB's swing-twist split
  const float fa_c[4] = {-fa[0], -fa[1], -fa[2], fa[3]};
  float rel[4];
  quat_mul(fa_c, fb, rel);
  if (rel[3] < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rel[k] = -rel[k];
  }
  const float psi = 2.0f * atan2f(fabsf(rel[0]), rel[3]);
  const bool twist_on = cone && psi > hi;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = rel[0] < 0.0f ? -xb[k] : xb[k];
    ja[6][k] = d, jb[6][k] = -d;
  }
  target[5] = bias * r5_err;
  target[6] = bias * (psi - hi);
  const bool both = a.alive[ia_] != 0 && a.alive[ib_] != 0;
  bool on[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    on[q] = both && (q < 3 || (q < 5 ? hinge : q == 5 ? r5_on : twist_on));
  }

  // the effective mass K = J M^-1 J^T of the active rows (the identity's
  // rows elsewhere) and its inverse by Gauss-Jordan without pivoting
  // (joints._spd_inverse)
  float ia_ja[kRows][3], ib_jb[kRows][3];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    matvec(ia, ja[q], ia_ja[q]);
    matvec(ib, jb[q], ib_jb[q]);
  }
  const float im = im_a + im_b;
  float aug[kRows][2 * kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      // jl_r . jl_q: 1 on the point rows' diagonal, +0 elsewhere
      const float jl_rq = (r == q && r < 3) ? 1.0f : 0.0f;
      const float k = ((im * jl_rq) + dot(ja[r], ia_ja[q])) +
                      dot(jb[r], ib_jb[q]);
      aug[r][q] = (on[r] && on[q]) ? k : (r == q ? 1.0f : 0.0f);
      aug[r][kRows + q] = r == q ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float pivot[2 * kRows];
    const float d = aug[i][i];
#pragma unroll
    for (int c = 0; c < 2 * kRows; ++c) pivot[c] = aug[i][c] / d;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float f = aug[r][i];
#pragma unroll
      for (int c = 0; c < 2 * kRows; ++c) {
        aug[r][c] = r == i ? pivot[c] : aug[r][c] - f * pivot[c];
      }
    }
  }

  // the records, the warm impulses and each side's warm terms
  const size_t jn = static_cast<size_t>(a.j);
  float warm[kLamFloats] = {};
  int limits = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float rec[kRowFloats];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rec[kRJa + k] = ja[r][k], rec[kRJb + k] = jb[r][k];
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) rec[kRInvK + q] = aug[r][kRows + q];
    rec[kRTarget] = target[r];
    rec[kROn] = on[r] ? 1.0f : 0.0f;
    rec[kROn + 1] = 0.0f;
#pragma unroll
    for (int q = 0; q < kRowFloats / 4; ++q) {
      staged[(t * kRows + r) * (kRowFloats / 4) + q] = make_float4(
          rec[4 * q], rec[4 * q + 1], rec[4 * q + 2], rec[4 * q + 3]);
    }
    if (r >= kLimitRow) limits += live && on[r];
    const float prev = a.impulse[static_cast<size_t>(jj) * kRows + r];
    warm[r] = on[r] ? maximum(prev, floor_of(r)) * kWarmFactor : 0.0f;
  }
  Acc4 lin[3], ang_a[3], ang_b[3];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lin[k].add(r, warm[r] * (r == k ? 1.0f : 0.0f));
      ang_a[k].add(r, warm[r] * ja[r][k]);
      ang_b[k].add(r, warm[r] * jb[r][k]);
    }
  }
  if (live) {
    float4* lam = reinterpret_cast<float4*>(a.jlam);
    const float4 w0 = make_float4(warm[0], warm[1], warm[2], warm[3]);
    const float4 w1 = make_float4(warm[4], warm[5], warm[6], 0.0f);
    lam[2 * jj] = w0, lam[2 * jj + 1] = w1;
    lam[2 * (jn + jj)] = w0, lam[2 * (jn + jj) + 1] = w1;
    if (write_out) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a.jlam_out[static_cast<size_t>(jj) * kRows + r] = warm[r];
      }
    }
    float4* side = reinterpret_cast<float4*>(a.table);
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = lin[k].total();
    side[2 * jj] = make_float4(-l[0], -l[1], -l[2], ang_a[0].total());
    side[2 * jj + 1] = make_float4(ang_a[1].total(), ang_a[2].total(), 0.0f,
                                   0.0f);
    side[2 * (jn + jj)] = make_float4(l[0], l[1], l[2], ang_b[0].total());
    side[2 * (jn + jj) + 1] = make_float4(ang_b[1].total(), ang_b[2].total(),
                                          0.0f, 0.0f);
  }
  const int warp_limits = __reduce_add_sync(0xffffffffu, limits);
  __syncthreads();
  if ((t & 31) == 0 && warp_limits) atomicAdd(&block_limits, warp_limits);
  // the block's records, contiguous in the scratch
  const int count = min(kRowsThreads, a.j - j0) * kRows * kRowFloats / 4;
  float4* out = reinterpret_cast<float4*>(a.rows) +
                static_cast<size_t>(j0) * kRows * kRowFloats / 4;
  for (int q = t; q < count; q += kRowsThreads) out[q] = staged[q];
  __syncthreads();
  if (t == 0 && block_limits) atomicAdd(a.limit_rows, block_limits);
}

// One Jacobi update of every joint's rows (JointRows.update), 8 threads a
// joint, thread r < 7 its row r: the row's J v from the velocities `src`,
// the residuals shared over the joint's threads, the row's new impulse
// from the effective mass's inverse, the heavy-ball step and the floor;
// then each side's terms of the change (JointRows.body_impulse) into
// `table`.  Every joint's impulses are its own threads', updated in place.
__global__ void __launch_bounds__(kSweepThreads)
joint_sweep_kernel(const Args a, int last, const Pair src) {
  const int tid = blockIdx.x * kSweepThreads + threadIdx.x;
  const int jj = tid >> 3, r = tid & 7;
  const unsigned lane = threadIdx.x & 31;
  const unsigned base = lane & ~7u;
  const bool live = jj < a.j;
  const bool row = live && r < kRows;
  float rec[kRowFloats] = {};
  float va[3] = {}, wa[3] = {}, vb[3] = {}, wb[3] = {};
  float lam = 0.0f, plam = 0.0f;
  const size_t jn = static_cast<size_t>(a.j);
  if (row) {
    const float4* p = reinterpret_cast<const float4*>(
        a.rows + (static_cast<size_t>(jj) * kRows + r) * kRowFloats);
#pragma unroll
    for (int q = 0; q < kRowFloats / 4; ++q) {
      const float4 v = p[q];
      rec[4 * q] = v.x, rec[4 * q + 1] = v.y;
      rec[4 * q + 2] = v.z, rec[4 * q + 3] = v.w;
    }
    const int ia_ = a.body_a[jj], ib_ = a.body_b[jj];
    load3(src.v + static_cast<size_t>(ia_) * 3, va);
    load3(src.w + static_cast<size_t>(ia_) * 3, wa);
    load3(src.v + static_cast<size_t>(ib_) * 3, vb);
    load3(src.w + static_cast<size_t>(ib_) * 3, wb);
    lam = a.jlam[static_cast<size_t>(jj) * kLamFloats + r];
    plam = a.jlam[(jn + jj) * kLamFloats + r];
  }
  const bool on = rec[kROn] != 0.0f;
  float res = 0.0f;
  {
    const float jl[3] = {r == 0 ? 1.0f : 0.0f, r == 1 ? 1.0f : 0.0f,
                         r == 2 ? 1.0f : 0.0f};
    const float dv[3] = {vb[0] - va[0], vb[1] - va[1], vb[2] - va[2]};
    const float jv = (dot(jl, dv) + dot(rec + kRJa, wa)) +
                     dot(rec + kRJb, wb);
    res = on ? rec[kRTarget] - jv : 0.0f;
  }
  float p[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    p[s] = rec[kRInvK + s] * __shfl_sync(0xffffffffu, res, base + s);
  }
  float nw = maximum(lam + sum7(p), floor_of(r));
  if (a.use_momentum) {
    nw = maximum(nw + a.momentum * (nw - plam), floor_of(r));
  }
  nw = on ? nw : lam;
  if (row) {
    a.jlam[static_cast<size_t>(jj) * kLamFloats + r] = nw;
    if (a.use_momentum) a.jlam[(jn + jj) * kLamFloats + r] = lam;
    if (last) a.jlam_out[static_cast<size_t>(jj) * kRows + r] = nw;
  }
  // each side's terms of the change
  const float dl = nw - lam;
  float mine[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mine[k] = dl * (r == k ? 1.0f : 0.0f);
    mine[3 + k] = dl * rec[kRJa + k];
    mine[6 + k] = dl * rec[kRJb + k];
  }
  write_sides(a, jj, live, r, base, mine);
}

// The tangents of normal nr (solver._orthonormal_tangents).
__device__ __forceinline__ void tangents(const float* nr, float* t1,
                                         float* t2) {
  const bool use_x = fabsf(nr[0]) < 0.7f;
  const float h[3] = {use_x ? 1.0f : 0.0f, use_x ? 0.0f : 1.0f, 0.0f};
  float c[3];
  cross(nr, h, c);
  const float len = clamp_min(sqrtf(dot(c, c)), 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t1[k] = c[k] / len;
  cross(nr, t1, t2);
}

// A slot's terms: the impulse (l0 n + l1 t1) + l2 t2, as ATen sums the
// directions axis, and its torque ra x impulse.
__device__ __forceinline__ void impulse_terms(float l0, float l1, float l2,
                                              const float* nr,
                                              const float* t1,
                                              const float* t2,
                                              const float* ra, float* t) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t[k] = ((l0 * nr[k] + l1 * t1[k]) + l2 * t2[k]) + 0.0f;
  }
  cross(ra, t, t + 3);
}

// The relative velocity at a slot: (v + w x ra) - (gv + gw x rb).
__device__ __forceinline__ void rel_vel(const float* v, const float* w,
                                        const float* gv, const float* gw,
                                        const float* ra, const float* rb,
                                        float* r) {
  float ca[3], cb[3];
  cross(w, ra, ca);
  cross(gw, rb, cb);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = (v[k] + ca[k]) - (gv[k] + cb[k]);
}

// The partner's velocity from `src`, zero for the static world.
__device__ __forceinline__ void partner_vel(const Pair& src, int prt, int n,
                                            float* gv, float* gw) {
  if (prt >= n) __trap();     // the plain version's gather faults there too
  if (prt < 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) gv[k] = 0.0f, gw[k] = 0.0f;
  } else {
    load3(src.v + static_cast<size_t>(prt) * 3, gv);
    load3(src.w + static_cast<size_t>(prt) * 3, gw);
  }
}

// The matched warm impulses of slot (n, c) from the contact cache: the sum
// over the cached slots of the one-hot match times the impulse, four
// accumulators over the cached slot mod 4 (the plain version's [N, C, C0,
// 3] sum over its third axis).
__device__ void cached_impulse(const Args& a, int n, int c, float* w) {
  const int f = a.c_feat[static_cast<size_t>(n) * a.c + c];
  Acc4 acc[3];
  for (int b = 0; b < a.cb; ++b) {
    const size_t nb = static_cast<size_t>(n) * a.cb + b;
    const float eq = (f == a.cache_feat[nb] && f >= 0) ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k].add(b, eq * a.cache_imp[3 * nb + k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = acc[k].total();
}

// What a block shares: each chunk's terms, then the body's two sums.
struct Shared {
  float part[kTerms][kChunk][kBodies];
  float sums[2 * kTerms][kBodies];
};

// Each lane takes its items of each chunk of kChunk (slots 0..C-1, then
// the body's joint entries) and leaves their terms in `part`; term q < 6 of
// the slots and term q - 6 of the joint entries are summed, each in item
// order as ATen sums them, by lane q % LANES, into `sums`.
template <int LANES, typename ItemFn>
__device__ __forceinline__ void sum_items(const Args& a, bool live,
                                          ItemFn item_terms, Shared& sh) {
  static_assert(kChunk % 4 == 0 && kChunk % LANES == 0 &&
                2 * LANES >= 2 * kTerms, "a chunk keeps the four "
                "accumulators' item groups whole; two rounds sum the terms");
  const int b = threadIdx.x, lane = threadIdx.y;
  const int items = a.c + a.jb;
  Acc4 acc[2];
  for (int i0 = 0; i0 < items; i0 += kChunk) {
#pragma unroll
    for (int h = 0; h < kChunk / LANES; ++h) {
      const int j = lane + h * LANES;
      if (live && i0 + j < items) {
        float t[kTerms];
        item_terms(i0 + j, t);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) sh.part[k][j][b] = t[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      const int q = lane + round * LANES;
      if (live && q < 2 * kTerms && (round == 0 || LANES < 2 * kTerms)) {
        const bool joints = q >= kTerms;
        const int term = joints ? q - kTerms : q;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int item = i0 + j;
          if (item < items && (item >= a.c) == joints) {
            acc[round].add(joints ? item - a.c : item, sh.part[term][j][b]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const int q = lane + round * LANES;
    if (live && q < 2 * kTerms && (round == 0 || LANES < 2 * kTerms)) {
      sh.sums[q][b] = acc[round].total();
    }
  }
  __syncthreads();
}

// Body n's joint entry k: its side's terms from `table`, zeros for the
// entry 2J (JointRows.body_impulse's zero row).
__device__ __forceinline__ void side_terms(const Args& a, int n, int k,
                                           float* t) {
  const int e = a.body_rows[static_cast<size_t>(n) * a.jb + k];
  if (e >= 2 * a.j) {
#pragma unroll
    for (int q = 0; q < kTerms; ++q) t[q] = 0.0f;
    return;
  }
  const float4* p = reinterpret_cast<const float4*>(
      a.table + static_cast<size_t>(e) * kSideFloats);
  const float4 lo = p[0], hi = p[1];
  t[0] = lo.x, t[1] = lo.y, t[2] = lo.z, t[3] = lo.w, t[4] = hi.x;
  t[5] = hi.y;
}

// A body's scalars for its velocity update: its world inverse inertia's
// row (of lane 3 + k), inv_m / split, split, inv_m / joint split, joint
// split.
struct BodyScalars {
  float row[3];
  float inv_split_m, split, inv_joint_m, joint_split;
};

// Body n's velocity from its summed terms, by lanes 0..5: lane k < 3 the
// linear velocity's component k, lane 3 + k the angular one's; `own` its
// component before.  The contacts' change first (where `contacts`), then
// the joints' (where the body has joint entries).
__device__ __forceinline__ void write_body(const Args& a, int n, int lane,
                                           float own, bool contacts,
                                           const BodyScalars& s,
                                           const Shared& sh, float* vel_out,
                                           float* ang_out) {
  const int b = threadIdx.x;
  float out = own;
  if (lane < 3) {
    if (contacts) out = out + sh.sums[lane][b] * s.inv_split_m;
    if (a.jb) out = out + sh.sums[kTerms + lane][b] * s.inv_joint_m;
    vel_out[static_cast<size_t>(n) * 3 + lane] = out;
    return;
  }
  if (contacts) {
    const float t[3] = {sh.sums[3][b], sh.sums[4][b], sh.sums[5][b]};
    out = out + dot(s.row, t) / s.split;
  }
  if (a.jb) {
    const float t[3] = {sh.sums[kTerms + 3][b], sh.sums[kTerms + 4][b],
                        sh.sums[kTerms + 5][b]};
    out = out + dot(s.row, t) / s.joint_split;
  }
  ang_out[static_cast<size_t>(n) * 3 + lane - 3] = out;
}

__device__ __forceinline__ void write_lam(const Args& a, int n, int c,
                                          float l0, float l1, float l2) {
  float* o = a.lam_out + (static_cast<size_t>(n) * a.c + c) * 3;
  o[0] = l0, o[1] = l1, o[2] = l2;
}

template <int LANES>
__global__ void __launch_bounds__(kBodies * LANES)
setup_kernel(const Args a, int last, float* vel_out, float* ang_out) {
  __shared__ Shared sh;
  const int lane = threadIdx.y;
  const int n = blockIdx.x * kBodies + threadIdx.x;
  const bool live = n < a.n;
  const size_t nn = static_cast<size_t>(a.n);
  const size_t plane = static_cast<size_t>(a.c) * a.n;
  const bool warm = a.cache_feat != nullptr;

  float p[3], v[3], w[3], ia[9], im = 0.0f;
  if (live) {
    load3(a.pos + static_cast<size_t>(n) * 3, p);
    load3(a.vel + static_cast<size_t>(n) * 3, v);
    load3(a.ang + static_cast<size_t>(n) * 3, w);
    inertia_world(a, n, ia);
    im = a.inv_m[n];
  }
  const float baum_k = kBaumgarte / *a.dt;

  auto item_terms = [&](int i, float* t) {
    if (i >= a.c) {                 // a joint entry: the warm impulses
      side_terms(a, n, i - a.c, t);
      return;
    }
    const int c = i;
    const size_t nc = static_cast<size_t>(n) * a.c + c;
    const size_t cn = c * nn + n;
    const int prt = a.prt[nc];
    if (prt >= a.n) __trap();   // the plain version's gather faults there
    const bool ok = a.valid[nc] != 0;
    float pt[3], nr[3];
    load3(a.pt + 3 * nc, pt);
    load3(a.nrm + 3 * nc, nr);
    const float ra[3] = {pt[0] - p[0], pt[1] - p[1], pt[2] - p[2]};
    float t1[3], t2[3];
    tangents(nr, t1, t2);
    if (!ok) {
      // no impulse: only terms that are not signed zeros count (the sweeps
      // add them too, from the planes kept here)
      const bool zero = finite3(nr) && finite3(t1) && finite3(t2) &&
                        finite3(ra);
      a.mode[cn] = zero ? kSkip : kAddTerms;
      if (!zero) {
        const float keep[12] = {nr[0], nr[1], nr[2], t1[0], t1[1], t1[2],
                                t2[0], t2[1], t2[2], ra[0], ra[1], ra[2]};
#pragma unroll
        for (int k = 0; k < 12; ++k) a.slots[(kNx + k) * plane + cn] = keep[k];
      }
      // (the sweeps read no impulse of a slot that is not valid: its
      // impulses stay 0)
      if (last) write_lam(a, n, c, 0.0f, 0.0f, 0.0f);
      if (zero) {
#pragma unroll
        for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
      } else {
        impulse_terms(0.0f, 0.0f, 0.0f, nr, t1, t2, ra, t);
      }
      return;
    }
    a.mode[cn] = kValid;
    const bool stat = prt < 0;
    const int q = stat ? 0 : prt;
    float pq[3], gv[3], gw[3], ib[9];
    load3(a.pos + static_cast<size_t>(q) * 3, pq);
    const float rb[3] = {pt[0] - pq[0], pt[1] - pq[1], pt[2] - pq[2]};
    const float im_b = stat ? 0.0f : a.inv_m[q];
    inertia_world(a, q, ib);
#pragma unroll
    for (int k = 0; k < 9; ++k) ib[k] = stat ? 0.0f : ib[k];
    // the pair's friction and restitution, the ground's for the static world
    const float fr = a.friction[n];
    const float mu = stat ? fr * a.ground_friction : fr * a.friction[q];
    const float e = stat ? 0.0f : a.restitution[n] * a.restitution[q];
    // k along each direction: inv_m_a + inv_m_b + d.((I_a (ra x d)) x ra)
    // + d.((I_b (rb x d)) x rb), floored at 1e-9
    const float* dirs[3] = {nr, t1, t2};
    float kd[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float x[3], y[3], ang_a[3], ang_b[3];
      cross(ra, dirs[d], x);
      matvec(ia, x, y);
      cross(y, ra, ang_a);
      cross(rb, dirs[d], x);
      matvec(ib, x, y);
      cross(y, rb, ang_b);
      kd[d] = clamp_min(((im + im_b) + dot(dirs[d], ang_a)) +
                        dot(dirs[d], ang_b), 1e-9f);
    }
    if (stat) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gv[k] = 0.0f, gw[k] = 0.0f;
    } else {
      load3(a.vel + static_cast<size_t>(q) * 3, gv);
      load3(a.ang + static_cast<size_t>(q) * 3, gw);
    }
    float r[3];
    rel_vel(v, w, gv, gw, ra, rb, r);
    const float vn0 = dot(r, nr);
    const float bounce = e * clamp_min(-vn0 - kRestThreshold, 0.0f);
    const float baum = baum_k * clamp_min(a.dep[nc] - kSlop, 0.0f);
    const float target = maximum(bounce, baum);
    const float vals[kSlotPlanes] = {
        nr[0], nr[1], nr[2], t1[0], t1[1], t1[2], t2[0], t2[1], t2[2],
        ra[0], ra[1], ra[2], rb[0], rb[1], rb[2], kd[0], kd[1], kd[2],
        target, mu};
#pragma unroll
    for (int k = 0; k < kSlotPlanes; ++k) a.slots[k * plane + cn] = vals[k];

    float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
    if (warm) {
      float wi[3];
      cached_impulse(a, n, c, wi);
      // Bullet's 0.85 warm-starting factor: damped reuse
      l0 = clamp_min(wi[0], 0.0f) * kWarmFactor;
      l1 = wi[1] * kWarmFactor;
      l2 = wi[2] * kWarmFactor;
    }
    a.lam[cn] = l0, a.lam[plane + cn] = l1, a.lam[2 * plane + cn] = l2;
    if (a.use_momentum) {
      a.prev[cn] = l0, a.prev[plane + cn] = l1, a.prev[2 * plane + cn] = l2;
    }
    if (last) write_lam(a, n, c, l0, l1, l2);
    impulse_terms(l0, l1, l2, nr, t1, t2, ra, t);
  };
  sum_items<LANES>(a, live, item_terms, sh);
  if (!live || lane >= kTerms) return;

  // the body's split: its valid slots, and its joints where it has entries
  int cnt = 0;
  for (int c = 0; c < a.c; ++c) {
    cnt += a.valid[static_cast<size_t>(n) * a.c + c] != 0;
  }
  int joints = 0;
  for (int k = 0; k < a.jb; ++k) {
    joints += a.body_rows[static_cast<size_t>(n) * a.jb + k] < 2 * a.j;
  }
  BodyScalars s;
  s.split = static_cast<float>(cnt);
  if (a.jb) s.split = s.split + static_cast<float>(joints);
  s.split = clamp_min(s.split, 1.0f);
  s.joint_split = a.mass_splitting ? 1.0f : s.split;
  s.inv_split_m = im / s.split;
  s.inv_joint_m = im / s.joint_split;
  const int k = lane < 3 ? 0 : lane - 3;
  s.row[0] = ia[3 * k], s.row[1] = ia[3 * k + 1], s.row[2] = ia[3 * k + 2];
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < 9; ++e) a.body[e * nn + n] = ia[e];
    a.body[kInvSplitM * nn + n] = s.inv_split_m;
    a.body[kSplit * nn + n] = s.split;
    a.body[kInvJointM * nn + n] = s.inv_joint_m;
    a.body[kJointSplit * nn + n] = s.joint_split;
  }
  const float own = lane < 3 ? v[lane] : w[lane - 3];
  write_body(a, n, lane, own, warm, s, sh, vel_out, ang_out);
}

// Sweep item i of body n: a slot's update from the velocities `src` and
// its terms, or a joint entry's side terms.
__device__ __forceinline__ void sweep_item(const Args& a, int n, int i,
                                           const Pair& src, int last,
                                           float* t) {
  const size_t nn = static_cast<size_t>(a.n);
  const size_t plane = static_cast<size_t>(a.c) * a.n;
  if (i >= a.c) {                 // a joint entry: its side's terms
    side_terms(a, n, i - a.c, t);
    return;
  }
  const int c = i;
  const size_t cn = c * nn + n;
  const uint8_t mode = a.mode[cn];
  if (mode == kSkip) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
    if (last) write_lam(a, n, c, 0.0f, 0.0f, 0.0f);
    return;
  }
  float* lam = a.lam + cn;
  const float* sl = a.slots + cn;
  const float nr[3] = {sl[kNx * plane], sl[kNy * plane], sl[kNz * plane]};
  const float t1[3] = {sl[kT1x * plane], sl[kT1y * plane],
                       sl[kT1z * plane]};
  const float t2[3] = {sl[kT2x * plane], sl[kT2y * plane],
                       sl[kT2z * plane]};
  const float ra[3] = {sl[kRax * plane], sl[kRay * plane],
                       sl[kRaz * plane]};
  float l[3] = {0.0f, 0.0f, 0.0f};    // a slot that is not valid keeps 0
  float dl[3] = {0.0f, 0.0f, 0.0f};
  if (mode == kValid) {
    l[0] = lam[0], l[1] = lam[plane], l[2] = lam[2 * plane];
    const float rb[3] = {sl[kRbx * plane], sl[kRby * plane],
                         sl[kRbz * plane]};
    float v[3], w[3], gv[3], gw[3], r[3];
    load3(src.v + static_cast<size_t>(n) * 3, v);
    load3(src.w + static_cast<size_t>(n) * 3, w);
    partner_vel(src, a.prt[static_cast<size_t>(n) * a.c + c], a.n, gv, gw);
    rel_vel(v, w, gv, gw, ra, rb, r);
    const float* dirs[3] = {nr, t1, t2};
    float nw[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float step = dot(r, dirs[d]) - (d == 0 ? sl[kTarget * plane] : 0.0f);
      if (a.use_sor) step = a.sor * step;
      nw[d] = maximum(l[d] - step / sl[(kKn + d) * plane],
                      d == 0 ? 0.0f : -INFINITY);
      if (a.use_momentum) {
        // heavy-ball extrapolation over the lambda iterates
        nw[d] = nw[d] + a.momentum * (nw[d] - a.prev[d * plane + cn]);
      }
    }
    const float ln_new = clamp_min(nw[0], 0.0f);
    const float max_f = sl[kMu * plane] * ln_new;
    nw[0] = ln_new;
    nw[1] = clamp(nw[1], -max_f, max_f);
    nw[2] = clamp(nw[2], -max_f, max_f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      dl[d] = nw[d] - l[d];
      if (a.use_momentum) a.prev[d * plane + cn] = l[d];
      l[d] = nw[d];
      lam[d * plane] = nw[d];
    }
  }
  if (last) write_lam(a, n, c, l[0], l[1], l[2]);
  impulse_terms(dl[0], dl[1], dl[2], nr, t1, t2, ra, t);
}

template <int LANES>
__global__ void __launch_bounds__(kBodies * LANES)
sweep_kernel(const Args a, int last, const Pair src, float* vel_out,
             float* ang_out) {
  __shared__ Shared sh;
  const int lane = threadIdx.y;
  const int n = blockIdx.x * kBodies + threadIdx.x;
  const bool live = n < a.n;
  const size_t nn = static_cast<size_t>(a.n);

  // what lanes 0..5 update at the end, read ahead of the items
  float own = 0.0f;
  BodyScalars s = {};
  if (live && lane < kTerms) {
    own = lane < 3 ? src.v[static_cast<size_t>(n) * 3 + lane]
                   : src.w[static_cast<size_t>(n) * 3 + lane - 3];
    s.inv_split_m = a.body[kInvSplitM * nn + n];
    s.split = a.body[kSplit * nn + n];
    s.inv_joint_m = a.body[kInvJointM * nn + n];
    s.joint_split = a.body[kJointSplit * nn + n];
    if (lane >= 3) {
      const int k = lane - 3;
#pragma unroll
      for (int e = 0; e < 3; ++e) s.row[e] = a.body[(3 * k + e) * nn + n];
    }
  }

  auto item_terms = [&](int i, float* t) {
    sweep_item(a, n, i, src, last, t);
  };
  sum_items<LANES>(a, live, item_terms, sh);
  if (!live || lane >= kTerms) return;
  write_body(a, n, lane, own, true, s, sh, vel_out, ang_out);
}


// Sweep i's bodies, a thread a body (where the grid fills the card many
// times over): the body's items one after another, each sum's four
// accumulators in registers, then its velocity as write_body computes it.
__global__ void __launch_bounds__(kSerialThreads)
sweep_serial_kernel(const Args a, int last, const Pair src, float* vel_out,
                    float* ang_out) {
  const int n = blockIdx.x * kSerialThreads + threadIdx.x;
  if (n >= a.n) return;
  const size_t nn = static_cast<size_t>(a.n);
  float sums[2][kTerms];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int count = g ? a.jb : a.c;
    float acc[kTerms][4] = {};
    for (int i0 = 0; i0 < count; i0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u < count) {
          float t[kTerms];
          sweep_item(a, n, g ? a.c + i0 + u : i0 + u, src, last, t);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) acc[k][u] += t[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      sums[g][k] = ((acc[k][0] + acc[k][1]) + acc[k][2]) + acc[k][3];
    }
  }
  const float inv_split_m = a.body[kInvSplitM * nn + n];
  const float split = a.body[kSplit * nn + n];
  const float inv_joint_m = a.body[kInvJointM * nn + n];
  const float joint_split = a.body[kJointSplit * nn + n];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float out = src.v[static_cast<size_t>(n) * 3 + k] +
                sums[0][k] * inv_split_m;
    if (a.jb) out = out + sums[1][k] * inv_joint_m;
    vel_out[static_cast<size_t>(n) * 3 + k] = out;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float row[3] = {a.body[(3 * k) * nn + n],
                          a.body[(3 * k + 1) * nn + n],
                          a.body[(3 * k + 2) * nn + n]};
    float out = src.w[static_cast<size_t>(n) * 3 + k] +
                dot(row, sums[0] + 3) / split;
    if (a.jb) out = out + dot(row, sums[1] + 3) / joint_split;
    ang_out[static_cast<size_t>(n) * 3 + k] = out;
  }
}

// The contacts' set-up (stage 1) or sweep `i`'s bodies (stage 3): a slot
// a lane while two would leave the card's SMs fewer than two blocks each,
// else two slots a lane for the set-up and a thread a body for the sweep.
template <int LANES>
void launch_bodies(const Args& a, int stage, int i, int iterations,
                   float* vel_a, float* ang_a, float* vel_b, float* ang_b,
                   cudaStream_t s) {
  const dim3 block(kBodies, LANES);
  const int grid = (a.n + kBodies - 1) / kBodies;
  if (stage == 1) {
    setup_kernel<LANES><<<grid, block, 0, s>>>(a, iterations == 0, vel_a,
                                               ang_a);
    return;
  }
  float* const out[2][2] = {{vel_a, ang_a}, {vel_b, ang_b}};
  const Pair src{out[i & 1][0], out[i & 1][1]};
  if constexpr (LANES == kWideLanes) {
    sweep_kernel<LANES><<<grid, block, 0, s>>>(a, i == iterations - 1, src,
                                               out[(i + 1) & 1][0],
                                               out[(i + 1) & 1][1]);
  } else {
    sweep_serial_kernel<<<(a.n + kSerialThreads - 1) / kSerialThreads,
                          kSerialThreads, 0, s>>>(a, i == iterations - 1,
                                                  src, out[(i + 1) & 1][0],
                                                  out[(i + 1) & 1][1]);
  }
}

}  // namespace

// Launches one stage of the solve on `stream`: 0 the joint rows' set-up
// (`limit_rows` zeroed, then counted), 1 the contacts' set-up, writing the
// velocities to (vel_a, ang_a), then for sweep `i` of `iterations` 2 the
// joints' update and 3 the contacts' and the bodies', both reading pair a
// and the latter writing pair b for an even `i`, the other way for an odd
// one: the result is pair a after an even count of sweeps, pair b after an
// odd one.  Returns cudaGetLastError() as an int
// (0 = launched).  The wrapper (unified_kernel.py) checks the arguments.
extern "C" int unified_solve_launch(const void* args, int stage, int i,
                                    int iterations, float* vel_a,
                                    float* ang_a, float* vel_b, float* ang_b,
                                    void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    cudaError_t err = cudaMemsetAsync(a.limit_rows, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.j > 0) {
      rows_kernel<<<(a.j + kRowsThreads - 1) / kRowsThreads, kRowsThreads,
                    0, s>>>(a, iterations == 0);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (stage == 2) {
    const long long threads = 8LL * a.j;
    if (threads > 0) {
      joint_sweep_kernel<<<(threads + kSweepThreads - 1) / kSweepThreads,
                           kSweepThreads, 0, s>>>(a, i == iterations - 1,
                                                  Pair{i & 1 ? vel_b : vel_a,
                                                       i & 1 ? ang_b : ang_a});
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((a.n + kBodies - 1) / kBodies < 2 * sms) {
    launch_bodies<kWideLanes>(a, stage, i, iterations, vel_a, ang_a, vel_b,
                              ang_b, s);
  } else {
    launch_bodies<kNarrowLanes>(a, stage, i, iterations, vel_a, ang_a,
                                vel_b, ang_b, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unified_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
