// K1: the batched integrate + contact control step, hand-written for Hopper.
//
// Replaces tvc_ai_tpu/ops/pallas_step.py::_kernel (launched by step_pallas).
// Plain version: tvc_ai_torch/physics/integrator.py::step. Python wrapper and
// build: tvc_ai_torch/ops/step_kernel.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC, no
// -use_fast_math: sincosf/expf/logf/sqrtf and every quotient of data stay
// correctly rounded or the accurate library versions).
//
// What it computes, per env: the external wrench once from the pre-step state
// (manual half of double gravity, gimbaled thrust rotated to the world frame
// with its lever-arm torque about thrust_offset - cg, drag from an exponential
// atmosphere gated on drag_min_speed, aerodynamic angular damping, wind), then
// `substeps` semi-implicit-Euler substeps, each with penalty contact at both
// cylinder ends (regularized Coulomb friction), engine gravity, the torque
// mapped through R diag(1/I) R^T, damping (1-d)^dt = exp(dt log(1-d)), and the
// quaternion exponential-map update with renormalization.
//
// Bound. Bytes: 23 f32 + 1 bool read and 13 f32 written per env = 145 B, over
// 3.35 TB/s. Operations: flops_per_env() in step_kernel.py, 143 + 298 per
// substep (each add, mul, div, sqrt, transcendental and compare of the
// algorithm counted once), over 67 TFLOP/s fp32. At N = 4096 that is 0.18 us
// of bytes against 0.08 us of arithmetic, both far below what sets the time
// at the main path's N, measured on an H100 (chip_smoke.py phase [6]): the
// launch itself (~2 us for an empty kernel on this grid), one round trip
// through memory (~0.7 us more), the wrench (~0.85 us) and one thread's
// serial chain through the four substeps (~1.2 us clear of the ground, more
// where a warp holds an env in contact). At N = 262144 the bytes (11.3 us)
// are what is left to approach.
//
// Design.
// - Block-staged I/O. Block b owns envs [b*kBlock, (b+1)*kBlock). The slice
//   of each of the 10 input arrays is then one contiguous span (kBlock*k
//   floats, kBlock bytes for `active`); kBlock is a multiple of 16, so every
//   span of a full block starts 16-byte aligned and is a whole number of
//   16-byte chunks (the wrapper checks that every base pointer is 16-byte
//   aligned). All threads load the spans with 16-byte loads into shared
//   memory, each thread reads its own fields there, writes its result over
//   its own state slots, and the block stores the four output spans with
//   16-byte stores. The last, ragged block copies with masked scalar loads.
// - One thread per env; the substeps run in registers, in a loop that is not
//   unrolled: unrolled 4x it measured slower at every N (PERF.md).
// - kBlock = 32: at N = 4096, 128 blocks of one warp spread over the SMs;
//   32, 64 and 128 measured close to each other, 32 the fastest there and
//   at 262144 (PERF.md).
// - A short chain per substep. What depends on the parameters alone (the
//   substep, the damping factors, the cylinder's 1/(I/m), the drag and
//   contact constants) is computed before the staged loads and overlaps
//   them; everything else that does not change across the substeps is
//   hoisted: 1/m (the one divide per env besides the drag's), 1/I_xx,
//   1/I_zz, dt/m, the external force's velocity increment with engine
//   gravity folded in. The body
//   is a cylinder (I_xx = I_yy), so R diag(1/I) R^T = (1/I_xx) Id +
//   (1/I_zz - 1/I_xx) z z^T, with z = R e_z the body axis, which is also the
//   lever of both contact ends: one column of R per substep replaces the
//   three rotations and three divides of the direct form, and it depends on
//   q alone, so it overlaps the contact math instead of following it. A
//   contact end is evaluated only when it is in the ground (depth > 0, the
//   same guard that zeroes its force otherwise). One sincosf(theta/2) serves
//   the exp map, and the quotients of data (fn/(vt+1e-3), sin/theta,
//   1/norm) are a correctly rounded reciprocal (__frcp_rn) and a multiply.
//   The guards are the TPU kernel's: 1e-9, 1e-3, 1e-12 and the theta < 1e-4
//   series.
// - Scalar parameters come by value in StepParams, mirrored on the host by a
//   ctypes.Structure built once per RocketParams. The thrust point is a
//   parameter (thrust_offset), where the TPU kernel hard-coded (0, 0, -0.5);
//   at the default the two agree.

#include <cuda_runtime.h>

struct StepParams {
  float thrust, gravity, double_g, drag_coeff, rho0, scale_height;
  float aero_damp, drag_min_speed, lin_damp, ang_damp, dt;
  float contact_k, contact_d, contact_mu, radius, length;
  float off_x, off_y, off_z;
  int substeps;
};

struct StepIn {
  const float* pos;
  const float* quat;
  const float* vel;
  const float* omega;
  const float* gimbal;
  const unsigned char* active;
  const float* mass;
  const float* thrust_scale;
  const float* cg;
  const float* wind;
};

struct StepOut {
  float* pos;
  float* quat;
  float* vel;
  float* omega;
};

namespace {

constexpr int kBlock = 32;  // envs (= threads) per block
static_assert(kBlock % 16 == 0 && kBlock <= 1024, "envs per block: a multiple of 16");
constexpr float kPi = 3.14159265358979323846f;

// Shared-memory layout of one block, in floats: the input spans back to back
// (outputs overwrite pos/quat/vel/omega). Every offset is a multiple of 4.
constexpr int kPos = 0;
constexpr int kQuat = kPos + 3 * kBlock;
constexpr int kVel = kQuat + 4 * kBlock;
constexpr int kOmega = kVel + 3 * kBlock;
constexpr int kGimbal = kOmega + 3 * kBlock;
constexpr int kMass = kGimbal + 2 * kBlock;
constexpr int kThrust = kMass + kBlock;
constexpr int kCg = kThrust + kBlock;
constexpr int kWind = kCg + 3 * kBlock;
constexpr int kActive = kWind + 3 * kBlock;  // kBlock bytes
constexpr int kSmemFloats = kActive + kBlock / 4;

// v body->world by unit quaternion (x, y, z, w): v + w t + q_xyz x t, t = 2 q_xyz x v
__device__ __forceinline__ void rotate(float qx, float qy, float qz, float qw,
                                       float vx, float vy, float vz,
                                       float& rx, float& ry, float& rz) {
  const float tx = 2.0f * (qy * vz - qz * vy);
  const float ty = 2.0f * (qz * vx - qx * vz);
  const float tz = 2.0f * (qx * vy - qy * vx);
  rx = vx + qw * tx + (qy * tz - qz * ty);
  ry = vy + qw * ty + (qz * tx - qx * tz);
  rz = vz + qw * tz + (qx * ty - qy * tx);
}

// Thread t's 16-byte chunk of a span of kChunks chunks (one chunk a thread
// at most: a span holds at most 4 floats per env).
template <int kChunks>
__device__ __forceinline__ float4 load_chunk(const void* g, int t) {
  static_assert(kChunks <= kBlock, "one chunk per thread at most");
  return t < kChunks ? __ldg(static_cast<const float4*>(g) + t) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kChunks>
__device__ __forceinline__ void put_chunk(float* s, float4 v, int t) {
  if (t < kChunks) reinterpret_cast<float4*>(s)[t] = v;
}

__device__ __forceinline__ void copy_scalars(float* s, const float* g, int count, int t) {
  for (int j = t; j < count; j += kBlock) s[j] = g[j];
}

// Stage the block's input spans into shared memory (s), then synchronise.
__device__ __forceinline__ void stage_in(float* s, const StepIn& in, int base, int nv, int t) {
  if (nv == kBlock) {
    // every load first, then every shared store: one memory latency in all
    const float4 c0 = load_chunk<3 * kBlock / 4>(in.pos + 3 * base, t);
    const float4 c1 = load_chunk<kBlock>(in.quat + 4 * base, t);
    const float4 c2 = load_chunk<3 * kBlock / 4>(in.vel + 3 * base, t);
    const float4 c3 = load_chunk<3 * kBlock / 4>(in.omega + 3 * base, t);
    const float4 c4 = load_chunk<kBlock / 2>(in.gimbal + 2 * base, t);
    const float4 c5 = load_chunk<kBlock / 4>(in.mass + base, t);
    const float4 c6 = load_chunk<kBlock / 4>(in.thrust_scale + base, t);
    const float4 c7 = load_chunk<3 * kBlock / 4>(in.cg + 3 * base, t);
    const float4 c8 = load_chunk<3 * kBlock / 4>(in.wind + 3 * base, t);
    const float4 c9 = load_chunk<kBlock / 16>(in.active + base, t);
    put_chunk<3 * kBlock / 4>(s + kPos, c0, t);
    put_chunk<kBlock>(s + kQuat, c1, t);
    put_chunk<3 * kBlock / 4>(s + kVel, c2, t);
    put_chunk<3 * kBlock / 4>(s + kOmega, c3, t);
    put_chunk<kBlock / 2>(s + kGimbal, c4, t);
    put_chunk<kBlock / 4>(s + kMass, c5, t);
    put_chunk<kBlock / 4>(s + kThrust, c6, t);
    put_chunk<3 * kBlock / 4>(s + kCg, c7, t);
    put_chunk<3 * kBlock / 4>(s + kWind, c8, t);
    put_chunk<kBlock / 16>(s + kActive, c9, t);
  } else {
    copy_scalars(s + kPos, in.pos + 3 * base, 3 * nv, t);
    copy_scalars(s + kQuat, in.quat + 4 * base, 4 * nv, t);
    copy_scalars(s + kVel, in.vel + 3 * base, 3 * nv, t);
    copy_scalars(s + kOmega, in.omega + 3 * base, 3 * nv, t);
    copy_scalars(s + kGimbal, in.gimbal + 2 * base, 2 * nv, t);
    copy_scalars(s + kMass, in.mass + base, nv, t);
    copy_scalars(s + kThrust, in.thrust_scale + base, nv, t);
    copy_scalars(s + kCg, in.cg + 3 * base, 3 * nv, t);
    copy_scalars(s + kWind, in.wind + 3 * base, 3 * nv, t);
    unsigned char* sa = reinterpret_cast<unsigned char*>(s + kActive);
    for (int j = t; j < nv; j += kBlock) sa[j] = in.active[base + j];
  }
  __syncthreads();
}

// Store the block's output spans from shared memory (after a synchronise).
__device__ __forceinline__ void stage_out(const float* s, const StepOut& out, int base, int nv,
                                          int t) {
  __syncthreads();
  if (nv == kBlock) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    if (t < 3 * kBlock / 4) reinterpret_cast<float4*>(out.pos + 3 * base)[t] = s4[kPos / 4 + t];
    reinterpret_cast<float4*>(out.quat + 4 * base)[t] = s4[kQuat / 4 + t];
    if (t < 3 * kBlock / 4) reinterpret_cast<float4*>(out.vel + 3 * base)[t] = s4[kVel / 4 + t];
    if (t < 3 * kBlock / 4) {
      reinterpret_cast<float4*>(out.omega + 3 * base)[t] = s4[kOmega / 4 + t];
    }
  } else {
    for (int j = t; j < 3 * nv; j += kBlock) out.pos[3 * base + j] = s[kPos + j];
    for (int j = t; j < 4 * nv; j += kBlock) out.quat[4 * base + j] = s[kQuat + j];
    for (int j = t; j < 3 * nv; j += kBlock) out.vel[3 * base + j] = s[kVel + j];
    for (int j = t; j < 3 * nv; j += kBlock) out.omega[3 * base + j] = s[kOmega + j];
  }
}

// What depends on the parameters alone. The kernel computes it before the
// staged loads, so it runs while they are in flight.
struct StepConsts {
  float dt;                      // substep
  float neg_inv_height;          // -1 / atmosphere scale height
  float drag_area;               // 0.5 drag_coeff pi r^2
  float inv_ixx_m, inv_izz_m;    // 1 / (I / m) of the cylinder
  float g_dt;                    // engine gravity's velocity increment
  float half_len, neg_mu;
  float lin_factor, ang_factor;  // (1 - d)^dt
};

__device__ __forceinline__ StepConsts step_consts(const StepParams& p) {
  StepConsts c;
  c.dt = p.dt / static_cast<float>(p.substeps);
  c.neg_inv_height = -1.0f / p.scale_height;
  c.drag_area = 0.5f * p.drag_coeff * (kPi * p.radius * p.radius);
  c.inv_ixx_m = 1.0f / ((1.0f / 12.0f) * (3.0f * p.radius * p.radius + p.length * p.length));
  c.inv_izz_m = 1.0f / (0.5f * p.radius * p.radius);
  c.g_dt = p.gravity * c.dt;
  c.half_len = 0.5f * p.length;
  c.neg_mu = -p.contact_mu;
  c.lin_factor = expf(c.dt * logf(1.0f - p.lin_damp));
  c.ang_factor = expf(c.dt * logf(1.0f - p.ang_damp));
  return c;
}

// One control step of env t of the block, read from and written back to s.
__device__ __forceinline__ void advance(float* s, int t, const StepParams& p,
                                        const StepConsts& c) {
  float px = s[kPos + 3 * t], py = s[kPos + 3 * t + 1], pz = s[kPos + 3 * t + 2];
  const float4 q4 = reinterpret_cast<const float4*>(s + kQuat)[t];
  float qx = q4.x, qy = q4.y, qz = q4.z, qw = q4.w;
  float vx = s[kVel + 3 * t], vy = s[kVel + 3 * t + 1], vz = s[kVel + 3 * t + 2];
  float wx = s[kOmega + 3 * t], wy = s[kOmega + 3 * t + 1], wz = s[kOmega + 3 * t + 2];
  const float2 g2 = reinterpret_cast<const float2*>(s + kGimbal)[t];
  const float on = reinterpret_cast<const unsigned char*>(s + kActive)[t] ? 1.0f : 0.0f;
  const float mass = s[kMass + t];
  const float cgx = s[kCg + 3 * t], cgy = s[kCg + 3 * t + 1], cgz = s[kCg + 3 * t + 2];

  // ---- external wrench, once, from the pre-step state
  float fx = s[kWind + 3 * t];
  float fy = s[kWind + 3 * t + 1];
  float fz = -p.gravity * p.double_g * mass + s[kWind + 3 * t + 2];

  float sin_p, cos_p, sin_y, cos_y;
  sincosf(g2.x, &sin_p, &cos_p);
  sincosf(g2.y, &sin_y, &cos_y);
  const float tmag = p.thrust * s[kThrust + t];
  float twx, twy, twz;
  rotate(qx, qy, qz, qw, tmag * sin_y, tmag * sin_p, tmag * cos_p * cos_y, twx, twy, twz);
  twx *= on; twy *= on; twz *= on;
  float lx, ly, lz;
  rotate(qx, qy, qz, qw, p.off_x - cgx, p.off_y - cgy, p.off_z - cgz, lx, ly, lz);
  float tqx = ly * twz - lz * twy;
  float tqy = lz * twx - lx * twz;
  float tqz = lx * twy - ly * twx;
  fx += twx; fy += twy; fz += twz;

  const float rho = p.rho0 * expf(pz * c.neg_inv_height);
  const float speed2 = vx * vx + vy * vy + vz * vz;
  const float speed = sqrtf(speed2);
  const float drag_mag = rho * speed2 * c.drag_area;
  const float inv_speed = speed > 1e-9f ? 1.0f / fmaxf(speed, 1e-9f) : 0.0f;
  const float k_drag = speed > p.drag_min_speed ? drag_mag * inv_speed : 0.0f;
  fx -= vx * k_drag; fy -= vy * k_drag; fz -= vz * k_drag;
  const float damp = p.aero_damp * rho;
  tqx -= damp * wx; tqy -= damp * wy; tqz -= damp * wz;

  // ---- what the substeps share
  const float dt = c.dt;
  const float inv_mass = 1.0f / mass;
  const float inv_ixx = c.inv_ixx_m * inv_mass;
  const float a_dt = inv_ixx * dt;                              // (1/I_xx) dt
  const float b_dt = (c.inv_izz_m * inv_mass - inv_ixx) * dt;   // (1/I_zz - 1/I_xx) dt
  const float k_v = inv_mass * dt;                              // force -> velocity increment
  const float dvx0 = fx * k_v, dvy0 = fy * k_v;
  const float dvz0 = fz * k_v - c.g_dt;                         // engine gravity, always on
  const float half_len = c.half_len, neg_mu = c.neg_mu;
  const float lin_factor = c.lin_factor, ang_factor = c.ang_factor;

#pragma unroll 1
  for (int sub = 0; sub < p.substeps; ++sub) {
    // body axis z = R e_z: the contact levers and the inertia map
    const float zx = 2.0f * (qx * qz + qw * qy);
    const float zy = 2.0f * (qy * qz - qw * qx);
    const float zz = 1.0f - 2.0f * (qx * qx + qy * qy);
    float dvx = dvx0, dvy = dvy0, dvz = dvz0;
    float tx = tqx, ty = tqy, tz = tqz;

    // penalty contact at the two cylinder ends
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float h = e == 0 ? -half_len : half_len;
      const float rx = h * zx, ry = h * zy, rz = h * zz;
      const float depth = fmaxf(-(pz + rz), 0.0f);
      if (depth > 0.0f) {
        const float vpx = vx + (wy * rz - wz * ry);
        const float vpy = vy + (wz * rx - wx * rz);
        const float vpz = vz + (wx * ry - wy * rx);
        const float fn = fmaxf(p.contact_k * depth - p.contact_d * vpz, 0.0f);
        const float vt = sqrtf(vpx * vpx + vpy * vpy);
        const float kf = neg_mu * fn * __frcp_rn(vt + 1e-3f);
        const float cfx = kf * vpx, cfy = kf * vpy, cfz = fn;
        dvx += cfx * k_v; dvy += cfy * k_v; dvz += cfz * k_v;
        tx += ry * cfz - rz * cfy;
        ty += rz * cfx - rx * cfz;
        tz += rx * cfy - ry * cfx;
      }
    }

    vx = (vx + dvx) * lin_factor;
    vy = (vy + dvy) * lin_factor;
    vz = (vz + dvz) * lin_factor;
    // omega += R diag(1/I) R^T tau dt = (a tau + b (z . tau) z) dt
    const float zt = b_dt * (zx * tx + zy * ty + zz * tz);
    wx = (wx + (a_dt * tx + zt * zx)) * ang_factor;
    wy = (wy + (a_dt * ty + zt * zy)) * ang_factor;
    wz = (wz + (a_dt * tz + zt * zz)) * ang_factor;
    px += vx * dt; py += vy * dt; pz += vz * dt;

    // q' = exp(omega dt) (x) q, renormalized; sin(theta/2)/theta with a
    // series below 1e-4 where the quotient loses precision
    const float ox = wx * dt, oy = wy * dt, oz = wz * dt;
    const float theta = sqrtf(ox * ox + oy * oy + oz * oz);
    float sh, ch;
    sincosf(0.5f * theta, &sh, &ch);
    const float k = theta < 1e-4f ? 0.5f - theta * theta * (1.0f / 48.0f) : sh * __frcp_rn(theta);
    const float dx = ox * k, dy = oy * k, dz = oz * k, dw = ch;
    const float nqx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float nqy = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nqz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float nqw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float norm = sqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw);
    const float inv_norm = __frcp_rn(fmaxf(norm, 1e-12f));
    qx = nqx * inv_norm; qy = nqy * inv_norm; qz = nqz * inv_norm; qw = nqw * inv_norm;
  }

  s[kPos + 3 * t] = px; s[kPos + 3 * t + 1] = py; s[kPos + 3 * t + 2] = pz;
  reinterpret_cast<float4*>(s + kQuat)[t] = make_float4(qx, qy, qz, qw);
  s[kVel + 3 * t] = vx; s[kVel + 3 * t + 1] = vy; s[kVel + 3 * t + 2] = vz;
  s[kOmega + 3 * t] = wx; s[kOmega + 3 * t + 1] = wy; s[kOmega + 3 * t + 2] = wz;
}

// kPhysics = false is K1's I/O alone (the memory floor): the state is copied.
template <bool kPhysics>
__global__ void __launch_bounds__(kBlock)
step_kernel(const StepIn in, const StepOut out, const StepParams p, const int n) {
  __shared__ __align__(16) float s[kSmemFloats];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kBlock;
  const int nv = min(kBlock, n - base);
  const StepConsts c = step_consts(p);
  stage_in(s, in, base, nv, t);
  if (kPhysics && t < nv) advance(s, t, p, c);
  stage_out(s, out, base, nv, t);
}

__global__ void empty_kernel() {}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is to contiguous, 16-byte-aligned memory on the current
// device: float32, except `active` (torch.bool, one byte per env).
extern "C" int tvc_step_kernel(
    const float* pos, const float* quat, const float* vel, const float* omega,
    const float* gimbal, const unsigned char* active, const float* mass,
    const float* thrust_scale, const float* cg, const float* wind,
    float* pos_out, float* quat_out, float* vel_out, float* omega_out,
    StepParams p, int n, void* stream) {
  if (n > 0) {
    step_kernel<true><<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        StepIn{pos, quat, vel, omega, gimbal, active, mass, thrust_scale, cg, wind},
        StepOut{pos_out, quat_out, vel_out, omega_out}, p, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's memory floor: its staged loads and stores with no arithmetic
// (the outputs are the state, copied).
extern "C" int tvc_step_copy(
    const float* pos, const float* quat, const float* vel, const float* omega,
    const float* gimbal, const unsigned char* active, const float* mass,
    const float* thrust_scale, const float* cg, const float* wind,
    float* pos_out, float* quat_out, float* vel_out, float* omega_out,
    int n, void* stream) {
  if (n > 0) {
    step_kernel<false><<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        StepIn{pos, quat, vel, omega, gimbal, active, mass, thrust_scale, cg, wind},
        StepOut{pos_out, quat_out, vel_out, omega_out}, StepParams{}, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's launch floor: an empty kernel on K1's grid for n envs.
extern "C" int tvc_step_empty(int n, void* stream) {
  if (n > 0) {
    empty_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

// out = {envs per block, registers per thread, local memory bytes per thread}
extern "C" int tvc_step_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, step_kernel<true>);
  out[0] = kBlock;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
}
