// K1: the batched integrate + contact control step, hand-written for Hopper.
//
// Replaces tvc_ai_tpu/ops/pallas_step.py::_kernel (launched by step_pallas).
// Plain version: tvc_ai_torch/physics/integrator.py::step. Python wrapper and
// build: tvc_ai_torch/ops/step_kernel.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC, no
// -use_fast_math: sinf/cosf/expf/logf/sqrtf stay the accurate versions).
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
// Design. One thread per env; the substeps run in registers, so the state is
// read once and written once. Layout: the kernel reads the env's own (N,3) /
// (N,4) / (N,) tensors (array of structures) and writes new ones; the TPU
// kernel's (13, N) structure-of-arrays packing existed to fill 128 vector lanes
// and would only add pack/unpack copies here. The ragged edge is masked with
// `if (i >= n) return;` (no padding). Scalar parameters come by value in a
// struct. The thrust point is a parameter (thrust_offset), where the TPU kernel
// hard-coded (0, 0, -0.5); at the default the two agree.
//
// Bound at N = 4096 (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores). Bytes: reads 23 f32 + 1 bool and writes 13 f32 per env = 145 B,
// 594 KB in all, 0.18 us. Operations: flops_per_env() in step_kernel.py counts
// the arithmetic below (each add, mul, div, sqrt, transcendental and compare
// counted once), 143 + 298 per substep = 1335 per env, 5.5 MFLOP in all,
// 0.08 us. So it is bound by bytes, and at this N far more by the launch
// itself (a few microseconds) and by each thread's serial chain of ~1.3 k
// dependent operations: 4096 threads fill only 32 of the 132 SMs at 128
// threads a block.

#include <cuda_runtime.h>

namespace {

struct StepParams {
  float thrust, gravity, double_g, drag_coeff, rho0, scale_height;
  float aero_damp, drag_min_speed, lin_damp, ang_damp, dt;
  float contact_k, contact_d, contact_mu, radius, length;
  float off_x, off_y, off_z;
  int substeps;
};

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265358979323846f;

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

__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
            const float* __restrict__ vel, const float* __restrict__ omega,
            const float* __restrict__ gimbal, const bool* __restrict__ active,
            const float* __restrict__ mass_in, const float* __restrict__ thrust_scale,
            const float* __restrict__ cg, const float* __restrict__ wind,
            float* __restrict__ pos_out, float* __restrict__ quat_out,
            float* __restrict__ vel_out, float* __restrict__ omega_out,
            const StepParams p, const int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  float qx = quat[4 * i], qy = quat[4 * i + 1], qz = quat[4 * i + 2], qw = quat[4 * i + 3];
  float vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
  float wx = omega[3 * i], wy = omega[3 * i + 1], wz = omega[3 * i + 2];
  const float gp = gimbal[2 * i], gy = gimbal[2 * i + 1];
  const float on = active[i] ? 1.0f : 0.0f;
  const float mass = mass_in[i];
  const float cgx = cg[3 * i], cgy = cg[3 * i + 1], cgz = cg[3 * i + 2];

  // ---- external wrench, once, from the pre-step state
  float fx = wind[3 * i];
  float fy = wind[3 * i + 1];
  float fz = -p.gravity * p.double_g * mass + wind[3 * i + 2];

  const float tmag = p.thrust * thrust_scale[i];
  float twx, twy, twz;
  rotate(qx, qy, qz, qw, tmag * sinf(gy), tmag * sinf(gp), tmag * cosf(gp) * cosf(gy),
         twx, twy, twz);
  twx *= on; twy *= on; twz *= on;
  float lx, ly, lz;
  rotate(qx, qy, qz, qw, p.off_x - cgx, p.off_y - cgy, p.off_z - cgz, lx, ly, lz);
  float tqx = ly * twz - lz * twy;
  float tqy = lz * twx - lx * twz;
  float tqz = lx * twy - ly * twx;
  fx += twx; fy += twy; fz += twz;

  const float rho = p.rho0 * expf(-pz / p.scale_height);
  const float speed2 = vx * vx + vy * vy + vz * vz;
  const float speed = sqrtf(speed2);
  const float area = kPi * p.radius * p.radius;
  const float drag_mag = 0.5f * rho * speed2 * p.drag_coeff * area;
  const float inv_speed = speed > 1e-9f ? 1.0f / fmaxf(speed, 1e-9f) : 0.0f;
  const float k_drag = speed > p.drag_min_speed ? drag_mag * inv_speed : 0.0f;
  fx -= vx * k_drag; fy -= vy * k_drag; fz -= vz * k_drag;
  const float damp = p.aero_damp * rho;
  tqx -= damp * wx; tqy -= damp * wy; tqz -= damp * wz;

  // body-frame inertia of the cylinder, per-substep constants
  const float i_xx = (1.0f / 12.0f) * mass * (3.0f * p.radius * p.radius + p.length * p.length);
  const float i_zz = 0.5f * mass * p.radius * p.radius;
  const float inv_mass = 1.0f / mass;
  const float half_len = 0.5f * p.length;
  const float dt = p.dt / static_cast<float>(p.substeps);
  const float lin_factor = expf(dt * logf(1.0f - p.lin_damp));
  const float ang_factor = expf(dt * logf(1.0f - p.ang_damp));

#pragma unroll 4
  for (int s = 0; s < p.substeps; ++s) {
    float sfx = fx, sfy = fy, sfz = fz;
    float stx = tqx, sty = tqy, stz = tqz;

    // penalty contact at the two cylinder ends
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float h = e == 0 ? -half_len : half_len;
      float rx, ry, rz;
      rotate(qx, qy, qz, qw, 0.0f, 0.0f, h, rx, ry, rz);
      const float cpz = pz + rz;
      const float vpx = vx + (wy * rz - wz * ry);
      const float vpy = vy + (wz * rx - wx * rz);
      const float vpz = vz + (wx * ry - wy * rx);
      const float depth = fmaxf(-cpz, 0.0f);
      const float fn = depth > 0.0f ? fmaxf(p.contact_k * depth - p.contact_d * vpz, 0.0f) : 0.0f;
      const float vt = sqrtf(vpx * vpx + vpy * vpy);
      const float kf = -p.contact_mu * fn / (vt + 1e-3f);
      const float cfx = kf * vpx, cfy = kf * vpy, cfz = fn;
      sfx += cfx; sfy += cfy; sfz += cfz;
      stx += ry * cfz - rz * cfy;
      sty += rz * cfx - rx * cfz;
      stz += rx * cfy - ry * cfx;
    }

    sfz -= p.gravity * mass;  // engine gravity, always on
    vx += sfx * inv_mass * dt;
    vy += sfy * inv_mass * dt;
    vz += sfz * inv_mass * dt;

    // omega += R diag(1/I) R^T tau dt
    float bx, by, bz;
    rotate(-qx, -qy, -qz, qw, stx, sty, stz, bx, by, bz);
    float ax, ay, az;
    rotate(qx, qy, qz, qw, bx / i_xx, by / i_xx, bz / i_zz, ax, ay, az);
    wx += ax * dt; wy += ay * dt; wz += az * dt;

    vx *= lin_factor; vy *= lin_factor; vz *= lin_factor;
    wx *= ang_factor; wy *= ang_factor; wz *= ang_factor;
    px += vx * dt; py += vy * dt; pz += vz * dt;

    // q' = exp(omega dt) (x) q, renormalized; sin(theta/2)/theta with a
    // series below 1e-4 where the quotient loses precision
    const float ox = wx * dt, oy = wy * dt, oz = wz * dt;
    const float theta = sqrtf(ox * ox + oy * oy + oz * oz);
    const float k = theta < 1e-4f ? 0.5f - theta * theta / 48.0f : sinf(0.5f * theta) / theta;
    const float dx = ox * k, dy = oy * k, dz = oz * k, dw = cosf(0.5f * theta);
    const float nqx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float nqy = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nqz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float nqw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float norm = sqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw);
    const float inv_norm = 1.0f / fmaxf(norm, 1e-12f);
    qx = nqx * inv_norm; qy = nqy * inv_norm; qz = nqz * inv_norm; qw = nqw * inv_norm;
  }

  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  quat_out[4 * i] = qx; quat_out[4 * i + 1] = qy; quat_out[4 * i + 2] = qz; quat_out[4 * i + 3] = qw;
  vel_out[3 * i] = vx; vel_out[3 * i + 1] = vy; vel_out[3 * i + 2] = vz;
  omega_out[3 * i] = wx; omega_out[3 * i + 1] = wy; omega_out[3 * i + 2] = wz;
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is to contiguous float32 memory on the current device, except
// `active` (torch.bool, one byte per env).
extern "C" int tvc_step_kernel(
    const float* pos, const float* quat, const float* vel, const float* omega,
    const float* gimbal, const bool* active, const float* mass,
    const float* thrust_scale, const float* cg, const float* wind,
    float* pos_out, float* quat_out, float* vel_out, float* omega_out,
    float thrust, float gravity, float double_g, float drag_coeff, float rho0,
    float scale_height, float aero_damp, float drag_min_speed, float lin_damp,
    float ang_damp, float dt, float contact_k, float contact_d, float contact_mu,
    float radius, float length, float off_x, float off_y, float off_z,
    int substeps, int n, void* stream) {
  const StepParams p{thrust, gravity, double_g, drag_coeff, rho0, scale_height,
                     aero_damp, drag_min_speed, lin_damp, ang_damp, dt,
                     contact_k, contact_d, contact_mu, radius, length,
                     off_x, off_y, off_z, substeps};
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, quat, vel, omega, gimbal, active, mass, thrust_scale, cg, wind,
        pos_out, quat_out, vel_out, omega_out, p, n);
  }
  return static_cast<int>(cudaGetLastError());
}
