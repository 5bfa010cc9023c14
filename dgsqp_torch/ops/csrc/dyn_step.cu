// One discrete step of the dynamic (Pacejka or linear tire) bicycles with its first and
// second derivatives, for a batch of points: dgsqp_torch.ops.dynamics.dyn_step.
//
// A point is z = [q, u] (L = n_q + n_u inputs).  The step is q + dt fc(q, u) (euler) or
// M sub-steps of rk2/rk3/rk4, fc written as in dgsqp_torch/dynamics/models.py in the
// same order of operations.  Derivatives come from hyper-dual arithmetic: a value with
// two first-order parts a, b and a cross part ab, so that seeding a = e_i, b = e_j gives
// df/dz_i in a and d2f/(dz_i dz_j) in ab, exactly (no truncation error).
//
//   order 0: one thread per point, f only;
//   order 1: one thread per (point, i): f and the Jacobian column i;
//   order 2: one thread per (point, i <= j): also the Hessian entries (i, j) and (j, i).
//
// Outputs: f (P, n_q), J (P, n_q, L), H (P, n_q, L, L), row-major.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using dgsqp::DeviceGuard;

constexpr int kMaxQ = 8;
constexpr int kMaxU = 3;
constexpr int kThreads = 128;

// model kinds (dgsqp_torch.ops.dynamics.MODEL_KINDS)
// (kind 2 = DynamicBicycleCombined: [x, y, vx, vy, psidot, epsi, s, xtran])
constexpr int kGlobal = 0;    // DynamicBicycle: [vx, vy, psidot, x, y, psi]
constexpr int kFrenet = 1;    // DynamicCLBicycle: [vx, vy, psidot, epsi, s, xtran]
constexpr int kProgress = 3;  // DynamicBicycleProgressAugmented: [vx, vy, psidot, x, y, psi, s]

template <typename R>
struct HD {
  R v, a, b, ab;
};

template <typename R>
__device__ __forceinline__ HD<R> cst(R v) { return {v, R(0), R(0), R(0)}; }
template <typename R>
__device__ __forceinline__ HD<R> operator+(HD<R> x, HD<R> y) {
  return {x.v + y.v, x.a + y.a, x.b + y.b, x.ab + y.ab};
}
template <typename R>
__device__ __forceinline__ HD<R> operator-(HD<R> x, HD<R> y) {
  return {x.v - y.v, x.a - y.a, x.b - y.b, x.ab - y.ab};
}
template <typename R>
__device__ __forceinline__ HD<R> operator-(HD<R> x) { return {-x.v, -x.a, -x.b, -x.ab}; }
template <typename R>
__device__ __forceinline__ HD<R> operator*(HD<R> x, HD<R> y) {
  return {x.v * y.v, x.v * y.a + x.a * y.v, x.v * y.b + x.b * y.v,
          x.v * y.ab + x.a * y.b + x.b * y.a + x.ab * y.v};
}
template <typename R>
__device__ __forceinline__ HD<R> operator*(R c, HD<R> x) { return {c * x.v, c * x.a, c * x.b, c * x.ab}; }
template <typename R>
__device__ __forceinline__ HD<R> operator*(HD<R> x, R c) { return {x.v * c, x.a * c, x.b * c, x.ab * c}; }
template <typename R>
__device__ __forceinline__ HD<R> operator+(HD<R> x, R c) { return {x.v + c, x.a, x.b, x.ab}; }
template <typename R>
__device__ __forceinline__ HD<R> operator-(R c, HD<R> x) { return {c - x.v, -x.a, -x.b, -x.ab}; }
template <typename R>
__device__ __forceinline__ HD<R> operator-(HD<R> x, R c) { return {x.v - c, x.a, x.b, x.ab}; }
template <typename R>
__device__ __forceinline__ HD<R> operator/(HD<R> x, R c) { return {x.v / c, x.a / c, x.b / c, x.ab / c}; }

// f(x) for a function with value f0 and derivatives f1, f2 at x.v
template <typename R>
__device__ __forceinline__ HD<R> chain(HD<R> x, R f0, R f1, R f2) {
  return {f0, f1 * x.a, f1 * x.b, f1 * x.ab + f2 * x.a * x.b};
}
template <typename R>
__device__ __forceinline__ HD<R> operator/(HD<R> x, HD<R> y) {
  const R inv = R(1) / y.v;
  const HD<R> r = chain(y, inv, -inv * inv, R(2) * inv * inv * inv);
  HD<R> out = x * r;
  out.v = x.v / y.v;  // the value as a plain division, as the plain version computes it
  return out;
}

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float datan(float x) { return atanf(x); }
__device__ __forceinline__ double datan(double x) { return atan(x); }
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dpow(float x, float p) { return powf(x, p); }
__device__ __forceinline__ double dpow(double x, double p) { return pow(x, p); }
__device__ __forceinline__ float dfmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double dfmod(double x, double y) { return fmod(x, y); }

template <typename R>
__device__ __forceinline__ HD<R> hsin(HD<R> x) {
  const R s = dsin(x.v), c = dcos(x.v);
  return chain(x, s, c, -s);
}
template <typename R>
__device__ __forceinline__ HD<R> hcos(HD<R> x) {
  const R s = dsin(x.v), c = dcos(x.v);
  return chain(x, c, -s, -c);
}
template <typename R>
__device__ __forceinline__ HD<R> hatan(HD<R> x) {
  const R d = R(1) / (R(1) + x.v * x.v);
  return chain(x, datan(x.v), d, R(-2) * x.v * d * d);
}
template <typename R>
__device__ __forceinline__ HD<R> hatan2(HD<R> y, HD<R> x) {
  const R r2 = x.v * x.v + y.v * y.v;
  const R fy = x.v / r2, fx = -y.v / r2;
  const R r4 = r2 * r2;
  const R fyy = R(-2) * x.v * y.v / r4, fxx = R(2) * x.v * y.v / r4;
  const R fxy = (y.v * y.v - x.v * x.v) / r4;
  return {datan2(y.v, x.v), fy * y.a + fx * x.a, fy * y.b + fx * x.b,
          fy * y.ab + fx * x.ab + fyy * y.a * y.b + fxx * x.a * x.b
              + fxy * (x.a * y.b + y.a * x.b)};
}
template <typename R>
__device__ __forceinline__ HD<R> habs(HD<R> x) {
  const R s = x.v > R(0) ? R(1) : (x.v < R(0) ? R(-1) : R(0));
  return {x.v * s, x.a * s, x.b * s, x.ab * s};
}
// |x|^p for p != 0
template <typename R>
__device__ __forceinline__ HD<R> hpow(HD<R> x, R p) {
  const R f0 = dpow(x.v, p);
  return chain(x, f0, p * dpow(x.v, p - R(1)), p * (p - R(1)) * dpow(x.v, p - R(2)));
}
// x / sqrt(x^2 + eps^2), the models' smooth sign
template <typename R>
__device__ __forceinline__ HD<R> hsmooth_sign(HD<R> x, R eps) {
  const R r = dsqrt(x.v * x.v + eps * eps);
  const R r3 = r * r * r;
  return chain(x, x.v / r, eps * eps / r3, R(-3) * eps * eps * x.v / (r3 * r * r));
}
// the floating remainder of jnp.mod for L > 0 (derivative 1)
template <typename R>
__device__ __forceinline__ HD<R> hmod(HD<R> x, R L) {
  R r = dfmod(x.v, L);
  if (r < R(0)) r = r + L;
  return {r, x.a, x.b, x.ab};
}

struct Params {
  double L_f, L_r, m, I_z, c_da, c_dr, c_r, p_r;
  double Df, Dr, Bf, Br, Cf, Cr, lin_f, lin_r;  // lin_*: linear tire gain incl. axle load
  int tire_linear, drive_rear, simple_slip;
};

template <typename R>
struct Track {
  const R* kp;   // (n_kp, 6): x, y, psi, cumulative length, segment length, curvature
  const R* cum;  // (n_kp,) unwrapped tangent angle at the key points
  int n_kp;
  R length;
};

// DynamicsModel: track.curvature(s), piecewise constant; the segment of the last
// breakpoint <= s (searchsorted side right over kp[1:-1, 3])
template <typename R>
__device__ HD<R> curvature(const Track<R>& t, HD<R> s) {
  const HD<R> sb = hmod(hmod(s, t.length) + t.length, t.length);
  int idx = 0;
  for (int k = 1; k < t.n_kp - 1; ++k) idx += t.kp[k * 6 + 3] <= sb.v ? 1 : 0;
  return cst(t.kp[(1 + idx) * 6 + 5]);
}

// track.tangent_angle(s): jnp.interp of the cumulative angle over the key points
template <typename R>
__device__ HD<R> tangent_angle(const Track<R>& t, HD<R> s, R eps) {
  const HD<R> x = hmod(hmod(s, t.length) + t.length, t.length);
  const int n = t.n_kp;
  int i = 0;
  for (int k = 0; k < n; ++k) i += t.kp[k * 6 + 3] <= x.v ? 1 : 0;
  i = i < 1 ? 1 : (i > n - 1 ? n - 1 : i);
  const R xp_im = t.kp[(i - 1) * 6 + 3];
  const R dx = t.kp[i * 6 + 3] - xp_im;
  const R df = t.cum[i] - t.cum[i - 1];
  if (x.v < t.kp[3]) return cst(t.cum[0]);
  if (x.v > t.kp[(n - 1) * 6 + 3]) return cst(t.cum[n - 1]);
  const R adx = dx < R(0) ? -dx : dx;
  if (adx <= eps) return cst(t.cum[i - 1]);
  return ((x - xp_im) / dx) * df + t.cum[i - 1];
}

// body_accels of _DynamicBicycleBase: (ax, ay, yaw acceleration)
template <typename R>
__device__ void body_accels(const Params& p, HD<R> vx, HD<R> vy, HD<R> psidot, HD<R> u_a,
                            HD<R> u_s, HD<R>& ax, HD<R>& ay, HD<R>& alphaz) {
  const HD<R> vyf = vy + R(p.L_f) * psidot;
  const HD<R> cs = hcos(u_s), ss = hsin(u_s);
  HD<R> alpha_f;
  if (p.simple_slip)
    alpha_f = -hatan2(vyf, vx) + u_s;
  else
    alpha_f = -hatan2(vyf * cs - vx * ss, vx * cs + vyf * ss);
  const HD<R> alpha_r = -hatan2(vy - R(p.L_r) * psidot, vx);

  HD<R> fyf, fyr;
  if (p.tire_linear) {
    fyf = R(p.lin_f) * alpha_f;
    fyr = R(p.lin_r) * alpha_r;
  } else {
    fyf = R(p.Df) * hsin(R(p.Cf) * hatan(R(p.Bf) * alpha_f));
    fyr = R(p.Dr) * hsin(R(p.Cr) * hatan(R(p.Br) * alpha_r));
  }

  // dgsqp_torch.utils.math.resistance: only the terms with a nonzero coefficient
  HD<R> F = cst(R(0));
  if (p.c_da != 0.0) F = F - R(p.c_da) * vx;
  if (p.c_dr != 0.0) F = F - R(p.c_dr) * vx * habs(vx);
  if (p.c_r != 0.0) {
    const HD<R> mag = p.p_r != 0.0 ? hpow(habs(vx), R(p.p_r)) : cst(R(1));
    F = F - R(p.c_r) * mag * hsmooth_sign(vx, R(1e-3));
  }

  const R m = R(p.m);
  if (p.drive_rear) {
    ax = u_a + (F - fyf * ss) / m;
    ay = (fyf * cs + fyr) / m;
  } else {
    const HD<R> half = u_a / R(2);
    ax = half + half * cs + (F - fyf * ss) / m;
    ay = half * ss + (fyf * cs + fyr) / m;
  }
  alphaz = (R(p.L_f) * fyf * cs - R(p.L_r) * fyr) / R(p.I_z);
}

// not inlined: the four sub-step calls of rk4 (and those of rk2, rk3, euler) share one
// body, which keeps the build short and the registers of a thread in bounds
template <typename R>
__device__ __noinline__ void fc(int kind, const Params& p, const Track<R>& t, R eps, const HD<R>* q,
                   const HD<R>* u, HD<R>* dq) {
  HD<R> ax, ay, alphaz;
  if (kind == kGlobal || kind == kProgress) {
    const HD<R> vx = q[0], vy = q[1], psidot = q[2], psi = q[5];
    body_accels(p, vx, vy, psidot, u[0], u[1], ax, ay, alphaz);
    const HD<R> cp = hcos(psi), sp = hsin(psi);
    dq[0] = ax + psidot * vy;
    dq[1] = ay - psidot * vx;
    dq[2] = alphaz;
    dq[3] = vx * cp - vy * sp;
    dq[4] = vy * cp + vx * sp;
    dq[5] = psidot;
    if (kind == kProgress) dq[6] = u[2];
  } else if (kind == kFrenet) {
    const HD<R> vx = q[0], vy = q[1], psidot = q[2], epsi = q[3], s = q[4], xtran = q[5];
    body_accels(p, vx, vy, psidot, u[0], u[1], ax, ay, alphaz);
    const HD<R> c = curvature(t, s);
    const HD<R> ce = hcos(epsi), se = hsin(epsi);
    const HD<R> ds = (vx * ce - vy * se) / (R(1) - xtran * c);
    dq[0] = ax + psidot * vy;
    dq[1] = ay - psidot * vx;
    dq[2] = alphaz;
    dq[3] = psidot - c * ds;
    dq[4] = ds;
    dq[5] = vx * se + vy * ce;
  } else {
    const HD<R> vx = q[2], vy = q[3], psidot = q[4], epsi = q[5], s = q[6], xtran = q[7];
    body_accels(p, vx, vy, psidot, u[0], u[1], ax, ay, alphaz);
    const HD<R> c = curvature(t, s);
    const HD<R> psi_t = tangent_angle(t, s, eps);
    const HD<R> ce = hcos(epsi), se = hsin(epsi);
    const HD<R> cg = hcos(epsi + psi_t), sg = hsin(epsi + psi_t);
    const HD<R> ds = (vx * ce - vy * se) / (R(1) - xtran * c);
    dq[0] = vx * cg - vy * sg;
    dq[1] = vy * cg + vx * sg;
    dq[2] = ax + psidot * vy;
    dq[3] = ay - psidot * vx;
    dq[4] = alphaz;
    dq[5] = psidot - c * ds;
    dq[6] = ds;
    dq[7] = vx * se + vy * ce;
  }
}

// DynamicsModel.fd: method 0 euler, 1 rk2, 2 rk3, 3 rk4
template <typename R>
__device__ void step(int kind, int nq, int method, int M, R dt, R h, const Params& p,
                     const Track<R>& t, R eps, HD<R>* x, const HD<R>* u) {
  HD<R> a1[kMaxQ], a2[kMaxQ], a3[kMaxQ], a4[kMaxQ], y[kMaxQ];
  if (method == 0) {
    fc(kind, p, t, eps, x, u, a1);
    for (int i = 0; i < nq; ++i) x[i] = x[i] + dt * a1[i];
    return;
  }
  for (int sub = 0; sub < M; ++sub) {
    if (method == 3) {
      fc(kind, p, t, eps, x, u, a1);
      for (int i = 0; i < nq; ++i) y[i] = x[i] + (h / R(2)) * a1[i];
      fc(kind, p, t, eps, y, u, a2);
      for (int i = 0; i < nq; ++i) y[i] = x[i] + (h / R(2)) * a2[i];
      fc(kind, p, t, eps, y, u, a3);
      for (int i = 0; i < nq; ++i) y[i] = x[i] + h * a3[i];
      fc(kind, p, t, eps, y, u, a4);
      for (int i = 0; i < nq; ++i)
        x[i] = x[i] + (h * (a1[i] + R(2) * a2[i] + R(2) * a3[i] + a4[i])) / R(6);
    } else if (method == 2) {
      fc(kind, p, t, eps, x, u, a1);
      for (int i = 0; i < nq; ++i) a1[i] = h * a1[i];
      for (int i = 0; i < nq; ++i) y[i] = x[i] + a1[i] / R(2);
      fc(kind, p, t, eps, y, u, a2);
      for (int i = 0; i < nq; ++i) a2[i] = h * a2[i];
      for (int i = 0; i < nq; ++i) y[i] = x[i] - a1[i] + R(2) * a2[i];
      fc(kind, p, t, eps, y, u, a3);
      for (int i = 0; i < nq; ++i) a3[i] = h * a3[i];
      for (int i = 0; i < nq; ++i) x[i] = x[i] + (a1[i] + R(4) * a2[i] + a3[i]) / R(6);
    } else {
      fc(kind, p, t, eps, x, u, a1);
      for (int i = 0; i < nq; ++i) y[i] = x[i] + h * a1[i];
      fc(kind, p, t, eps, y, u, a2);
      for (int i = 0; i < nq; ++i) x[i] = x[i] + (h * (a1[i] + a2[i])) / R(2);
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
dyn_step_kernel(const R* __restrict__ q, const R* __restrict__ u, int n_pts, int kind, int nq,
                int nu, int method, int M, R dt, R h, Params p, Track<R> t, R eps, int order,
                R* __restrict__ f, R* __restrict__ J, R* __restrict__ H) {
  const int L = nq + nu;
  const int per = order == 0 ? 1 : (order == 1 ? L : L * (L + 1) / 2);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(n_pts) * per) return;
  const int pt = static_cast<int>(tid / per);
  int r = static_cast<int>(tid % per), i = 0, j = 0;
  if (order == 1) {
    i = j = r;
  } else if (order == 2) {
    while (r >= L - i) {
      r -= L - i;
      ++i;
    }
    j = i + r;
  }

  HD<R> x[kMaxQ], uu[kMaxU];
  for (int k = 0; k < nq; ++k) {
    const R v = q[static_cast<long long>(pt) * nq + k];
    x[k] = {v, R(order > 0 && k == i), R(order > 1 && k == j), R(0)};
  }
  for (int k = 0; k < nu; ++k) {
    const R v = u[static_cast<long long>(pt) * nu + k];
    uu[k] = {v, R(order > 0 && nq + k == i), R(order > 1 && nq + k == j), R(0)};
  }
  step(kind, nq, method, M, dt, h, p, t, eps, x, uu);

  if (i == 0 && j == 0)
    for (int k = 0; k < nq; ++k) f[static_cast<long long>(pt) * nq + k] = x[k].v;
  if (order >= 1 && i == j)
    for (int k = 0; k < nq; ++k) J[(static_cast<long long>(pt) * nq + k) * L + i] = x[k].a;
  if (order == 2)
    for (int k = 0; k < nq; ++k) {
      const long long base = (static_cast<long long>(pt) * nq + k) * L;
      H[(base + i) * L + j] = x[k].ab;
      H[(base + j) * L + i] = x[k].ab;
    }
}

template <typename R>
int launch(const void* q, const void* u, int n_pts, int kind, int nq, int nu, int method,
           int M, double dt, double h, const double* prm, const int* flags, const void* kp,
           const void* cum, int n_kp, double length, double eps, int order, void* f, void* J,
           void* H, int device, void* stream) {
  if (nq > kMaxQ || nu > kMaxU || kind < 0 || kind > 3 || order < 0 || order > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Params p{prm[0], prm[1], prm[2], prm[3], prm[4],  prm[5],  prm[6],  prm[7],
                 prm[8], prm[9], prm[10], prm[11], prm[12], prm[13], prm[14], prm[15],
                 flags[0], flags[1], flags[2]};
  const Track<R> t{static_cast<const R*>(kp), static_cast<const R*>(cum), n_kp, R(length)};
  const int L = nq + nu;
  const long long per = order == 0 ? 1 : (order == 1 ? L : L * (L + 1) / 2);
  const long long threads = static_cast<long long>(n_pts) * per;
  if (threads == 0) return 0;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  dyn_step_kernel<R><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const R*>(q), static_cast<const R*>(u), n_pts, kind, nq, nu, method, M,
      R(dt), R(h), p, t, R(eps), order, static_cast<R*>(f), static_cast<R*>(J),
      static_cast<R*>(H));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgsqp_dyn_step_f32(const void* q, const void* u, int n_pts, int kind, int nq,
                                  int nu, int method, int M, double dt, double h,
                                  const double* prm, const int* flags, const void* kp,
                                  const void* cum, int n_kp, double length, double eps,
                                  int order, void* f, void* J, void* H, int device,
                                  void* stream) {
  return launch<float>(q, u, n_pts, kind, nq, nu, method, M, dt, h, prm, flags, kp, cum, n_kp,
                       length, eps, order, f, J, H, device, stream);
}

extern "C" int dgsqp_dyn_step_f64(const void* q, const void* u, int n_pts, int kind, int nq,
                                  int nu, int method, int M, double dt, double h,
                                  const double* prm, const int* flags, const void* kp,
                                  const void* cum, int n_kp, double length, double eps,
                                  int order, void* f, void* J, void* H, int device,
                                  void* stream) {
  return launch<double>(q, u, n_pts, kind, nq, nu, method, M, dt, h, prm, flags, kp, cum,
                        n_kp, length, eps, order, f, J, H, device, stream);
}
