// Native CPU kernels for the inverse-compositional alignment engine.
//
// Plays the role the reference implementation delegates to Numba-compiled
// kernels (reference: src/bicubic_interpolation.py:120-152 handwritten warp,
// src/transformation.py:143-186 projection, src/image_optimisation.py:158-194
// steepest-descent images): a portable, OpenMP-parallel native engine used
//  (a) as an accelerator-independent correctness oracle for the JAX/Pallas
//      path, and
//  (b) as a fast CPU fallback for driving/debugging without an accelerator.
//
// Algomithmic semantics follow the IPOL "Inverse Compositional Algorithm
// for Parametric Registration" (2016.153): Keys cubic convolution with
// a = -0.5 (Catmull-Rom), Neumann (clip-to-edge) boundary taps, and the
// delta-margin domain test on the real-valued source coordinates.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Homogeneous 3x3 matrix from the padded 8-parameter vector; layouts match
// inverse_compositional_algorithm_tpu.ops.transforms.params_to_matrix.
// ttype: 1=translation 2=euclidean 3=similarity 4=affinity 5=homography.
struct Mat3 {
  double m[9];
};

Mat3 params_to_matrix(const double* p, int ttype) {
  Mat3 r{{1, 0, 0, 0, 1, 0, 0, 0, 1}};
  switch (ttype) {
    case 1:
      r.m[2] = p[0];
      r.m[5] = p[1];
      break;
    case 2: {
      const double c = std::cos(p[2]), s = std::sin(p[2]);
      r.m[0] = c; r.m[1] = -s; r.m[2] = p[0];
      r.m[3] = s; r.m[4] = c;  r.m[5] = p[1];
      break;
    }
    case 3:
      r.m[0] = 1 + p[2]; r.m[1] = -p[3];    r.m[2] = p[0];
      r.m[3] = p[3];     r.m[4] = 1 + p[2]; r.m[5] = p[1];
      break;
    case 4:
      r.m[0] = 1 + p[2]; r.m[1] = p[3];     r.m[2] = p[0];
      r.m[3] = p[4];     r.m[4] = 1 + p[5]; r.m[5] = p[1];
      break;
    case 5:
      r.m[0] = 1 + p[0]; r.m[1] = p[1];     r.m[2] = p[2];
      r.m[3] = p[3];     r.m[4] = 1 + p[4]; r.m[5] = p[5];
      r.m[6] = p[6];     r.m[7] = p[7];
      break;
    default:
      break;
  }
  return r;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Keys a=-0.5 weights for fractional offset t in [0,1): taps floor-1..floor+2.
inline void keys_weights(double t, double w[4]) {
  const double t2 = t * t, t3 = t2 * t;
  w[0] = -0.5 * t3 + t2 - 0.5 * t;
  w[1] = 1.5 * t3 - 2.5 * t2 + 1.0;
  w[2] = -1.5 * t3 + 2.0 * t2 + 0.5 * t;
  w[3] = 0.5 * t3 - 0.5 * t2;
}

// Derivative rho'(t^2) of the robust error function; semantics of
// inverse_compositional_algorithm_tpu.ops.normal_equations.rhop (the
// TF/C++ vectorized TRUNCATED_QUADRATIC, reference
// src/keras-tf/tf_image_optimisation.py:7-43).
inline double rhop(double t2, double lam, int loss) {
  const double lam2 = lam * lam;
  switch (loss) {
    case 0: return 1.0;                                   // QUADRATIC
    case 1: return t2 < lam2 ? 1.0 : 0.0;                 // TRUNCATED_QUAD
    case 2: { const double s = lam2 + t2; return lam2 / (s * s); }  // GM
    case 3: return 1.0 / (lam2 + t2);                     // LORENTZIAN
    case 4: return 1.0 / std::sqrt(t2 + lam2);            // CHARBONNIER
    default: return 1.0;
  }
}

int nparams_of(int ttype) {
  switch (ttype) {
    case 1: return 2;
    case 2: return 3;
    case 3: return 4;
    case 4: return 6;
    case 5: return 8;
    default: return 0;
  }
}

// Padded params from a (normalized) homogeneous matrix; mirror of
// ops.transforms.matrix_to_params / reference src/transformation.py:238-263.
void matrix_to_params(const Mat3& m, int ttype, double* p) {
  for (int i = 0; i < 8; ++i) p[i] = 0.0;
  switch (ttype) {
    case 1: p[0] = m.m[2]; p[1] = m.m[5]; break;
    case 2: p[0] = m.m[2]; p[1] = m.m[5];
            p[2] = std::atan2(m.m[3], m.m[0]); break;
    case 3: p[0] = m.m[2]; p[1] = m.m[5];
            p[2] = m.m[0] - 1.0; p[3] = m.m[3]; break;
    case 4: p[0] = m.m[2]; p[1] = m.m[5];
            p[2] = m.m[0] - 1.0; p[3] = m.m[1];
            p[4] = m.m[3]; p[5] = m.m[4] - 1.0; break;
    case 5: p[0] = m.m[0] - 1.0; p[1] = m.m[1]; p[2] = m.m[2];
            p[3] = m.m[3]; p[4] = m.m[4] - 1.0; p[5] = m.m[5];
            p[6] = m.m[6]; p[7] = m.m[7]; break;
    default: break;
  }
}

// Inverse-compositional update p <- p o dp^-1 via M(p) @ adj(M(dp)),
// normalized by the homogeneous scale; degenerate updates (w^2 <= 1e-10)
// leave p unchanged (ops.transforms.compose_inverse / reference
// src/transformation.py:36-141 guards at :79,:98,:131).
void compose_inverse(double* p, const double* dp, int ttype) {
  if (ttype == 1) {
    p[0] -= dp[0];
    p[1] -= dp[1];
    return;
  }
  const Mat3 mp = params_to_matrix(p, ttype);
  const Mat3 md = params_to_matrix(dp, ttype);
  const double* a = md.m;
  Mat3 adj;  // transpose of the cofactor matrix
  adj.m[0] = a[4] * a[8] - a[5] * a[7];
  adj.m[1] = a[2] * a[7] - a[1] * a[8];
  adj.m[2] = a[1] * a[5] - a[2] * a[4];
  adj.m[3] = a[5] * a[6] - a[3] * a[8];
  adj.m[4] = a[0] * a[8] - a[2] * a[6];
  adj.m[5] = a[2] * a[3] - a[0] * a[5];
  adj.m[6] = a[3] * a[7] - a[4] * a[6];
  adj.m[7] = a[1] * a[6] - a[0] * a[7];
  adj.m[8] = a[0] * a[4] - a[1] * a[3];
  Mat3 u;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += mp.m[i * 3 + k] * adj.m[k * 3 + j];
      u.m[i * 3 + j] = s;
    }
  const double w = u.m[8];
  if (w * w <= 1e-10) return;
  for (int i = 0; i < 9; ++i) u.m[i] /= w;
  matrix_to_params(u, ttype, p);
}

// 8x8 Cholesky solve with a live-parameter mask: dead rows/cols get an
// identity diagonal (their rhs is 0, so their solution is 0) — the exact
// scheme of ops.normal_equations.solve_normal. Returns false if the
// factorization produces a non-finite value (singular H -> dp = 0,
// reference src/derivatives.py:126-129).
bool cholesky_solve8(const double* hin, const double* bin, int np_live,
                     double* dp) {
  double a[64];
  double b[8];
  for (int i = 0; i < 8; ++i) {
    b[i] = i < np_live ? bin[i] : 0.0;
    for (int j = 0; j < 8; ++j) {
      a[i * 8 + j] = (i < np_live && j < np_live)
          ? hin[i * 8 + j] : (i == j ? 1.0 : 0.0);
    }
  }
  double l[64] = {0};
  for (int j = 0; j < 8; ++j) {
    double s = a[j * 8 + j];
    for (int k = 0; k < j; ++k) s -= l[j * 8 + k] * l[j * 8 + k];
    if (!(s > 0.0)) return false;
    const double ljj = std::sqrt(s);
    l[j * 8 + j] = ljj;
    for (int i = j + 1; i < 8; ++i) {
      double t = a[i * 8 + j];
      for (int k = 0; k < j; ++k) t -= l[i * 8 + k] * l[j * 8 + k];
      l[i * 8 + j] = t / ljj;
    }
  }
  double y[8];
  for (int i = 0; i < 8; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= l[i * 8 + k] * y[k];
    y[i] = s / l[i * 8 + i];
  }
  for (int i = 7; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 8; ++k) s -= l[k * 8 + i] * dp[k];
    dp[i] = s / l[i * 8 + i];
    if (!std::isfinite(dp[i])) return false;
  }
  for (int i = np_live; i < 8; ++i) dp[i] = 0.0;
  return true;
}

// Per-pixel Jacobian columns of the warp (raw, unpreconditioned);
// semantics of ops.transforms.jacobian_fields / reference derivatives.py:7-70.
inline void jacobian_cols(int ttype, double x, double y, double* jx,
                          double* jy) {
  for (int q = 0; q < 8; ++q) jx[q] = jy[q] = 0.0;
  switch (ttype) {
    case 1: jx[0] = 1; jy[1] = 1; break;
    case 2: jx[0] = 1; jx[2] = -y; jy[1] = 1; jy[2] = x; break;
    case 3: jx[0] = 1; jx[2] = x; jx[3] = -y;
            jy[1] = 1; jy[2] = y; jy[3] = x; break;
    case 4: jx[0] = 1; jx[2] = x; jx[3] = y;
            jy[1] = 1; jy[4] = x; jy[5] = y; break;
    case 5: jx[0] = x; jx[1] = y; jx[2] = 1; jx[6] = -x * x; jx[7] = -x * y;
            jy[3] = x; jy[4] = y; jy[5] = 1; jy[6] = -x * y; jy[7] = -y * y;
            break;
    default: break;
  }
}

}  // namespace

extern "C" {

// Warp one image: img [H, W, C] row-major float32 -> out [H, W, C].
// Out-of-domain pixels (source within `delta` of the border) become NaN if
// nanifoutside, else 0 — the semantics of the reference's handwritten warp.
void ica_warp_bicubic(const float* img, int64_t h, int64_t w, int64_t c,
                      const double* p8, int ttype, int nanifoutside,
                      int delta, float* out) {
  const Mat3 mt = params_to_matrix(p8, ttype);
  const float fill = nanifoutside
      ? std::numeric_limits<float>::quiet_NaN() : 0.0f;
  const double d = static_cast<double>(delta);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < h; ++i) {
    for (int64_t j = 0; j < w; ++j) {
      const double den = mt.m[6] * j + mt.m[7] * i + mt.m[8];
      const double gx = (mt.m[0] * j + mt.m[1] * i + mt.m[2]) / den;
      const double gy = (mt.m[3] * j + mt.m[4] * i + mt.m[5]) / den;
      float* o = out + (i * w + j) * c;
      const bool outside = gx < d || gx > (w - 1) - d ||
                           gy < d || gy > (h - 1) - d;
      if (outside) {
        for (int64_t k = 0; k < c; ++k) o[k] = fill;
        continue;
      }
      const double fx = std::floor(gx), fy = std::floor(gy);
      const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
      double wx[4], wy[4];
      keys_weights(gx - fx, wx);
      keys_weights(gy - fy, wy);
      int xi[4], yi[4];
      for (int t = 0; t < 4; ++t) {
        xi[t] = clampi(x0 - 1 + t, 0, static_cast<int>(w) - 1);
        yi[t] = clampi(y0 - 1 + t, 0, static_cast<int>(h) - 1);
      }
      for (int64_t k = 0; k < c; ++k) {
        double acc = 0.0;
        for (int ty = 0; ty < 4; ++ty) {
          const float* row = img + (static_cast<int64_t>(yi[ty]) * w) * c;
          double rowacc = 0.0;
          for (int tx = 0; tx < 4; ++tx) {
            rowacc += wx[tx] * row[static_cast<int64_t>(xi[tx]) * c + k];
          }
          acc += wy[ty] * rowacc;
        }
        o[k] = static_cast<float>(acc);
      }
    }
  }
}

// Central-difference gradients with zero borders (reference semantics:
// src/inverse_compositional_algorithm.py:81-82).
void ica_gradients(const float* img, int64_t h, int64_t w, int64_t c,
                   float* ix, float* iy) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < h; ++i) {
    for (int64_t j = 0; j < w; ++j) {
      for (int64_t k = 0; k < c; ++k) {
        const int64_t idx = (i * w + j) * c + k;
        ix[idx] = (j > 0 && j < w - 1)
            ? 0.5f * (img[(i * w + j + 1) * c + k] -
                      img[(i * w + j - 1) * c + k])
            : 0.0f;
        iy[idx] = (i > 0 && i < h - 1)
            ? 0.5f * (img[((i + 1) * w + j) * c + k] -
                      img[((i - 1) * w + j) * c + k])
            : 0.0f;
      }
    }
  }
}

// Accumulate the 8x8 normal matrix and 8-vector from the five
// channel-reduced maps (same contraction as ops/normal_equations.py, raw
// unpreconditioned Jacobian columns).
void ica_normal_eq(const float* w1, const float* w2, const float* w3,
                   const float* wu, const float* wv, int64_t h, int64_t w,
                   int ttype, double* h_out, double* b_out) {
  const int64_t n = h * w;
  double hacc[64] = {0};
  double bacc[8] = {0};
#pragma omp parallel
  {
    double hloc[64] = {0};
    double bloc[8] = {0};
    double jx[8], jy[8];
#pragma omp for schedule(static)
    for (int64_t p = 0; p < n; ++p) {
      const double x = static_cast<double>(p % w);
      const double y = static_cast<double>(p / w);
      for (int q = 0; q < 8; ++q) jx[q] = jy[q] = 0.0;
      switch (ttype) {
        case 1: jx[0] = 1; jy[1] = 1; break;
        case 2: jx[0] = 1; jx[2] = -y; jy[1] = 1; jy[2] = x; break;
        case 3: jx[0] = 1; jx[2] = x; jx[3] = -y;
                jy[1] = 1; jy[2] = y; jy[3] = x; break;
        case 4: jx[0] = 1; jx[2] = x; jx[3] = y;
                jy[1] = 1; jy[4] = x; jy[5] = y; break;
        case 5: jx[0] = x; jx[1] = y; jx[2] = 1; jx[6] = -x * x;
                jx[7] = -x * y;
                jy[3] = x; jy[4] = y; jy[5] = 1; jy[6] = -x * y;
                jy[7] = -y * y; break;
        default: break;
      }
      const double a = w1[p], bqq = w2[p], cq = w3[p];
      const double uu = wu[p], vv = wv[p];
      for (int q = 0; q < 8; ++q) {
        const double p1 = a * jx[q] + bqq * jy[q];
        const double p2 = bqq * jx[q] + cq * jy[q];
        bloc[q] += uu * jx[q] + vv * jy[q];
        for (int m = 0; m < 8; ++m) {
          hloc[q * 8 + m] += p1 * jx[m] + p2 * jy[m];
        }
      }
    }
#pragma omp critical
    {
      for (int q = 0; q < 64; ++q) hacc[q] += hloc[q];
      for (int q = 0; q < 8; ++q) bacc[q] += bloc[q];
    }
  }
  for (int q = 0; q < 64; ++q) h_out[q] = hacc[q];
  for (int q = 0; q < 8; ++q) b_out[q] = bacc[q];
}

// Complete single-pair (robust) inverse-compositional solve — the native
// twin of models.ic.ic_solve for one pair: gradient/delta-band precompute,
// Hessian hoisted for the quadratic algorithm, per-iteration rho'-weighted
// IRLS with lambda annealing otherwise, f64 Cholesky solve, IC composition.
// Semantics of reference src/inverse_compositional_algorithm.py:17-261.
//
//   i1, i2: [H, W, C] float32; p8: [8] in/out padded parameters.
//   robust: 0 quadratic .. 4 charbonnier; lam <= 0 -> annealing schedule.
// Returns last ||dp|| in *error_out and applied iterations in *niters_out.
void ica_solve(const float* i1, const float* i2, int64_t h, int64_t w,
               int64_t c, double* p8, int ttype, int robust, double lam_in,
               double tol, int max_iter, int nanifoutside, int delta,
               double* error_out, int* niters_out) {
  const int64_t n = h * w;
  const int np_live = nparams_of(ttype);
  const bool is_robust = robust != 0;

  // Gradients with the delta boundary band zeroed (reference :81-93).
  float* ix = new float[n * c];
  float* iy = new float[n * c];
  ica_gradients(i1, h, w, c, ix, iy);
  if (nanifoutside && delta > 0) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < h; ++i) {
      for (int64_t j = 0; j < w; ++j) {
        const bool in_band = i < delta || i >= h - delta ||
                             j < delta || j >= w - delta;
        if (!in_band) continue;
        for (int64_t k = 0; k < c; ++k) {
          ix[(i * w + j) * c + k] = 0.0f;
          iy[(i * w + j) * c + k] = 0.0f;
        }
      }
    }
  }

  float* iw = new float[n * c];
  double h_quad[64];
  bool have_hq = false;
  double lam = lam_in > 0 ? lam_in : 80.0;   // LAMBDA_0
  double err = 1e10;
  int it = 0;

  while (err > tol && it < max_iter) {
    ica_warp_bicubic(i2, h, w, c, p8, ttype, nanifoutside, delta, iw);

    double hacc[64] = {0};
    double bacc[8] = {0};
#pragma omp parallel
    {
      double hloc[64] = {0};
      double bloc[8] = {0};
      double jx[8], jy[8];
#pragma omp for schedule(static)
      for (int64_t pix = 0; pix < n; ++pix) {
        const double x = static_cast<double>(pix % w);
        const double y = static_cast<double>(pix / w);
        double gxx = 0, gxy = 0, gyy = 0, u = 0, v = 0, t2 = 0;
        for (int64_t k = 0; k < c; ++k) {
          const double gx = ix[pix * c + k];
          const double gy = iy[pix * c + k];
          float wv = iw[pix * c + k];
          // NaN marks out-of-domain (nanifoutside): residual contributes 0.
          const double di = std::isnan(wv)
              ? 0.0 : static_cast<double>(wv) - i1[pix * c + k];
          gxx += gx * gx; gxy += gx * gy; gyy += gy * gy;
          u += gx * di; v += gy * di; t2 += di * di;
        }
        const double rho = is_robust ? rhop(t2, lam, robust) : 1.0;
        jacobian_cols(ttype, x, y, jx, jy);
        const double a = rho * gxx, bq = rho * gxy, cq = rho * gyy;
        const double uu = rho * u, vv = rho * v;
        const bool need_h = is_robust || !have_hq;
        for (int q = 0; q < np_live; ++q) {
          bloc[q] += uu * jx[q] + vv * jy[q];
          if (need_h) {
            const double p1 = a * jx[q] + bq * jy[q];
            const double p2 = bq * jx[q] + cq * jy[q];
            for (int m = 0; m < np_live; ++m)
              hloc[q * 8 + m] += p1 * jx[m] + p2 * jy[m];
          }
        }
      }
#pragma omp critical
      {
        for (int q = 0; q < 64; ++q) hacc[q] += hloc[q];
        for (int q = 0; q < 8; ++q) bacc[q] += bloc[q];
      }
    }
    const double* hcur = hacc;
    if (!is_robust) {
      if (!have_hq) {
        for (int q = 0; q < 64; ++q) h_quad[q] = hacc[q];
        have_hq = true;
      }
      hcur = h_quad;   // the defining IC property: H hoisted (ref :102-103)
    } else if (lam_in <= 0 && lam > 5.0) {
      lam = lam * 0.9 < 5.0 ? 5.0 : lam * 0.9;  // LAMBDA_RATIO / LAMBDA_N
    }

    double dp[8] = {0};
    if (!cholesky_solve8(hcur, bacc, np_live, dp)) {
      for (int q = 0; q < 8; ++q) dp[q] = 0.0;  // singular -> dp = 0
    }
    double e2 = 0.0;
    for (int q = 0; q < 8; ++q) e2 += dp[q] * dp[q];
    err = std::sqrt(e2);
    compose_inverse(p8, dp, ttype);
    ++it;
  }

  delete[] ix;
  delete[] iy;
  delete[] iw;
  *error_out = err;
  *niters_out = it;
}

}  // extern "C"
