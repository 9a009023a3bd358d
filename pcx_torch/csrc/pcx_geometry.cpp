// pcx_torch native geometry engine: material-flag evaluation over
// staggered grids (the port's own copy of pcx's csrc/pcx_geometry.cpp).
//
// Host-side runtime component: evaluates the lattice "flag" predicates
// (reference: paper_2/dielectric.py:157-261) over all 3N^3 edge DoFs /
// N^3 volume DoFs with OpenMP, writing the masks that the dielectrics of
// pcx_torch are built from.  pcx_torch/geometry.py calls it through ctypes
// (pcx_torch/native.py) and gives bit-identical masks with numpy
// (use_native=False); the tests hold the two against each other.
//
// Build: python -m pcx_torch.native --build (or at first use).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr double PI = 3.14159265358979323846;

enum FlagId : int {
  SC_FLAT1 = 0,
  SC_FLAT2 = 1,
  SC_CURV = 2,
  BCC_SG = 3,
  BCC_DG = 4,
  FCC = 5,
};

struct Vec3 {
  double x, y, z;
};

inline Vec3 transform(double x, double y, double z, const double* m) {
  // Row-vector transform r' = r @ M, M = inv(CT^T) row-major (3x3).
  return {x * m[0] + y * m[3] + z * m[6],
          x * m[1] + y * m[4] + z * m[7],
          x * m[2] + y * m[5] + z * m[8]};
}

inline bool flag_sc_flat1(const Vec3& r) {
  return (r.x <= 0.25 && r.y <= 0.25) || (r.x <= 0.25 && r.z <= 0.25) ||
         (r.y <= 0.25 && r.z <= 0.25);
}

inline bool flag_sc_flat2(const Vec3& r) {
  return (r.x <= 0.25 && r.y <= 0.25) ||
         (r.x <= 0.25 && r.z >= 0.25 && r.z <= 0.5) ||
         (r.y >= 0.5 && r.y <= 0.75 && r.z >= 0.5 && r.z <= 0.75) ||
         (r.x >= 0.5 && r.x <= 0.75 && r.z >= 0.75);
}

inline bool flag_sc_curv(const Vec3& r) {
  const double r1 = 0.11, R1 = 0.345;
  const double cx = r.x - 0.5, cy = r.y - 0.5, cz = r.z - 0.5;
  const double x2 = cx * cx, y2 = cy * cy, z2 = cz * cz;
  return (x2 + y2 + z2 <= R1 * R1) || (x2 + y2 <= r1 * r1) ||
         (x2 + z2 <= r1 * r1) || (y2 + z2 <= r1 * r1);
}

inline double gyroid(const Vec3& r) {
  return std::sin(2 * PI * r.x) * std::cos(2 * PI * r.y) +
         std::sin(2 * PI * r.y) * std::cos(2 * PI * r.z) +
         std::sin(2 * PI * r.z) * std::cos(2 * PI * r.x);
}

// FCC: 18 spheres (r = 0.12) + 16 ellipsoidal connectors (b = 0.11).
struct FccGeometry {
  double sphere_c[18][3];
  double ell_c[16][3];   // ellipsoid centers o_i + basis_j
  double ell_d[16][3];   // unit axis directions
  double ell_a2[16];     // semi-axis^2 along d
  double b2 = 0.11 * 0.11;

  FccGeometry() {
    const double basis[4][3] = {
        {0, 0, 0}, {0, 0.5, 0.5}, {0.5, 0, 0.5}, {0.5, 0.5, 0}};
    const double corners[14][3] = {
        {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {0, 1, 1}, {1, 0, 1},
        {1, 1, 0}, {1, 1, 1}, {0, 0.5, 0.5}, {0.5, 0, 0.5}, {0.5, 0.5, 0},
        {1, 0.5, 0.5}, {0.5, 1, 0.5}, {0.5, 0.5, 1}};
    const double cnt = 0.25;
    for (int i = 0; i < 14; ++i)
      for (int d = 0; d < 3; ++d) sphere_c[i][d] = corners[i][d];
    for (int i = 0; i < 4; ++i)
      for (int d = 0; d < 3; ++d) sphere_c[14 + i][d] = cnt + basis[i][d];

    int e = 0;
    for (int i = 0; i < 4; ++i) {
      double o[3], dir[3], c2 = 0;
      for (int d = 0; d < 3; ++d) {
        o[d] = (basis[i][d] + cnt) / 2;
        dir[d] = (basis[i][d] - cnt) / 2;
        c2 += dir[d] * dir[d];
      }
      const double c = std::sqrt(c2);
      for (int d = 0; d < 3; ++d) dir[d] /= c;
      const double a2 = b2 + c2;  // hypot(b, c)^2
      for (int j = 0; j < 4; ++j, ++e) {
        for (int d = 0; d < 3; ++d) {
          ell_c[e][d] = o[d] + basis[j][d];
          ell_d[e][d] = dir[d];
        }
        ell_a2[e] = a2;
      }
    }
  }

  bool contains(const Vec3& r) const {
    const double rr = 0.12 * 0.12;
    for (int i = 0; i < 18; ++i) {
      const double dx = r.x - sphere_c[i][0], dy = r.y - sphere_c[i][1],
                   dz = r.z - sphere_c[i][2];
      if (dx * dx + dy * dy + dz * dz < rr) return true;
    }
    for (int e = 0; e < 16; ++e) {
      const double dx = r.x - ell_c[e][0], dy = r.y - ell_c[e][1],
                   dz = r.z - ell_c[e][2];
      const double l1v = dx * ell_d[e][0] + dy * ell_d[e][1] + dz * ell_d[e][2];
      const double l1 = l1v * l1v;
      const double l2 = dx * dx + dy * dy + dz * dz - l1;
      if (l1 / ell_a2[e] + l2 / b2 < 1.0) return true;
    }
    return false;
  }
};

inline bool eval_flag(int flag_id, const Vec3& r, const FccGeometry& fcc) {
  switch (flag_id) {
    case SC_FLAT1: return flag_sc_flat1(r);
    case SC_FLAT2: return flag_sc_flat2(r);
    case SC_CURV:  return flag_sc_curv(r);
    case BCC_SG:   return gyroid(r) > 1.1;
    case BCC_DG:   return std::fabs(gyroid(r)) > 1.1;
    case FCC:      return fcc.contains(r);
    default:       return false;
  }
}

}  // namespace

extern "C" {

// out: uint8[3*n^3], layout (component, i, j, k) C-order, 1 = material.
// ct_inv_t: row-major inv(CT^T).
int pcx_edge_mask(int n, int flag_id, const double* ct_inv_t, uint8_t* out) {
  if (n <= 0 || flag_id < 0 || flag_id > 5) return -1;
  static const FccGeometry fcc;
  const double inv_n = 1.0 / n;
  const int64_t n3 = static_cast<int64_t>(n) * n * n;
  for (int c = 0; c < 3; ++c) {
    const double ox = (c == 0) ? 0.5 : 0.0;
    const double oy = (c == 1) ? 0.5 : 0.0;
    const double oz = (c == 2) ? 0.5 : 0.0;
    uint8_t* dst = out + c * n3;
#pragma omp parallel for collapse(2) schedule(static)
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        const double x = (i + ox) * inv_n;
        const double y = (j + oy) * inv_n;
        uint8_t* row = dst + (static_cast<int64_t>(i) * n + j) * n;
        for (int k = 0; k < n; ++k) {
          const double z = (k + oz) * inv_n;
          row[k] = eval_flag(flag_id, transform(x, y, z, ct_inv_t), fcc);
        }
      }
    }
  }
  return 0;
}

// out: uint8[n^3], layout (i, j, k) C-order; cell centers (+1/2 everywhere).
int pcx_volume_mask(int n, int flag_id, const double* ct_inv_t, uint8_t* out) {
  if (n <= 0 || flag_id < 0 || flag_id > 5) return -1;
  static const FccGeometry fcc;
  const double inv_n = 1.0 / n;
#pragma omp parallel for collapse(2) schedule(static)
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      const double x = (i + 0.5) * inv_n;
      const double y = (j + 0.5) * inv_n;
      uint8_t* row = out + (static_cast<int64_t>(i) * n + j) * n;
      for (int k = 0; k < n; ++k) {
        const double z = (k + 0.5) * inv_n;
        row[k] = eval_flag(flag_id, transform(x, y, z, ct_inv_t), fcc);
      }
    }
  }
  return 0;
}

int pcx_geometry_version() { return 1; }

}  // extern "C"
