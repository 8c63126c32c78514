// Native host kernels of the port's mesh stage, beside mesh_native.cpp (built
// into the same library, bound in slice3d_tpu_torch/mesh/__init__.py):
//   * s3d_simplify      — quadric-error-metric edge-collapse simplification;
//   * s3d_points_inside — point-in-mesh by triangle bucketing and ray parity;
//   * s3d_voxelize      — conservative surface voxelization (SAT test).
// The JAX package's mesh_extra.cpp line for line, without its OBJ
// serializer (the port's is in mesh_native.cpp), so both give the same bits.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>
#include <array>
#include <functional>

namespace {

struct Vec3 {
  double x, y, z;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
static inline double dot3(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline Vec3 cross3(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// Symmetric 4x4 quadric, stored as upper triangle (10 doubles).
struct Quadric {
  double m[10] = {0};
  void add_plane(double a, double b, double c, double d, double w = 1.0) {
    const double v[4] = {a, b, c, d};
    int k = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = i; j < 4; ++j) m[k++] += w * v[i] * v[j];
  }
  Quadric& operator+=(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
    return *this;
  }
  // Solve grad(v^T Q v) = 0 for the optimal placement: A x = -b with
  // A = Q[0:3,0:3], b = Q[0:3,3].  Returns false if near-singular.
  bool optimal(Vec3* out) const {
    const double a11 = m[0], a12 = m[1], a13 = m[2], b1 = m[3];
    const double a22 = m[4], a23 = m[5], b2 = m[6];
    const double a33 = m[7], b3 = m[8];
    const double det = a11 * (a22 * a33 - a23 * a23) -
                       a12 * (a12 * a33 - a23 * a13) +
                       a13 * (a12 * a23 - a22 * a13);
    if (std::fabs(det) < 1e-12) return false;
    const double inv = 1.0 / det;
    out->x = -inv * (b1 * (a22 * a33 - a23 * a23) - a12 * (b2 * a33 - a23 * b3) +
                     a13 * (b2 * a23 - a22 * b3));
    out->y = -inv * (a11 * (b2 * a33 - a23 * b3) - b1 * (a12 * a33 - a13 * a23) +
                     a13 * (a12 * b3 - b2 * a13));
    out->z = -inv * (a11 * (a22 * b3 - b2 * a23) - a12 * (a12 * b3 - b2 * a13) +
                     b1 * (a12 * a23 - a22 * a13));
    return true;
  }

  double eval(const Vec3& p) const {
    const double v[4] = {p.x, p.y, p.z, 1.0};
    // expand symmetric form
    double full[4][4];
    int k = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = i; j < 4; ++j) {
        full[i][j] = m[k];
        full[j][i] = m[k];
        ++k;
      }
    double s = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) s += v[i] * full[i][j] * v[j];
    return s;
  }
};

struct Collapse {
  double cost;
  int u, v;        // collapse u -> v (v keeps position `pos`)
  int version;     // staleness check
  Vec3 pos;
  bool operator>(const Collapse& o) const { return cost > o.cost; }
};

}  // namespace

extern "C" {

void s3d_free(void* p);  // defined in mesh_native.cpp

// Quadric-error edge-collapse simplification to ~target_faces.
int s3d_simplify(const float* verts, int64_t nv, const int64_t* faces,
                 int64_t nf, int64_t target_faces, float** out_verts,
                 int64_t* out_nv, int64_t** out_faces, int64_t* out_nf) {
  std::vector<Vec3> v(nv);
  for (int64_t i = 0; i < nv; ++i)
    v[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  std::vector<std::array<int, 3>> f(nf);
  for (int64_t i = 0; i < nf; ++i)
    f[i] = {(int)faces[3 * i], (int)faces[3 * i + 1], (int)faces[3 * i + 2]};

  std::vector<Quadric> q(nv);
  std::vector<std::vector<int>> vfaces(nv);
  for (int64_t i = 0; i < nf; ++i) {
    const Vec3 &a = v[f[i][0]], &b = v[f[i][1]], &c = v[f[i][2]];
    Vec3 n = cross3(b - a, c - a);
    double len = std::sqrt(dot3(n, n));
    if (len < 1e-30) continue;
    n = n * (1.0 / len);
    double d = -dot3(n, a);
    for (int j = 0; j < 3; ++j) {
      q[f[i][j]].add_plane(n.x, n.y, n.z, d, len);  // area-weighted
      vfaces[f[i][j]].push_back((int)i);
    }
  }

  std::vector<int> version(nv, 0);
  std::vector<int> parent(nv);
  for (int64_t i = 0; i < nv; ++i) parent[i] = (int)i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) x = parent[x] = parent[parent[x]];
    return x;
  };

  auto edge_candidate = [&](int a, int b) {
    Quadric sum = q[a];
    sum += q[b];
    Collapse col;
    col.u = a;
    col.v = b;
    col.version = version[a] + version[b];
    Vec3 opt;
    Vec3 mid = (v[a] + v[b]) * 0.5;
    double best_cost;
    Vec3 best_pos;
    if (sum.optimal(&opt)) {
      best_cost = sum.eval(opt);
      best_pos = opt;
    } else {
      best_cost = sum.eval(mid);
      best_pos = mid;
    }
    double ca = sum.eval(v[a]), cb = sum.eval(v[b]);
    if (ca < best_cost) { best_cost = ca; best_pos = v[a]; }
    if (cb < best_cost) { best_cost = cb; best_pos = v[b]; }
    col.cost = best_cost;
    col.pos = best_pos;
    return col;
  };

  std::priority_queue<Collapse, std::vector<Collapse>, std::greater<Collapse>> heap;
  std::unordered_set<uint64_t> seen;
  auto push_edges_of = [&](int64_t fi) {
    for (int e = 0; e < 3; ++e) {
      int a = f[fi][e], b = f[fi][(e + 1) % 3];
      if (a > b) std::swap(a, b);
      uint64_t key = ((uint64_t)a << 32) | (uint64_t)b;
      if (seen.insert(key).second) heap.push(edge_candidate(a, b));
    }
  };
  for (int64_t i = 0; i < nf; ++i) push_edges_of(i);

  std::vector<char> face_dead(nf, 0);
  int64_t live_faces = nf;

  while (live_faces > target_faces && !heap.empty()) {
    Collapse c = heap.top();
    heap.pop();
    int a = find(c.u), b = find(c.v);
    if (a == b) continue;
    if (c.version != version[c.u] + version[c.v]) continue;  // stale

    // Link condition: the collapse is manifold-safe iff the common
    // neighbors of a and b are EXACTLY the vertices opposite the faces
    // shared by edge (a,b).  Any extra common neighbor means the edge
    // spans a pinch — collapsing would create non-manifold (4-face)
    // edges or open boundary edges on a closed surface.
    {
      std::unordered_set<int> na, shared_opp;
      bool safe = true;
      for (int fi : vfaces[a]) {
        if (face_dead[fi]) continue;
        int r[3] = {find(f[fi][0]), find(f[fi][1]), find(f[fi][2])};
        bool has_b = (r[0] == b || r[1] == b || r[2] == b);
        for (int j = 0; j < 3; ++j)
          if (r[j] != a && r[j] != b) {
            na.insert(r[j]);
            if (has_b) shared_opp.insert(r[j]);
          }
      }
      size_t common = 0;
      for (int fi : vfaces[b]) {
        if (face_dead[fi]) continue;
        int r[3] = {find(f[fi][0]), find(f[fi][1]), find(f[fi][2])};
        bool has_a = (r[0] == a || r[1] == a || r[2] == a);
        if (has_a) continue;  // shared faces counted via shared_opp
        for (int j = 0; j < 3; ++j)
          if (r[j] != a && r[j] != b && na.count(r[j])) {
            na.erase(r[j]);  // count each common neighbor once
            ++common;
          }
      }
      if (common != shared_opp.size()) safe = false;
      if (!safe) continue;
    }

    // collapse a into b at c.pos
    parent[a] = b;
    v[b] = c.pos;
    q[b] += q[a];
    version[b]++;

    // merge adjacency; kill degenerate faces
    std::vector<int> merged;
    merged.reserve(vfaces[a].size() + vfaces[b].size());
    for (int list_id = 0; list_id < 2; ++list_id) {
      const auto& src = list_id == 0 ? vfaces[a] : vfaces[b];
      for (int fi : src) {
        if (face_dead[fi]) continue;
        int r0 = find(f[fi][0]), r1 = find(f[fi][1]), r2 = find(f[fi][2]);
        if (r0 == r1 || r1 == r2 || r2 == r0) {
          face_dead[fi] = 1;
          --live_faces;
        } else {
          merged.push_back(fi);
        }
      }
    }
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    vfaces[b] = std::move(merged);
    vfaces[a].clear();

    // refresh candidate edges around b
    std::unordered_set<int> nbrs;
    for (int fi : vfaces[b])
      for (int j = 0; j < 3; ++j) {
        int r = find(f[fi][j]);
        if (r != b) nbrs.insert(r);
      }
    for (int nb : nbrs) heap.push(edge_candidate(b, nb));
  }

  // compact output
  std::vector<int> remap(nv, -1);
  std::vector<Vec3> out_v;
  std::vector<std::array<int, 3>> out_f;
  for (int64_t i = 0; i < nf; ++i) {
    if (face_dead[i]) continue;
    std::array<int, 3> tri;
    bool ok = true;
    for (int j = 0; j < 3; ++j) {
      int r = find(f[i][j]);
      if (remap[r] < 0) {
        remap[r] = (int)out_v.size();
        out_v.push_back(v[r]);
      }
      tri[j] = remap[r];
    }
    if (tri[0] == tri[1] || tri[1] == tri[2] || tri[2] == tri[0]) ok = false;
    if (ok) out_f.push_back(tri);
  }

  *out_nv = (int64_t)out_v.size();
  *out_nf = (int64_t)out_f.size();
  *out_verts = (float*)std::malloc(sizeof(float) * 3 * std::max<int64_t>(*out_nv, 1));
  *out_faces = (int64_t*)std::malloc(sizeof(int64_t) * 3 * std::max<int64_t>(*out_nf, 1));
  if (!*out_verts || !*out_faces) return -1;
  for (size_t i = 0; i < out_v.size(); ++i) {
    (*out_verts)[3 * i] = (float)out_v[i].x;
    (*out_verts)[3 * i + 1] = (float)out_v[i].y;
    (*out_verts)[3 * i + 2] = (float)out_v[i].z;
  }
  for (size_t i = 0; i < out_f.size(); ++i)
    for (int j = 0; j < 3; ++j) (*out_faces)[3 * i + j] = out_f[i][j];
  return 0;
}

// Point-in-mesh via 2D bucketing + vertical ray parity (role of the
// reference's libmesh triangle hash, inside_mesh.py:5-8).
int s3d_points_inside(const float* verts, int64_t nv, const int64_t* faces,
                      int64_t nf, const float* points, int64_t np,
                      uint8_t* out_inside) {
  if (nf == 0) {
    std::memset(out_inside, 0, np);
    return 0;
  }
  // bounding box in xy
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int64_t i = 0; i < nv; ++i) {
    minx = std::min(minx, (double)verts[3 * i]);
    maxx = std::max(maxx, (double)verts[3 * i]);
    miny = std::min(miny, (double)verts[3 * i + 1]);
    maxy = std::max(maxy, (double)verts[3 * i + 1]);
  }
  int res = (int)std::ceil(std::sqrt((double)nf));
  res = std::max(res, 1);
  double sx = (maxx - minx) / res + 1e-12, sy = (maxy - miny) / res + 1e-12;
  std::vector<std::vector<int>> buckets((size_t)res * res);
  auto bucket_of = [&](double x, double y) {
    int bx = std::min(std::max((int)((x - minx) / sx), 0), res - 1);
    int by = std::min(std::max((int)((y - miny) / sy), 0), res - 1);
    return by * res + bx;
  };
  for (int64_t i = 0; i < nf; ++i) {
    const float* a = &verts[3 * faces[3 * i]];
    const float* b = &verts[3 * faces[3 * i + 1]];
    const float* c = &verts[3 * faces[3 * i + 2]];
    double txmin = std::min({a[0], b[0], c[0]}), txmax = std::max({a[0], b[0], c[0]});
    double tymin = std::min({a[1], b[1], c[1]}), tymax = std::max({a[1], b[1], c[1]});
    int bx0 = std::min(std::max((int)((txmin - minx) / sx), 0), res - 1);
    int bx1 = std::min(std::max((int)((txmax - minx) / sx), 0), res - 1);
    int by0 = std::min(std::max((int)((tymin - miny) / sy), 0), res - 1);
    int by1 = std::min(std::max((int)((tymax - miny) / sy), 0), res - 1);
    for (int by = by0; by <= by1; ++by)
      for (int bx = bx0; bx <= bx1; ++bx)
        buckets[(size_t)by * res + bx].push_back((int)i);
  }

  // Canonically-anchored edge function: for the UNDIRECTED edge {i, j} the
  // value is computed with the lower vertex index as anchor, so the two
  // triangles sharing the edge see bit-identical magnitudes.  Together with
  // a direction-dependent boundary rule this counts each geometric ray
  // crossing exactly once (no fp double-count on shared edges).
  auto edge_fn = [&](int64_t i, int64_t j, double px, double py,
                     double* val) -> int {
    int sign = 1;
    if (i > j) {
      std::swap(i, j);
      sign = -1;
    }
    const float* vi = &verts[3 * i];
    const float* vj = &verts[3 * j];
    double ex = (double)vj[0] - vi[0], ey = (double)vj[1] - vi[1];
    *val = sign * (ex * (py - vi[1]) - ey * (px - vi[0]));
    return sign;  // +1 when the triangle traverses the canonical direction
  };

  for (int64_t p = 0; p < np; ++p) {
    double px = points[3 * p], py = points[3 * p + 1], pz = points[3 * p + 2];
    if (px < minx || px > maxx || py < miny || py > maxy) {
      out_inside[p] = 0;
      continue;
    }
    int crossings = 0;
    for (int fi : buckets[bucket_of(px, py)]) {
      int64_t i0 = faces[3 * fi], i1 = faces[3 * fi + 1], i2 = faces[3 * fi + 2];
      double e01, e12, e20;
      int s01 = edge_fn(i0, i1, px, py, &e01);
      int s12 = edge_fn(i1, i2, px, py, &e12);
      int s20 = edge_fn(i2, i0, px, py, &e20);
      // orientation of the projected triangle
      const float* a = &verts[3 * i0];
      const float* b = &verts[3 * i1];
      const float* c = &verts[3 * i2];
      double area2 = ((double)b[0] - a[0]) * ((double)c[1] - a[1]) -
                     ((double)b[1] - a[1]) * ((double)c[0] - a[0]);
      if (std::fabs(area2) < 1e-30) continue;
      double o = area2 > 0 ? 1.0 : -1.0;
      double w01 = o * e01, w12 = o * e12, w20 = o * e20;
      if (w01 < 0 || w12 < 0 || w20 < 0) continue;
      // boundary: count only the triangle traversing the canonical edge
      // forward (w.r.t. its orientation) — exactly one of the two sharers
      if (w01 == 0 && o * s01 < 0) continue;
      if (w12 == 0 && o * s12 < 0) continue;
      if (w20 == 0 && o * s20 < 0) continue;
      double wsum = w01 + w12 + w20;
      double z = (w12 * a[2] + w20 * b[2] + w01 * c[2]) / wsum;
      if (z > pz) ++crossings;
    }
    out_inside[p] = (uint8_t)(crossings & 1);
  }
  return 0;
}

// Exact triangle/axis-aligned-cube overlap via the separating axis theorem
// (the role of libvoxelize's tribox2.h test; written from the SAT: 3 box
// face normals, the triangle plane normal, and the 9 edge cross products).
// The box is centered at `c` with half extent 0.5 on each axis; triangle
// vertices are given in the same (voxel) coordinate frame.
static bool tri_cube_overlap(const float c[3], const float* a,
                             const float* b, const float* d) {
  // translate so the cube is centered at the origin
  double v0[3], v1[3], v2[3];
  for (int i = 0; i < 3; ++i) {
    v0[i] = (double)a[i] - c[i];
    v1[i] = (double)b[i] - c[i];
    v2[i] = (double)d[i] - c[i];
  }
  const double h = 0.5;  // cube half size

  // 1) cube face normals (x, y, z): AABB-vs-AABB on each axis
  for (int i = 0; i < 3; ++i) {
    double lo = std::min({v0[i], v1[i], v2[i]});
    double hi = std::max({v0[i], v1[i], v2[i]});
    if (lo > h || hi < -h) return false;
  }

  double e0[3], e1[3], e2[3];  // triangle edges
  for (int i = 0; i < 3; ++i) {
    e0[i] = v1[i] - v0[i];
    e1[i] = v2[i] - v1[i];
    e2[i] = v0[i] - v2[i];
  }

  // 2) triangle plane: distance from cube center to the plane vs the
  // projected cube radius r = sum_i h*|n_i|
  double n[3] = {e0[1] * e1[2] - e0[2] * e1[1],
                 e0[2] * e1[0] - e0[0] * e1[2],
                 e0[0] * e1[1] - e0[1] * e1[0]};
  {
    double r = h * (std::fabs(n[0]) + std::fabs(n[1]) + std::fabs(n[2]));
    double s = n[0] * v0[0] + n[1] * v0[1] + n[2] * v0[2];
    if (std::fabs(s) > r) return false;
  }

  // 3) nine cross-product axes: unit axis u_i x edge e_j.  For u_i = x/y/z
  // the cross product has a zero i-th component, so each projection only
  // involves two coordinates.  Project the three triangle vertices and the
  // cube (radius r) onto the axis; disjoint intervals => separating axis.
  const double* edges[3] = {e0, e1, e2};
  for (int j = 0; j < 3; ++j) {
    const double* e = edges[j];
    for (int i = 0; i < 3; ++i) {
      int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
      // axis = u_i x e = (0-block): components (i1, i2) = (-e[i2], e[i1])
      double ax1 = -e[i2], ax2 = e[i1];
      double p0 = ax1 * v0[i1] + ax2 * v0[i2];
      double p1 = ax1 * v1[i1] + ax2 * v1[i2];
      double p2 = ax1 * v2[i1] + ax2 * v2[i2];
      double lo = std::min({p0, p1, p2});
      double hi = std::max({p0, p1, p2});
      double r = h * (std::fabs(ax1) + std::fabs(ax2));
      if (lo > r || hi < -r) return false;
    }
  }
  return true;
}

// Conservative voxelization: mark every voxel a triangle actually overlaps
// (SAT triangle-cube test per candidate voxel in the triangle's AABB; the
// role of libvoxelize's voxelize_mesh_, reference
// reg_slices/src_convonet/utils/libvoxelize/voxelize.pyx:23-52 + tribox2.h).
// Grid is res^3 over [0, 1]^3 with vertices given in [0, 1] coordinates.
int s3d_voxelize(const float* verts, int64_t nv, const int64_t* faces,
                 int64_t nf, int64_t res, uint8_t* out_occ) {
  std::memset(out_occ, 0, (size_t)res * res * res);
  auto clampi = [&](int x) { return std::min(std::max(x, 0), (int)res - 1); };
  for (int64_t i = 0; i < nf; ++i) {
    const float* a = &verts[3 * faces[3 * i]];
    const float* b = &verts[3 * faces[3 * i + 1]];
    const float* c = &verts[3 * faces[3 * i + 2]];
    // voxel-space triangle (1 voxel = unit cube)
    float ta[3], tb[3], tc[3];
    for (int k = 0; k < 3; ++k) {
      ta[k] = a[k] * res;
      tb[k] = b[k] * res;
      tc[k] = c[k] * res;
    }
    int x0 = clampi((int)std::floor(std::min({ta[0], tb[0], tc[0]})));
    int x1 = clampi((int)std::floor(std::max({ta[0], tb[0], tc[0]})));
    int y0 = clampi((int)std::floor(std::min({ta[1], tb[1], tc[1]})));
    int y1 = clampi((int)std::floor(std::max({ta[1], tb[1], tc[1]})));
    int z0 = clampi((int)std::floor(std::min({ta[2], tb[2], tc[2]})));
    int z1 = clampi((int)std::floor(std::max({ta[2], tb[2], tc[2]})));
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        for (int z = z0; z <= z1; ++z) {
          size_t at = ((size_t)x * res + y) * res + z;
          if (out_occ[at]) continue;
          float center[3] = {x + 0.5f, y + 0.5f, z + 0.5f};
          if (tri_cube_overlap(center, ta, tb, tc)) out_occ[at] = 1;
        }
  }
  return 0;
}

}  // extern "C"
