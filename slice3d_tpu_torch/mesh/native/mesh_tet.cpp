// Marching-tetrahedra isosurface extraction for the port's mesh stage
// (s3d_isosurface; 6-tet Kuhn cube subdivision, watertight, consistent face
// diagonals between neighbouring cells), built into the same library as
// mesh_native.cpp.  The JAX package's extractor line for line, so both give
// the same bits.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// 6-tetrahedra decomposition of the unit cube around the 0-6 diagonal.
// Cube corner numbering: bit0 -> +x, bit1 -> +y, bit2 -> +z
//   0=(0,0,0) 1=(1,0,0) 2=(1,1,0) 3=(0,1,0) 4=(0,0,1) 5=(1,0,1) 6=(1,1,1) 7=(0,1,1)
static const int kTets[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};

static const int kCornerOff[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// Edge "class" of a canonical lattice edge: the componentwise-nonnegative
// offset from its lower corner.  The Kuhn 6-tet subdivision only ever uses
// these 7 directions, so a vertex is addressed directly by
// (lower corner, class) — no hash map.
static inline int edge_class(int dx, int dy, int dz) {
  // (1,0,0)=0 (0,1,0)=1 (0,0,1)=2 (1,1,0)=3 (0,1,1)=4 (1,0,1)=5 (1,1,1)=6
  static const int lut[2][2][2] = {{{-1, 2}, {1, 4}}, {{0, 5}, {3, 6}}};
  return lut[dx][dy][dz];
}

class IsoExtractor {
 public:
  IsoExtractor(const float* grid, int64_t nx, int64_t ny, int64_t nz, float iso)
      : g_(grid), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {
    slab_stride_ = (ny_ + 1) * (nz_ + 1) * 7;
    for (int s = 0; s < 2; ++s) {
      slab_[s].assign(slab_stride_, 0);
      stamp_[s].assign(slab_stride_, 0);
      gen_[s] = 0;  // stamp 0 == invalid; slabs are stamped per x-advance
    }
  }

  inline float val(int64_t x, int64_t y, int64_t z) const {
    return g_[(x * ny_ + y) * nz_ + z];
  }

  // Vertex on the iso-crossing of lattice edge (a -> b), deduplicated via
  // direct addressing into the two rolling x-slabs.
  int edge_vertex(int64_t ax, int64_t ay, int64_t az, float va,
                  int64_t bx, int64_t by, int64_t bz, float vb) {
    if (ax > bx || (ax == bx && (ay > by || (ay == by && az > bz)))) {
      std::swap(ax, bx); std::swap(ay, by); std::swap(az, bz);
      std::swap(va, vb);
    }
    int cls = edge_class(static_cast<int>(bx - ax), static_cast<int>(by - ay),
                         static_cast<int>(bz - az));
    int s = static_cast<int>(ax & 1);
    int64_t off = (ay * (nz_ + 1) + az) * 7 + cls;
    if (stamp_[s][off] == gen_[s]) return slab_[s][off];
    float denom = vb - va;
    float t = (std::fabs(denom) > 1e-30f) ? (iso_ - va) / denom : 0.5f;
    t = std::min(1.0f, std::max(0.0f, t));
    V3 p = {static_cast<float>(ax) + t * (bx - ax),
            static_cast<float>(ay) + t * (by - ay),
            static_cast<float>(az) + t * (bz - az)};
    int idx = static_cast<int>(verts_.size());
    verts_.push_back(p);
    slab_[s][off] = idx;
    stamp_[s][off] = gen_[s];
    return idx;
  }

  void emit_tri(int a, int b, int c, const V3& inward) {
    // Orient so the face normal points away from the inside region.
    V3 n = cross(sub(verts_[b], verts_[a]), sub(verts_[c], verts_[a]));
    if (dot(n, inward) > 0.0f) std::swap(b, c);
    faces_.push_back(a);
    faces_.push_back(b);
    faces_.push_back(c);
  }

  void process_tet(const int64_t cx[8][3], const float cv[8], const int t[4]) {
    int inside[4], nin = 0;
    for (int i = 0; i < 4; ++i) inside[i] = cv[t[i]] > iso_ ? 1 : 0, nin += inside[i];
    if (nin == 0 || nin == 4) return;

    int in_idx[4], out_idx[4];
    int ni = 0, no = 0;
    for (int i = 0; i < 4; ++i) (inside[i] ? in_idx[ni++] = t[i] : out_idx[no++] = t[i]);

    auto ev = [&](int a, int b) {
      return edge_vertex(cx[a][0], cx[a][1], cx[a][2], cv[a],
                         cx[b][0], cx[b][1], cx[b][2], cv[b]);
    };
    // "inward" = direction from the surface toward the inside corners.
    auto centroid_dir = [&](int nin_, int* ins, int nout_, int* outs) {
      V3 ci = {0, 0, 0}, co = {0, 0, 0};
      for (int i = 0; i < nin_; ++i) {
        ci.x += cx[ins[i]][0]; ci.y += cx[ins[i]][1]; ci.z += cx[ins[i]][2];
      }
      for (int i = 0; i < nout_; ++i) {
        co.x += cx[outs[i]][0]; co.y += cx[outs[i]][1]; co.z += cx[outs[i]][2];
      }
      V3 d = {ci.x / nin_ - co.x / nout_, ci.y / nin_ - co.y / nout_, ci.z / nin_ - co.z / nout_};
      return d;
    };
    V3 inward = centroid_dir(ni, in_idx, no, out_idx);

    if (ni == 1) {
      int a = ev(in_idx[0], out_idx[0]);
      int b = ev(in_idx[0], out_idx[1]);
      int c = ev(in_idx[0], out_idx[2]);
      emit_tri(a, b, c, inward);
    } else if (ni == 3) {
      int a = ev(out_idx[0], in_idx[0]);
      int b = ev(out_idx[0], in_idx[1]);
      int c = ev(out_idx[0], in_idx[2]);
      emit_tri(a, b, c, inward);
    } else {  // ni == 2: quad split into two triangles
      int a = ev(in_idx[0], out_idx[0]);
      int b = ev(in_idx[0], out_idx[1]);
      int c = ev(in_idx[1], out_idx[1]);
      int d = ev(in_idx[1], out_idx[0]);
      emit_tri(a, b, c, inward);
      emit_tri(a, c, d, inward);
    }
  }

  void run() {
    const float iso = iso_;
    // Precompute per-lattice-point sign bytes (one vectorizable pass);
    // the cell scan then straddle-tests 8 z-cells at a time with uint64
    // loads instead of re-comparing 8 floats per cell.
    const int64_t npts = nx_ * ny_ * nz_;
    std::vector<uint8_t> sign(static_cast<size_t>(npts) + 8, 0);
    for (int64_t i = 0; i < npts; ++i) sign[i] = g_[i] > iso ? 1 : 0;

    auto load8 = [](const uint8_t* p) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      return w;
    };

    ++gen_[0];  // open the slab for lower-corner x = 0
    for (int64_t x = 0; x + 1 < nx_; ++x) {
      ++gen_[(x + 1) & 1];  // slab for lower-corner x+1: fresh generation
      for (int64_t y = 0; y + 1 < ny_; ++y) {
        const float* col0 = &g_[((x) * ny_ + y) * nz_];
        const float* col1 = &g_[((x) * ny_ + y + 1) * nz_];
        const float* col2 = &g_[((x + 1) * ny_ + y) * nz_];
        const float* col3 = &g_[((x + 1) * ny_ + y + 1) * nz_];
        const uint8_t* s0 = &sign[((x) * ny_ + y) * nz_];
        const uint8_t* s1 = &sign[((x) * ny_ + y + 1) * nz_];
        const uint8_t* s2 = &sign[((x + 1) * ny_ + y) * nz_];
        const uint8_t* s3 = &sign[((x + 1) * ny_ + y + 1) * nz_];
        for (int64_t z0 = 0; z0 + 1 < nz_; z0 += 8) {
          // straddle byte != 0 iff the cell's 8 corners disagree
          uint64_t w_or = load8(s0 + z0) | load8(s0 + z0 + 1) |
                          load8(s1 + z0) | load8(s1 + z0 + 1) |
                          load8(s2 + z0) | load8(s2 + z0 + 1) |
                          load8(s3 + z0) | load8(s3 + z0 + 1);
          uint64_t w_and = load8(s0 + z0) & load8(s0 + z0 + 1) &
                           load8(s1 + z0) & load8(s1 + z0 + 1) &
                           load8(s2 + z0) & load8(s2 + z0 + 1) &
                           load8(s3 + z0) & load8(s3 + z0 + 1);
          uint64_t diff = w_or ^ w_and;
          if (!diff) continue;
          int64_t zmax = std::min<int64_t>(8, nz_ - 1 - z0);
          for (int64_t dz = 0; dz < zmax; ++dz) {
            if (!((diff >> (8 * dz)) & 0xffu)) continue;
            const int64_t z = z0 + dz;
            float v000 = col0[z], v001 = col0[z + 1];
            float v010 = col1[z], v011 = col1[z + 1];
            float v100 = col2[z], v101 = col2[z + 1];
            float v110 = col3[z], v111 = col3[z + 1];
            int64_t cx[8][3];
            float cv[8];
            const float vals[8] = {v000, v100, v110, v010, v001, v101, v111, v011};
            for (int c = 0; c < 8; ++c) {
              cx[c][0] = x + kCornerOff[c][0];
              cx[c][1] = y + kCornerOff[c][1];
              cx[c][2] = z + kCornerOff[c][2];
              cv[c] = vals[c];
            }
            for (int t = 0; t < 6; ++t) process_tet(cx, cv, kTets[t]);
          }
        }
      }
    }
  }

  const float* g_;
  int64_t nx_, ny_, nz_;
  float iso_;
  std::vector<V3> verts_;
  std::vector<int64_t> faces_;
  // direct-addressed edge->vertex dedup: two rolling x-slabs of
  // (ny+1)*(nz+1)*7 slots, validity tracked by generation stamps
  int64_t slab_stride_;
  std::vector<int32_t> slab_[2];
  std::vector<uint32_t> stamp_[2];
  uint32_t gen_[2];
};

}  // namespace

extern "C" {

// grid: C-order (nx, ny, nz) float32. Vertices are returned in lattice
// coordinates ([0, n-1] per axis). Returns 0 on success.
int s3d_isosurface(const float* grid, int64_t nx, int64_t ny, int64_t nz,
                   float iso, float** out_verts, int64_t* out_nv,
                   int64_t** out_faces, int64_t* out_nf) {
  IsoExtractor ex(grid, nx, ny, nz, iso);
  ex.run();
  int64_t nv = static_cast<int64_t>(ex.verts_.size());
  int64_t nf = static_cast<int64_t>(ex.faces_.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(sizeof(float) * 3 * std::max<int64_t>(nv, 1)));
  *out_faces = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * 3 * std::max<int64_t>(nf, 1)));
  if (!*out_verts || !*out_faces) return -1;
  if (nv) std::memcpy(*out_verts, ex.verts_.data(), sizeof(float) * 3 * nv);
  if (nf) std::memcpy(*out_faces, ex.faces_.data(), sizeof(int64_t) * 3 * nf);
  *out_nv = nv;
  *out_nf = nf;
  return 0;
}

}  // extern "C"
