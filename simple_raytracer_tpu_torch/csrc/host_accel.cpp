// host_accel: the port's host library, compiled with the host compiler.
//
// Three scene-build steps that run on the host, once per scene edit and
// never per ray:
//   * srt_bvh_build: a binned-SAH BVH over world-space triangles (16
//     centroid bins on each axis; a median split where SAH prefers a
//     leaf of more than 4 * leaf_size triangles; a leaf below depth 60),
//     flattened to DFS preorder with skip links, leaf ranges contiguous
//     in the returned triangle order;
//   * srt_transform_triangles: positions and normals by a 4x4 row-major
//     matrix, with the world AABB;
//   * srt_stl_count / srt_stl_parse: binary STL records, a truncated file
//     clamped to its whole records.
//
// The C interface and the algorithm are those of the JAX package's
// native library (native/srt_native.cpp), so both packages cut a mesh
// into the same clusters.  That library is built with -march=native,
// under which GCC contracts each `a * b + c` of its C++ into one fused
// multiply-add; here every such contraction is written out as std::fma
// and the library is built with -ffp-contract=off, so its results are
// those bits on any host, with or without FMA hardware.
//
// Built by ops/cuda/build.py (HostLibrary) and bound in accel.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int axis) const {
    return axis == 0 ? x : axis == 1 ? y : z;
  }
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const AABB &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float area() const {
    float dx = std::max(0.0f, hi.x - lo.x);
    float dy = std::max(0.0f, hi.y - lo.y);
    float dz = std::max(0.0f, hi.z - lo.z);
    // 2 * (dx*dy + dy*dz + dz*dx), contracted
    return 2.0f * std::fma(dz, dx, std::fma(dx, dy, dy * dz));
  }
};

struct BuildPrim {
  AABB box;
  V3 centroid;
  int32_t index;  // the triangle's index in the input
};

struct BuildNode {
  AABB box;
  int32_t left = -1, right = -1;  // children, build-time indices
  int32_t first = -1, count = 0;  // a leaf's range of the triangle order
};

constexpr int kBins = 16;

inline int bin_of(float c, float lo, float scale) {
  return std::min(kBins - 1, std::max(0, (int)((c - lo) * scale)));
}

struct Builder {
  std::vector<BuildPrim> prims;
  std::vector<BuildNode> nodes;
  int leaf_size;

  int make_leaf(int node_id, int begin, int n) {
    nodes[node_id].first = begin;
    nodes[node_id].count = n;
    return node_id;
  }

  int build(int begin, int end, int depth) {
    BuildNode node;
    for (int i = begin; i < end; i++) node.box.grow(prims[i].box);
    int n = end - begin;
    int node_id = (int)nodes.size();
    nodes.push_back(node);
    if (n <= leaf_size || depth > 60) return make_leaf(node_id, begin, n);

    // binned SAH over the centroids' extent, each axis
    AABB cbox;
    for (int i = begin; i < end; i++) cbox.grow(prims[i].centroid);
    float best_cost = 1e30f;
    int best_axis = -1, best_split = -1;
    for (int axis = 0; axis < 3; axis++) {
      float lo = cbox.lo[axis], hi = cbox.hi[axis];
      if (hi - lo < 1e-12f) continue;
      float scale = kBins / (hi - lo);
      AABB bins[kBins];
      int counts[kBins] = {0};
      for (int i = begin; i < end; i++) {
        int b = bin_of(prims[i].centroid[axis], lo, scale);
        bins[b].grow(prims[i].box);
        counts[b]++;
      }
      AABB right_acc[kBins];
      AABB acc;
      for (int b = kBins - 1; b > 0; b--) {
        acc.grow(bins[b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int left_count = 0;
      for (int b = 0; b < kBins - 1; b++) {
        left_acc.grow(bins[b]);
        left_count += counts[b];
        int right_count = n - left_count;
        if (left_count == 0 || right_count == 0) continue;
        // left area * left count + right area * right count, contracted
        float la = left_acc.area(), ra = right_acc[b + 1].area();
        float lc = (float)left_count, rc = (float)right_count;
        float cost = std::fma(ra, rc, la * lc);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = b;
        }
      }
    }

    int mid;
    if (best_axis < 0 || best_cost >= nodes[node_id].box.area() * n) {
      // SAH prefers a leaf (or found no split): keep a small one, split
      // a large one at the median of its longest centroid axis
      if (n <= 4 * leaf_size) return make_leaf(node_id, begin, n);
      V3 ext(cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
             cbox.hi.z - cbox.lo.z);
      int axis = 0;
      if (ext.y > ext.x) axis = 1;
      if (ext.z > (axis == 0 ? ext.x : ext.y)) axis = 2;
      mid = begin + n / 2;
      std::nth_element(prims.begin() + begin, prims.begin() + mid,
                       prims.begin() + end,
                       [axis](const BuildPrim &a, const BuildPrim &b) {
                         return a.centroid[axis] < b.centroid[axis];
                       });
    } else {
      float lo = cbox.lo[best_axis], hi = cbox.hi[best_axis];
      float scale = kBins / (hi - lo);
      auto part = std::partition(
          prims.begin() + begin, prims.begin() + end,
          [&](const BuildPrim &p) {
            return bin_of(p.centroid[best_axis], lo, scale) <= best_split;
          });
      mid = (int)(part - prims.begin());
      if (mid == begin || mid == end) mid = begin + n / 2;
    }

    int l = build(begin, mid, depth + 1);
    int r = build(mid, end, depth + 1);
    nodes[node_id].left = l;
    nodes[node_id].right = r;
    return node_id;
  }
};

}  // namespace

extern "C" {

// A BVH over `n` triangles given as (n, 3, 3) f32 vertex positions.  The
// caller allocates the outputs, 2 * n + 1 nodes at most:
//   nodes_out: (num_nodes, 8) f32 [min.xyz, max.xyz, 0, 0]
//   meta_out:  (num_nodes, 4) i32 [skip, first, count, is_leaf]
//   order_out: (n,) i32, the triangle order (leaf ranges contiguous)
// Returns the number of nodes (node i's DFS index is i).
int32_t srt_bvh_build(const float *tris, int32_t n, int32_t leaf_size,
                      float *nodes_out, int32_t *meta_out,
                      int32_t *order_out) {
  if (n <= 0) return 0;
  Builder b;
  b.leaf_size = leaf_size < 1 ? 4 : leaf_size;
  b.prims.resize(n);
  for (int i = 0; i < n; i++) {
    const float *t = tris + (size_t)i * 9;
    AABB box;
    box.grow(V3(t[0], t[1], t[2]));
    box.grow(V3(t[3], t[4], t[5]));
    box.grow(V3(t[6], t[7], t[8]));
    b.prims[i].box = box;
    b.prims[i].centroid =
        V3((box.lo.x + box.hi.x) * 0.5f, (box.lo.y + box.hi.y) * 0.5f,
           (box.lo.z + box.hi.z) * 0.5f);
    b.prims[i].index = i;
  }
  b.nodes.reserve((size_t)2 * n);
  b.build(0, n, 0);

  // build() pushes a parent before its children, so the build order is
  // DFS preorder; a left child skips to its sibling, a right child to its
  // parent's skip, the root to the end
  int num = (int)b.nodes.size();
  std::vector<int32_t> skip(num, num);
  for (int i = 0; i < num; i++) {
    const BuildNode &nd = b.nodes[i];
    if (nd.left >= 0) {
      skip[nd.left] = nd.right;
      skip[nd.right] = skip[i];
    }
  }
  for (int i = 0; i < num; i++) {
    const BuildNode &nd = b.nodes[i];
    float *out = nodes_out + (size_t)i * 8;
    out[0] = nd.box.lo.x;
    out[1] = nd.box.lo.y;
    out[2] = nd.box.lo.z;
    out[3] = nd.box.hi.x;
    out[4] = nd.box.hi.y;
    out[5] = nd.box.hi.z;
    out[6] = 0.0f;
    out[7] = 0.0f;
    int32_t *m = meta_out + (size_t)i * 4;
    m[0] = skip[i];
    m[1] = nd.count > 0 ? nd.first : -1;
    m[2] = nd.count;
    m[3] = nd.count > 0 ? 1 : 0;
  }
  for (int i = 0; i < n; i++) order_out[i] = b.prims[i].index;
  return num;
}

// (n, 3, 3) f32 positions and normals by a 4x4 row-major matrix
// (positions: affine; normals: its linear part), and the world AABB of
// the positions (aabb_out: min.xyz, max.xyz).  In and out may alias.
void srt_transform_triangles(const float *pos_in, const float *nrm_in,
                             const float *mat4, int32_t n, float *pos_out,
                             float *nrm_out, float *aabb_out) {
  const float *m = mat4;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < (int64_t)n * 3; i++) {
    const float *p = pos_in + i * 3;
    const float *q = nrm_in + i * 3;
    float w[3], v[3];
    for (int r = 0; r < 3; r++) {
      const float *row = m + 4 * r;
      // row . p + row[3] and row . q, contracted
      w[r] = std::fma(row[2], p[2], std::fma(row[0], p[0], row[1] * p[1])) +
             row[3];
      v[r] = std::fma(row[2], q[2], std::fma(row[0], q[0], row[1] * q[1]));
    }
    for (int k = 0; k < 3; k++) {
      pos_out[i * 3 + k] = w[k];
      nrm_out[i * 3 + k] = v[k];
      lo[k] = std::min(lo[k], w[k]);
      hi[k] = std::max(hi[k], w[k]);
    }
  }
  for (int k = 0; k < 3; k++) {
    aabb_out[k] = lo[k];
    aabb_out[3 + k] = hi[k];
  }
}

// Binary STL (80-byte header, u32 count, 50-byte records {normal f32x3,
// 3 vertices f32x3, u16 attribute}).  The count of whole records the
// buffer holds: the header's, or fewer for a truncated file; -1 if the
// buffer is shorter than its header.
int32_t srt_stl_count(const uint8_t *buf, int64_t len) {
  if (len < 84) return -1;
  uint32_t count;
  std::memcpy(&count, buf + 80, 4);
  if ((int64_t)84 + (int64_t)count * 50 > len)
    count = (uint32_t)((len - 84) / 50);
  return (int32_t)count;
}

// Writes srt_stl_count(buf, len) triangles, count * 9 floats each into
// pos_out and nrm_out (the file normal copied to all three vertices).
int32_t srt_stl_parse(const uint8_t *buf, int64_t len, float *pos_out,
                      float *nrm_out) {
  int32_t count = srt_stl_count(buf, len);
  if (count < 0) return -1;
  for (int32_t i = 0; i < count; i++) {
    const uint8_t *rec = buf + 84 + (int64_t)i * 50;
    float v[12];
    std::memcpy(v, rec, 48);
    for (int k = 0; k < 3; k++) {
      for (int c = 0; c < 3; c++) {
        nrm_out[(int64_t)i * 9 + k * 3 + c] = v[c];
        pos_out[(int64_t)i * 9 + k * 3 + c] = v[3 + k * 3 + c];
      }
    }
  }
  return count;
}

}  // extern "C"
