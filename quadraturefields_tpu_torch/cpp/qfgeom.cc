// qfgeom: host-side geometry kernels for the TPU quadrature-fields
// pipeline. Replaces the reference's native dependencies (SURVEY §2.3):
//   * Embree / OptiX multi-hit ray casting (reference
//     examples/mesh_utils.py:75-109,216-231)  -> BVH ray caster with
//     vertex refit for the deformed-mesh finetune loop;
//   * skimage marching_cubes (marching_cubes.py:64-74) -> marching
//     tetrahedra isosurface extraction (same capability; 6-tet cube
//     decomposition instead of the Lewiner case table);
//   * open3d simplify_vertex_clustering (downsample_mesh.py:13) ->
//     voxel vertex-clustering decimator;
//   * ScanNet Segmentator (run_*_baking.sh:10) -> Felzenszwalb-style
//     graph segmentation over the face adjacency with normal weights.
//
// Exposed via a plain C API (ctypes-friendly). Multithreaded where it
// matters (ray casting); everything is deterministic.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return V3{x, y, z}; }
static inline V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
static inline V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
static inline V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
static inline V3 vmin(V3 a, V3 b) {
  return v3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline V3 vmax(V3 a, V3 b) {
  return v3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

// ---------------------------------------------------------------- BVH
struct BVHNode {
  V3 bmin, bmax;
  int32_t left;   // child index or first primitive
  int32_t count;  // 0 for inner nodes, >0 for leaves
};

struct BVH {
  std::vector<float> vertices;  // 3 * n_verts
  std::vector<int32_t> faces;   // 3 * n_faces
  std::vector<BVHNode> nodes;
  std::vector<int32_t> prim;    // permuted triangle ids
  std::vector<float> uvfc;      // optional per-face-corner UVs, 6/face
  int64_t n_verts = 0, n_faces = 0;

  V3 vert(int32_t i) const {
    return v3(vertices[3 * i], vertices[3 * i + 1], vertices[3 * i + 2]);
  }
  void tri(int32_t f, V3& a, V3& b, V3& c) const {
    a = vert(faces[3 * f]);
    b = vert(faces[3 * f + 1]);
    c = vert(faces[3 * f + 2]);
  }
};

static void bvh_build_range(BVH& bvh, std::vector<V3>& centroids,
                            int32_t node_idx, int32_t begin, int32_t end) {
  BVHNode& node = bvh.nodes[node_idx];
  V3 bmin = v3(1e30f, 1e30f, 1e30f), bmax = v3(-1e30f, -1e30f, -1e30f);
  V3 cmin = bmin, cmax = bmax;
  for (int32_t i = begin; i < end; ++i) {
    V3 a, b, c;
    bvh.tri(bvh.prim[i], a, b, c);
    bmin = vmin(bmin, vmin(a, vmin(b, c)));
    bmax = vmax(bmax, vmax(a, vmax(b, c)));
    cmin = vmin(cmin, centroids[bvh.prim[i]]);
    cmax = vmax(cmax, centroids[bvh.prim[i]]);
  }
  node.bmin = bmin;
  node.bmax = bmax;
  int32_t n = end - begin;
  if (n <= 4) {
    node.left = begin;
    node.count = n;
    return;
  }
  V3 ext = cmax - cmin;
  int axis = 0;
  if (ext.y > ext.x) axis = 1;
  if (ext.z > (axis == 0 ? ext.x : ext.y)) axis = 2;
  float mid = 0.5f * ((axis == 0 ? cmin.x + cmax.x
                                 : axis == 1 ? cmin.y + cmax.y
                                             : cmin.z + cmax.z));
  auto key = [&](int32_t p) {
    V3 c = centroids[p];
    return axis == 0 ? c.x : axis == 1 ? c.y : c.z;
  };
  int32_t* first = bvh.prim.data() + begin;
  int32_t* last = bvh.prim.data() + end;
  int32_t* split =
      std::partition(first, last, [&](int32_t p) { return key(p) < mid; });
  int32_t m = (int32_t)(split - bvh.prim.data());
  if (m == begin || m == end) m = begin + n / 2;  // fallback: median
  if (m == begin + n / 2) {
    std::nth_element(first, bvh.prim.data() + m, last,
                     [&](int32_t a, int32_t b) { return key(a) < key(b); });
  }
  int32_t li = (int32_t)bvh.nodes.size();
  bvh.nodes.push_back({});
  bvh.nodes.push_back({});
  bvh.nodes[node_idx].left = li;
  bvh.nodes[node_idx].count = 0;
  bvh_build_range(bvh, centroids, li, begin, m);
  bvh_build_range(bvh, centroids, li + 1, m, end);
}

static void bvh_refit_node(BVH& bvh, int32_t node_idx) {
  BVHNode& node = bvh.nodes[node_idx];
  if (node.count > 0) {
    V3 bmin = v3(1e30f, 1e30f, 1e30f), bmax = v3(-1e30f, -1e30f, -1e30f);
    for (int32_t i = node.left; i < node.left + node.count; ++i) {
      V3 a, b, c;
      bvh.tri(bvh.prim[i], a, b, c);
      bmin = vmin(bmin, vmin(a, vmin(b, c)));
      bmax = vmax(bmax, vmax(a, vmax(b, c)));
    }
    node.bmin = bmin;
    node.bmax = bmax;
    return;
  }
  bvh_refit_node(bvh, node.left);
  bvh_refit_node(bvh, node.left + 1);
  node.bmin = vmin(bvh.nodes[node.left].bmin, bvh.nodes[node.left + 1].bmin);
  node.bmax = vmax(bvh.nodes[node.left].bmax, bvh.nodes[node.left + 1].bmax);
}

struct Hit {
  float t;
  int32_t tri;
  float u, v;  // barycentric (b, c weights) from Möller–Trumbore
};

// Möller–Trumbore, two-sided, epsilon-guarded.
static inline bool ray_tri(V3 o, V3 d, V3 a, V3 b, V3 c, float& t_out,
                           float& u_out, float& v_out) {
  const float eps = 1e-9f;
  V3 e1 = b - a, e2 = c - a;
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  if (std::fabs(det) < eps) return false;
  float inv = 1.0f / det;
  V3 s = o - a;
  float u = dot(s, p) * inv;
  if (u < -1e-6f || u > 1.0f + 1e-6f) return false;
  V3 q = cross(s, e1);
  float v = dot(d, q) * inv;
  if (v < -1e-6f || u + v > 1.0f + 1e-6f) return false;
  float t = dot(e2, q) * inv;
  if (t <= 1e-6f) return false;
  t_out = t;
  u_out = u;
  v_out = v;
  return true;
}

static inline bool ray_box(V3 o, V3 inv_d, V3 bmin, V3 bmax, float t_max) {
  float tx1 = (bmin.x - o.x) * inv_d.x, tx2 = (bmax.x - o.x) * inv_d.x;
  float tmin = std::min(tx1, tx2), tmax = std::max(tx1, tx2);
  float ty1 = (bmin.y - o.y) * inv_d.y, ty2 = (bmax.y - o.y) * inv_d.y;
  tmin = std::max(tmin, std::min(ty1, ty2));
  tmax = std::min(tmax, std::max(ty1, ty2));
  float tz1 = (bmin.z - o.z) * inv_d.z, tz2 = (bmax.z - o.z) * inv_d.z;
  tmin = std::max(tmin, std::min(tz1, tz2));
  tmax = std::min(tmax, std::max(tz1, tz2));
  return tmax >= std::max(tmin, 0.0f) && tmin <= t_max;
}

static void bvh_intersect_ray(const BVH& bvh, V3 o, V3 d, int max_hits,
                              std::vector<Hit>& hits) {
  hits.clear();
  V3 inv_d = v3(1.0f / (std::fabs(d.x) < 1e-12f ? 1e-12f : d.x),
                1.0f / (std::fabs(d.y) < 1e-12f ? 1e-12f : d.y),
                1.0f / (std::fabs(d.z) < 1e-12f ? 1e-12f : d.z));
  int32_t stack[128];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const BVHNode& node = bvh.nodes[stack[--sp]];
    if (!ray_box(o, inv_d, node.bmin, node.bmax, 1e30f)) continue;
    if (node.count > 0) {
      for (int32_t i = node.left; i < node.left + node.count; ++i) {
        int32_t f = bvh.prim[i];
        V3 a, b, c;
        bvh.tri(f, a, b, c);
        float t;
        float hu, hv;
        if (ray_tri(o, d, a, b, c, t, hu, hv))
          hits.push_back({t, f, hu, hv});
      }
    } else {
      if (sp + 2 <= 128) {
        stack[sp++] = node.left;
        stack[sp++] = node.left + 1;
      }
    }
  }
  std::sort(hits.begin(), hits.end(),
            [](const Hit& a, const Hit& b) { return a.t < b.t; });
  // drop duplicate hits at shared edges/vertices (same t within eps)
  std::vector<Hit> dedup;
  dedup.reserve(hits.size());
  for (const Hit& h : hits) {
    // relative epsilon: hits through a shared vertex/edge land at the
    // same point with float noise proportional to t
    if (!dedup.empty() &&
        h.t - dedup.back().t < std::max(1e-7f, 1e-5f * h.t))
      continue;
    dedup.push_back(h);
    if ((int)dedup.size() >= max_hits) break;
  }
  hits.swap(dedup);
}

// ----------------------------------------------- marching tetrahedra
struct MeshOut {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

// 6-tetrahedra decomposition of the unit cube (corner ids 0..7 with
// bit order x=1, y=2, z=4); all share the main diagonal 0-7.
static const int kTets[6][4] = {{0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
                                {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7}};

struct EdgeKey {
  int64_t a, b;
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    return std::hash<int64_t>()(k.a * 1000003 + k.b);
  }
};

class MarchingTets {
 public:
  MeshOut run(const float* grid, int nx, int ny, int nz, float level,
              const float* origin, const float* spacing) {
    MeshOut out;
    std::unordered_map<EdgeKey, int32_t, EdgeKeyHash> edge_verts;
    auto gid = [&](int x, int y, int z) -> int64_t {
      return ((int64_t)x * ny + y) * nz + z;
    };
    auto gval = [&](int64_t id) { return grid[id]; };
    auto vpos = [&](int64_t id) {
      int z = (int)(id % nz);
      int y = (int)((id / nz) % ny);
      int x = (int)(id / ((int64_t)ny * nz));
      return v3(origin[0] + spacing[0] * x, origin[1] + spacing[1] * y,
                origin[2] + spacing[2] * z);
    };
    auto edge_vertex = [&](int64_t i, int64_t j) -> int32_t {
      if (i > j) std::swap(i, j);
      EdgeKey key{i, j};
      auto it = edge_verts.find(key);
      if (it != edge_verts.end()) return it->second;
      float fi = gval(i), fj = gval(j);
      float t = (level - fi) / (fj - fi);
      t = std::min(1.0f, std::max(0.0f, t));
      V3 p = vpos(i) + (vpos(j) - vpos(i)) * t;
      int32_t vid = (int32_t)(out.verts.size() / 3);
      out.verts.push_back(p.x);
      out.verts.push_back(p.y);
      out.verts.push_back(p.z);
      edge_verts.emplace(key, vid);
      return vid;
    };
    // Orient every triangle so its normal points AWAY from the tet's
    // inside (field > level) corners. The case tables alone cannot fix
    // winding: the 6-tet cube decomposition alternates handedness, so
    // topological orderings emit ~random orientations (measured 56/44
    // outward/inward on a sphere), which scrambles every normal-based
    // consumer (UV fold-splitting, prune visibility cones).
    auto vert_at = [&](int32_t i) {
      return v3(out.verts[3 * i], out.verts[3 * i + 1],
                out.verts[3 * i + 2]);
    };
    auto emit_tri = [&](int32_t a, int32_t b, int32_t c, V3 inside_pt) {
      if (a == b || b == c || a == c) return;
      V3 pa = vert_at(a), pb = vert_at(b), pc = vert_at(c);
      V3 n = cross(pb - pa, pc - pa);
      V3 cen = (pa + pb + pc) * (1.0f / 3.0f);
      if (dot(n, cen - inside_pt) < 0.0f) std::swap(b, c);
      out.faces.push_back(a);
      out.faces.push_back(b);
      out.faces.push_back(c);
    };

    int64_t corner_ids[8];
    for (int x = 0; x + 1 < nx; ++x) {
      for (int y = 0; y + 1 < ny; ++y) {
        for (int z = 0; z + 1 < nz; ++z) {
          for (int c = 0; c < 8; ++c) {
            corner_ids[c] = gid(x + (c & 1), y + ((c >> 1) & 1),
                                z + ((c >> 2) & 1));
          }
          // quick reject
          bool any_in = false, any_out = false;
          for (int c = 0; c < 8; ++c) {
            (gval(corner_ids[c]) > level ? any_in : any_out) = true;
          }
          if (!any_in || !any_out) continue;
          for (int t = 0; t < 6; ++t) {
            int64_t tid[4];
            float tv[4];
            int mask = 0;
            for (int c = 0; c < 4; ++c) {
              tid[c] = corner_ids[kTets[t][c]];
              tv[c] = gval(tid[c]);
              if (tv[c] > level) mask |= (1 << c);
            }
            if (mask == 0 || mask == 15) continue;
            // canonicalize: ensure the "inside" set is the minority or
            // handle each of the 14 cases by popcount
            int inside[4], outside[4];
            int ni = 0, no = 0;
            for (int c = 0; c < 4; ++c) {
              if (mask & (1 << c)) inside[ni++] = c;
              else outside[no++] = c;
            }
            V3 inside_pt = v3(0.0f, 0.0f, 0.0f);
            for (int c = 0; c < ni; ++c)
              inside_pt = inside_pt + vpos(tid[inside[c]]);
            inside_pt = inside_pt * (1.0f / (float)ni);
            if (ni == 1) {
              int32_t a = edge_vertex(tid[inside[0]], tid[outside[0]]);
              int32_t b = edge_vertex(tid[inside[0]], tid[outside[1]]);
              int32_t c = edge_vertex(tid[inside[0]], tid[outside[2]]);
              emit_tri(a, b, c, inside_pt);
            } else if (ni == 3) {
              int32_t a = edge_vertex(tid[outside[0]], tid[inside[0]]);
              int32_t b = edge_vertex(tid[outside[0]], tid[inside[1]]);
              int32_t c = edge_vertex(tid[outside[0]], tid[inside[2]]);
              emit_tri(a, c, b, inside_pt);
            } else {  // ni == 2: quad -> two triangles
              int32_t a = edge_vertex(tid[inside[0]], tid[outside[0]]);
              int32_t b = edge_vertex(tid[inside[0]], tid[outside[1]]);
              int32_t c = edge_vertex(tid[inside[1]], tid[outside[1]]);
              int32_t d = edge_vertex(tid[inside[1]], tid[outside[0]]);
              emit_tri(a, b, c, inside_pt);
              emit_tri(a, c, d, inside_pt);
            }
          }
        }
      }
    }
    return out;
  }
};

// ------------------------------------------- vertex-cluster decimate
static MeshOut decimate_cluster(const float* verts, int64_t nv,
                                const int32_t* faces, int64_t nf,
                                float voxel) {
  MeshOut out;
  std::unordered_map<int64_t, int32_t> cell_to_new;
  std::vector<int32_t> remap(nv);
  std::vector<V3> acc;
  std::vector<int32_t> cnt;
  float bx = 1e30f, by = 1e30f, bz = 1e30f;
  for (int64_t i = 0; i < nv; ++i) {
    bx = std::min(bx, verts[3 * i]);
    by = std::min(by, verts[3 * i + 1]);
    bz = std::min(bz, verts[3 * i + 2]);
  }
  for (int64_t i = 0; i < nv; ++i) {
    int64_t cx = (int64_t)((verts[3 * i] - bx) / voxel);
    int64_t cy = (int64_t)((verts[3 * i + 1] - by) / voxel);
    int64_t cz = (int64_t)((verts[3 * i + 2] - bz) / voxel);
    int64_t key = (cx * 73856093LL) ^ (cy * 19349663LL) ^ (cz * 83492791LL);
    auto it = cell_to_new.find(key);
    int32_t id;
    if (it == cell_to_new.end()) {
      id = (int32_t)acc.size();
      cell_to_new.emplace(key, id);
      acc.push_back(v3(0, 0, 0));
      cnt.push_back(0);
    } else {
      id = it->second;
    }
    acc[id] = acc[id] + v3(verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
    cnt[id]++;
    remap[i] = id;
  }
  out.verts.resize(acc.size() * 3);
  for (size_t i = 0; i < acc.size(); ++i) {
    out.verts[3 * i] = acc[i].x / cnt[i];
    out.verts[3 * i + 1] = acc[i].y / cnt[i];
    out.verts[3 * i + 2] = acc[i].z / cnt[i];
  }
  for (int64_t f = 0; f < nf; ++f) {
    int32_t a = remap[faces[3 * f]];
    int32_t b = remap[faces[3 * f + 1]];
    int32_t c = remap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    out.faces.push_back(a);
    out.faces.push_back(b);
    out.faces.push_back(c);
  }
  return out;
}

// --------------------------------------- Felzenszwalb mesh segmenter
struct DSU {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  std::vector<float> thr;
  DSU(int32_t n, float k) : parent(n), size(n, 1), thr(n, k) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
};

static void segment_mesh(const float* verts, int64_t nv,
                         const int32_t* faces, int64_t nf, float kthr,
                         int min_size, int32_t* seg_out) {
  // face normals & centroids
  std::vector<V3> normals(nf), centroids(nf);
  for (int64_t f = 0; f < nf; ++f) {
    V3 a = v3(verts[3 * faces[3 * f]], verts[3 * faces[3 * f] + 1],
              verts[3 * faces[3 * f] + 2]);
    V3 b = v3(verts[3 * faces[3 * f + 1]], verts[3 * faces[3 * f + 1] + 1],
              verts[3 * faces[3 * f + 1] + 2]);
    V3 c = v3(verts[3 * faces[3 * f + 2]], verts[3 * faces[3 * f + 2] + 1],
              verts[3 * faces[3 * f + 2] + 2]);
    V3 n = cross(b - a, c - a);
    float len = std::sqrt(dot(n, n));
    normals[f] = len > 1e-20f ? n * (1.0f / len) : v3(0, 0, 1);
    centroids[f] = (a + b + c) * (1.0f / 3.0f);
  }
  // adjacency via shared edges
  struct Edge {
    float w;
    int32_t a, b;
  };
  std::unordered_map<int64_t, int32_t> edge_to_face;
  std::vector<Edge> edges;
  auto ekey = [&](int32_t u, int32_t v) {
    if (u > v) std::swap(u, v);
    return (int64_t)u * 0x100000000LL + v;
  };
  for (int64_t f = 0; f < nf; ++f) {
    for (int e = 0; e < 3; ++e) {
      int32_t u = faces[3 * f + e];
      int32_t v = faces[3 * f + (e + 1) % 3];
      int64_t key = ekey(u, v);
      auto it = edge_to_face.find(key);
      if (it == edge_to_face.end()) {
        edge_to_face.emplace(key, (int32_t)f);
      } else {
        int32_t g = it->second;
        // normal-difference weight; convex transitions discounted
        // (ScanNet segmentator's behavior)
        float w = 1.0f - dot(normals[f], normals[g]);
        V3 dcent = centroids[g] - centroids[f];
        if (dot(normals[f], dcent) < 0) w = w * w;  // convex
        edges.push_back({w, (int32_t)f, g});
      }
    }
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });
  DSU dsu((int32_t)nf, kthr);
  for (const Edge& e : edges) {
    int32_t ra = dsu.find(e.a), rb = dsu.find(e.b);
    if (ra == rb) continue;
    if (e.w <= dsu.thr[ra] && e.w <= dsu.thr[rb]) {
      dsu.parent[ra] = rb;
      dsu.size[rb] += dsu.size[ra];
      dsu.thr[rb] = e.w + kthr / dsu.size[rb];
    }
  }
  // enforce min segment size
  for (const Edge& e : edges) {
    int32_t ra = dsu.find(e.a), rb = dsu.find(e.b);
    if (ra == rb) continue;
    if (dsu.size[ra] < min_size || dsu.size[rb] < min_size) {
      dsu.parent[ra] = rb;
      dsu.size[rb] += dsu.size[ra];
    }
  }
  // compact labels
  std::unordered_map<int32_t, int32_t> label;
  for (int64_t f = 0; f < nf; ++f) {
    int32_t r = dsu.find((int32_t)f);
    auto it = label.find(r);
    if (it == label.end()) {
      int32_t l = (int32_t)label.size();
      label.emplace(r, l);
      seg_out[f] = l;
    } else {
      seg_out[f] = it->second;
    }
  }
}

}  // namespace

// ----------------------------------------------------------- C API
extern "C" {

void* qf_bvh_create(const float* vertices, int64_t n_verts,
                    const int32_t* faces, int64_t n_faces) {
  BVH* bvh = new BVH();
  bvh->n_verts = n_verts;
  bvh->n_faces = n_faces;
  bvh->vertices.assign(vertices, vertices + 3 * n_verts);
  bvh->faces.assign(faces, faces + 3 * n_faces);
  bvh->prim.resize(n_faces);
  for (int64_t i = 0; i < n_faces; ++i) bvh->prim[i] = (int32_t)i;
  std::vector<V3> centroids(n_faces);
  for (int64_t f = 0; f < n_faces; ++f) {
    V3 a, b, c;
    bvh->tri((int32_t)f, a, b, c);
    centroids[f] = (a + b + c) * (1.0f / 3.0f);
  }
  bvh->nodes.reserve(2 * n_faces);
  bvh->nodes.push_back({});
  bvh_build_range(*bvh, centroids, 0, 0, (int32_t)n_faces);
  return bvh;
}

void qf_bvh_destroy(void* handle) { delete (BVH*)handle; }

void qf_bvh_update_vertices(void* handle, const float* vertices) {
  BVH* bvh = (BVH*)handle;
  std::memcpy(bvh->vertices.data(), vertices,
              sizeof(float) * 3 * bvh->n_verts);
  bvh_refit_node(*bvh, 0);
}

// outputs: tri_ids [n_rays*max_hits] (-1 padded), ts [n_rays*max_hits],
// counts [n_rays]
void qf_bvh_intersect(void* handle, const float* origins, const float* dirs,
                      int64_t n_rays, int32_t max_hits, int32_t n_threads,
                      int32_t* tri_ids, float* ts, int32_t* counts) {
  BVH* bvh = (BVH*)handle;
  if (n_threads <= 0)
    n_threads = (int32_t)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min((int)n_threads, 64));
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1024;
  auto worker = [&]() {
    std::vector<Hit> hits;
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n_rays) break;
      int64_t end = std::min(n_rays, start + chunk);
      for (int64_t r = start; r < end; ++r) {
        V3 o = v3(origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]);
        V3 d = v3(dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]);
        bvh_intersect_ray(*bvh, o, d, max_hits, hits);
        counts[r] = (int32_t)hits.size();
        for (int32_t h = 0; h < max_hits; ++h) {
          if (h < (int32_t)hits.size()) {
            tri_ids[r * max_hits + h] = hits[h].tri;
            ts[r * max_hits + h] = hits[h].t;
          } else {
            tri_ids[r * max_hits + h] = -1;
            ts[r * max_hits + h] = 0.0f;
          }
        }
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
}

// Attach per-face-corner UVs [n_faces * 3 * 2] so intersect_uv can emit
// interpolated texture coordinates per hit (the baked render path then
// skips its device-side face_data gather + barycentric solve — the
// reference reads textures the same way after its Embree cast,
// examples/utils.py:999-1095 / mesh_utils.py:350-354).
void qf_bvh_set_uv(void* handle, const float* uv_face_corners) {
  BVH* bvh = (BVH*)handle;
  bvh->uvfc.assign(uv_face_corners, uv_face_corners + 6 * bvh->n_faces);
}

// As qf_bvh_intersect, plus uvs [n_rays*max_hits*2]: the hit's
// barycentric-interpolated per-face-corner UV (requires qf_bvh_set_uv).
void qf_bvh_intersect_uv(void* handle, const float* origins,
                         const float* dirs, int64_t n_rays,
                         int32_t max_hits, int32_t n_threads,
                         int32_t* tri_ids, float* ts, int32_t* counts,
                         float* uvs) {
  BVH* bvh = (BVH*)handle;
  if (n_threads <= 0)
    n_threads = (int32_t)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min((int)n_threads, 64));
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1024;
  auto worker = [&]() {
    std::vector<Hit> hits;
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n_rays) break;
      int64_t end = std::min(n_rays, start + chunk);
      for (int64_t r = start; r < end; ++r) {
        V3 o = v3(origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]);
        V3 d = v3(dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]);
        bvh_intersect_ray(*bvh, o, d, max_hits, hits);
        counts[r] = (int32_t)hits.size();
        for (int32_t h = 0; h < max_hits; ++h) {
          int64_t k = r * max_hits + h;
          if (h < (int32_t)hits.size()) {
            const Hit& hit = hits[h];
            tri_ids[k] = hit.tri;
            ts[k] = hit.t;
            float w0 = 1.0f - hit.u - hit.v;
            const float* fuv = &bvh->uvfc[6 * hit.tri];
            uvs[2 * k] = w0 * fuv[0] + hit.u * fuv[2] + hit.v * fuv[4];
            uvs[2 * k + 1] = w0 * fuv[1] + hit.u * fuv[3] + hit.v * fuv[5];
          } else {
            tri_ids[k] = -1;
            ts[k] = 0.0f;
            uvs[2 * k] = 0.0f;
            uvs[2 * k + 1] = 0.0f;
          }
        }
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
}

// Packed multi-hit cast: casts like qf_bvh_intersect, then compacts the
// valid hits (ray-major, depth-sorted within each ray — the stream
// order render/quadrature.py's PackedHits expects) into cap-sized
// outputs. slots = ray*max_hits + hit_index (pad n_rays*max_hits),
// tri pad -1, t pad 0. Returns the TRUE total hit count; when it
// exceeds cap the stream truncates (highest ray indices lose hits
// first), matching pack_hit_rows' device semantics. This replaces
// shipping dense [R, max_hits] rows (plus a [R, max_hits, 3, 3]
// face-vertex gather) to the device: the host->device payload drops to
// 12 bytes per ACTUAL hit (the reference instead moves its packed hit
// stream CPU->GPU every step, train_finetune.py:307-317).
int64_t qf_bvh_intersect_packed(void* handle, const float* origins,
                                const float* dirs, int64_t n_rays,
                                int32_t max_hits, int64_t cap,
                                int32_t n_threads, int32_t* slots,
                                int32_t* tri, float* t) {
  BVH* bvh = (BVH*)handle;
  std::vector<int32_t> dense_tri((size_t)n_rays * max_hits);
  std::vector<float> dense_t((size_t)n_rays * max_hits);
  std::vector<int32_t> counts((size_t)n_rays);
  qf_bvh_intersect(handle, origins, dirs, n_rays, max_hits, n_threads,
                   dense_tri.data(), dense_t.data(), counts.data());
  (void)bvh;
  // exclusive prefix of counts -> each ray's output offset
  std::vector<int64_t> offs((size_t)n_rays + 1);
  offs[0] = 0;
  for (int64_t r = 0; r < n_rays; ++r) offs[r + 1] = offs[r] + counts[r];
  int64_t total = offs[n_rays];
  int64_t n_emit = std::min(total, cap);
  if (n_threads <= 0)
    n_threads = (int32_t)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min((int)n_threads, 64));
  std::atomic<int64_t> next(0);
  const int64_t chunk = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n_rays) break;
      int64_t end = std::min(n_rays, start + chunk);
      for (int64_t r = start; r < end; ++r) {
        int64_t o = offs[r];
        if (o >= n_emit) break;
        int32_t c = counts[r];
        for (int32_t h = 0; h < c && o + h < n_emit; ++h) {
          slots[o + h] = (int32_t)(r * max_hits + h);
          tri[o + h] = dense_tri[(size_t)r * max_hits + h];
          t[o + h] = dense_t[(size_t)r * max_hits + h];
        }
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int32_t pad_slot = (int32_t)(n_rays * max_hits);
  for (int64_t i = n_emit; i < cap; ++i) {
    slots[i] = pad_slot;
    tri[i] = -1;
    t[i] = 0.0f;
  }
  return total;
}

// marching tetrahedra
void* qf_mc_run(const float* grid, int32_t nx, int32_t ny, int32_t nz,
                float level, const float* origin, const float* spacing) {
  MarchingTets mt;
  MeshOut* out = new MeshOut(mt.run(grid, nx, ny, nz, level, origin, spacing));
  return out;
}
int64_t qf_mesh_num_verts(void* h) { return ((MeshOut*)h)->verts.size() / 3; }
int64_t qf_mesh_num_faces(void* h) { return ((MeshOut*)h)->faces.size() / 3; }
void qf_mesh_get(void* h, float* verts, int32_t* faces) {
  MeshOut* m = (MeshOut*)h;
  std::memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
  std::memcpy(faces, m->faces.data(), m->faces.size() * sizeof(int32_t));
}
void qf_mesh_free(void* h) { delete (MeshOut*)h; }

void* qf_decimate_cluster(const float* verts, int64_t nv,
                          const int32_t* faces, int64_t nf, float voxel) {
  return new MeshOut(decimate_cluster(verts, nv, faces, nf, voxel));
}

void qf_segment_mesh(const float* verts, int64_t nv, const int32_t* faces,
                     int64_t nf, float kthr, int32_t min_size,
                     int32_t* seg_out) {
  segment_mesh(verts, nv, faces, nf, kthr, min_size, seg_out);
}

// Rasterize triangles in UV space, writing barycentric-interpolated 3-D
// positions per texel (the V image of generate_uv_xatlas_old.py:133 /
// parameterization_utils.fill_triangles_fill_boundary). After the fill
// pass, `dilate` rounds of boundary dilation copy each filled texel
// into empty 4-neighbors (fill_boundary's seam guard).
void qf_rasterize_uv(const float* uv,      // [F, 3, 2] texel coords
                     const float* pos,     // [F, 3, 3] world positions
                     int64_t n_faces, int32_t height, int32_t width,
                     int32_t dilate,
                     float* v_image,       // [H, W, 3] out
                     int32_t* tri_image)   // [H, W] out, -1 empty
{
  for (int64_t i = 0; i < (int64_t)height * width; ++i) tri_image[i] = -1;
  std::memset(v_image, 0, sizeof(float) * 3 * height * width);
  for (int64_t f = 0; f < n_faces; ++f) {
    const float* u = uv + 6 * f;
    const float* p = pos + 9 * f;
    float minx = std::min({u[0], u[2], u[4]});
    float maxx = std::max({u[0], u[2], u[4]});
    float miny = std::min({u[1], u[3], u[5]});
    float maxy = std::max({u[1], u[3], u[5]});
    int x0 = std::max(0, (int)std::floor(minx));
    int x1 = std::min(width - 1, (int)std::ceil(maxx));
    int y0 = std::max(0, (int)std::floor(miny));
    int y1 = std::min(height - 1, (int)std::ceil(maxy));
    float ax = u[0], ay = u[1], bx = u[2], by = u[3], cx = u[4], cy = u[5];
    float den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
    bool degenerate = std::fabs(den) < 1e-12f;
    float cxm = (ax + bx + cx) / 3.0f, cym = (ay + by + cy) / 3.0f;
    V3 centroid = v3((p[0] + p[3] + p[6]) / 3.0f,
                     (p[1] + p[4] + p[7]) / 3.0f,
                     (p[2] + p[5] + p[8]) / 3.0f);
    if (degenerate) {
      int px = std::min(width - 1, std::max(0, (int)cxm));
      int py = std::min(height - 1, std::max(0, (int)cym));
      int64_t o = (int64_t)px * width + py;  // [row=x, col=y] layout
      tri_image[o] = (int32_t)f;
      v_image[3 * o] = centroid.x;
      v_image[3 * o + 1] = centroid.y;
      v_image[3 * o + 2] = centroid.z;
      continue;
    }
    for (int x = x0; x <= x1; ++x) {
      for (int y = y0; y <= y1; ++y) {
        float pxc = x + 0.5f, pyc = y + 0.5f;
        float w0 = ((by - cy) * (pxc - cx) + (cx - bx) * (pyc - cy)) / den;
        float w1 = ((cy - ay) * (pxc - cx) + (ax - cx) * (pyc - cy)) / den;
        float w2 = 1.0f - w0 - w1;
        const float eps = -1e-4f;
        if (w0 < eps || w1 < eps || w2 < eps) continue;
        w0 = std::max(0.0f, w0);
        w1 = std::max(0.0f, w1);
        w2 = std::max(0.0f, w2);
        float s = w0 + w1 + w2;
        w0 /= s; w1 /= s; w2 /= s;
        int64_t o = (int64_t)x * width + y;
        tri_image[o] = (int32_t)f;
        v_image[3 * o] = w0 * p[0] + w1 * p[3] + w2 * p[6];
        v_image[3 * o + 1] = w0 * p[1] + w1 * p[4] + w2 * p[7];
        v_image[3 * o + 2] = w0 * p[2] + w1 * p[5] + w2 * p[8];
      }
    }
  }
  // boundary dilation
  for (int round = 0; round < dilate; ++round) {
    std::vector<int64_t> fills;
    std::vector<int64_t> srcs;
    for (int x = 0; x < height; ++x) {
      for (int y = 0; y < width; ++y) {
        int64_t o = (int64_t)x * width + y;
        if (tri_image[o] >= 0) continue;
        const int dx[4] = {1, -1, 0, 0};
        const int dy[4] = {0, 0, 1, -1};
        for (int k = 0; k < 4; ++k) {
          int nx = x + dx[k], ny = y + dy[k];
          if (nx < 0 || ny < 0 || nx >= height || ny >= width) continue;
          int64_t no = (int64_t)nx * width + ny;
          if (tri_image[no] >= 0) {
            fills.push_back(o);
            srcs.push_back(no);
            break;
          }
        }
      }
    }
    for (size_t i = 0; i < fills.size(); ++i) {
      tri_image[fills[i]] = tri_image[srcs[i]];
      v_image[3 * fills[i]] = v_image[3 * srcs[i]];
      v_image[3 * fills[i] + 1] = v_image[3 * srcs[i] + 1];
      v_image[3 * fills[i] + 2] = v_image[3 * srcs[i] + 2];
    }
  }
}

}  // extern "C"
