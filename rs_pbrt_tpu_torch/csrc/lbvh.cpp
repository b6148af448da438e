// Host BVH builder: binned-SAH binary tree, collapsed into 12-wide rows.
//
// The port's own copy of what it needs from the JAX package's native
// builder (native/lbvh.cpp: sah_build and wide12_build through
// widen_build_impl), compiled by ops/_build.py with the host C++ compiler
// and bound with ctypes by ops/bvh_native.py.  The traversal kernels of
// csrc/bvh12.cu and the plain version in ops/bvh.py read the rows.
//
// sah_build (reference src/accelerators/bvh.rs recursive_build :178-357:
// SAH, 12 buckets): a binary tree with single-primitive leaves (exactly
// n-1 internal nodes, allocated in pre-order so the root is node 0); child
// refs encode leaves as ~position-in-leaf-order; prim_ids_out maps leaf
// position -> original primitive.
//
// wide12_build: the binary tree collapsed into 128-f32 (512 B) rows,
// discriminated by col 127 (0 = internal, 1 = leaf):
//   internal: bmin_x[0:12] bmin_y[12:24] bmin_z[24:36]
//             bmax_x[36:48] bmax_y[48:60] bmax_z[60:72]
//             child_base[72] count[73]; child i (< count) is row base+i
//   leaf:     p0x[0:12] p0y[12:24] p0z[24:36] p1x[36:48] ... p2z[96:108]
//             prim_id[108:120] count[120]
// Empty internal slots carry inverted boxes (+1e30/-1e30); empty leaf slots
// duplicate triangle 0 (an idempotent extra test).  Ids are stored as f32
// values, exact below 2^24 (ops/bvh_native.py asserts the row count).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct SahBuilder {
  int n;
  const float* bmin;
  const float* bmax;
  std::vector<float> cent;  // (n,3) centroids
  std::vector<int> perm;    // primitive permutation (leaf order)
  int* child_l;
  int* child_r;
  float* bmin_l;
  float* bmax_l;
  float* bmin_r;
  float* bmax_r;
  int next_node = 0;

  // build over perm[lo..hi) -> returns child ref (internal id or ~leafpos)
  int build(int lo, int hi, float* out_min, float* out_max) {
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    float cmn[3] = {1e30f, 1e30f, 1e30f}, cmx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; ++i) {
      int p = perm[i];
      for (int c = 0; c < 3; ++c) {
        float a = bmin[p * 3 + c], b = bmax[p * 3 + c], ce = cent[p * 3 + c];
        if (a < mn[c]) mn[c] = a;
        if (b > mx[c]) mx[c] = b;
        if (ce < cmn[c]) cmn[c] = ce;
        if (ce > cmx[c]) cmx[c] = ce;
      }
    }
    for (int c = 0; c < 3; ++c) {
      out_min[c] = mn[c];
      out_max[c] = mx[c];
    }
    if (hi - lo == 1) return ~lo;  // leaf at position lo

    // split axis = max centroid extent
    int axis = 0;
    float ext[3];
    for (int c = 0; c < 3; ++c) ext[c] = cmx[c] - cmn[c];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] <= 1e-12f) {
      mid = (lo + hi) / 2;  // equal-counts fallback (degenerate centroids)
    } else if (hi - lo <= 4) {
      // tiny ranges: median split on the axis
      mid = (lo + hi) / 2;
      std::nth_element(perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
                       [&](int a, int b) { return cent[a * 3 + axis] < cent[b * 3 + axis]; });
    } else {
      // 12-bucket binned SAH (bvh.rs:249 n_buckets = 12)
      constexpr int NB = 12;
      int cnt[NB] = {0};
      float bmn[NB][3], bmx[NB][3];
      for (int b = 0; b < NB; ++b)
        for (int c = 0; c < 3; ++c) {
          bmn[b][c] = 1e30f;
          bmx[b][c] = -1e30f;
        }
      float inv = NB / ext[axis];
      for (int i = lo; i < hi; ++i) {
        int p = perm[i];
        int b = (int)((cent[p * 3 + axis] - cmn[axis]) * inv);
        if (b < 0) b = 0;
        if (b >= NB) b = NB - 1;
        ++cnt[b];
        for (int c = 0; c < 3; ++c) {
          float a = bmin[p * 3 + c], q = bmax[p * 3 + c];
          if (a < bmn[b][c]) bmn[b][c] = a;
          if (q > bmx[b][c]) bmx[b][c] = q;
        }
      }
      auto area = [](const float* a, const float* b) {
        float d0 = b[0] - a[0], d1 = b[1] - a[1], d2 = b[2] - a[2];
        return 2.0f * (d0 * d1 + d0 * d2 + d1 * d2);
      };
      // sweep: cost(i) = left of bucket i+1 vs right
      float lmn[NB][3], lmx[NB][3], rmn[NB][3], rmx[NB][3];
      int lcnt[NB], rcnt[NB];
      float curmn[3] = {1e30f, 1e30f, 1e30f}, curmx[3] = {-1e30f, -1e30f, -1e30f};
      int curc = 0;
      for (int b = 0; b < NB; ++b) {
        curc += cnt[b];
        for (int c = 0; c < 3; ++c) {
          if (bmn[b][c] < curmn[c]) curmn[c] = bmn[b][c];
          if (bmx[b][c] > curmx[c]) curmx[c] = bmx[b][c];
          lmn[b][c] = curmn[c];
          lmx[b][c] = curmx[c];
        }
        lcnt[b] = curc;
      }
      for (int c = 0; c < 3; ++c) {
        curmn[c] = 1e30f;
        curmx[c] = -1e30f;
      }
      curc = 0;
      for (int b = NB - 1; b >= 0; --b) {
        curc += cnt[b];
        for (int c = 0; c < 3; ++c) {
          if (bmn[b][c] < curmn[c]) curmn[c] = bmn[b][c];
          if (bmx[b][c] > curmx[c]) curmx[c] = bmx[b][c];
          rmn[b][c] = curmn[c];
          rmx[b][c] = curmx[c];
        }
        rcnt[b] = curc;
      }
      int best = -1;
      float best_cost = 1e30f;
      for (int b = 0; b < NB - 1; ++b) {
        if (!lcnt[b] || !rcnt[b + 1]) continue;
        float cost =
            lcnt[b] * area(lmn[b], lmx[b]) + rcnt[b + 1] * area(rmn[b + 1], rmx[b + 1]);
        if (cost < best_cost) {
          best_cost = cost;
          best = b;
        }
      }
      if (best < 0) {
        mid = (lo + hi) / 2;
        std::nth_element(perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
                         [&](int a, int b) { return cent[a * 3 + axis] < cent[b * 3 + axis]; });
      } else {
        float split = cmn[axis] + (best + 1) * ext[axis] / NB;
        int* first = perm.data() + lo;
        int* last = perm.data() + hi;
        int* pmid =
            std::partition(first, last, [&](int p) { return cent[p * 3 + axis] < split; });
        mid = lo + (int)(pmid - first);
        if (mid == lo || mid == hi) mid = (lo + hi) / 2;
      }
    }

    int node = next_node++;
    float lmn2[3], lmx2[3], rmn2[3], rmx2[3];
    int cl = build(lo, mid, lmn2, lmx2);
    int cr = build(mid, hi, rmn2, rmx2);
    child_l[node] = cl;
    child_r[node] = cr;
    for (int c = 0; c < 3; ++c) {
      bmin_l[node * 3 + c] = lmn2[c];
      bmax_l[node * 3 + c] = lmx2[c];
      bmin_r[node * 3 + c] = rmn2[c];
      bmax_r[node * 3 + c] = rmx2[c];
    }
    return node;
  }
};

constexpr int A = 12;    // child slots per internal row
constexpr int L = 12;    // triangles per leaf row
constexpr int RW = 128;  // row width in f32 cols

struct Wide12 {
  const int* child_l;
  const int* child_r;
  const float* bmin_l;
  const float* bmax_l;
  const float* bmin_r;
  const float* bmax_r;
  const int* prim_ids;
  const float* p0;
  const float* p1;
  const float* p2;  // (T,3) original order
  std::vector<float> rows;
  long n_rows = 0;
  int max_depth = 0;

  long alloc(int k) {
    long base = n_rows;
    n_rows += k;
    rows.resize((size_t)n_rows * RW, 0.0f);
    return base;
  }

  void child_bounds(int node, bool left, float* b) const {
    const float* mn = left ? bmin_l : bmin_r;
    const float* mx = left ? bmax_l : bmax_r;
    for (int c = 0; c < 3; ++c) {
      b[c] = mn[node * 3 + c];
      b[3 + c] = mx[node * 3 + c];
    }
  }

  // collapse binary ref `node`'s children into up to A wide children by
  // repeatedly splitting the largest-area internal item; an item whose
  // subtree fits a leaf row (<= L leaves) is left unsplit so it packs into
  // one leaf row
  void wide_children(int node, int* refs, float* bs, int* count) const {
    struct Item {
      int ref;
      float b[6];
    };
    Item items[A];
    int ni = 0;
    items[ni].ref = child_l[node];
    child_bounds(node, true, items[ni++].b);
    items[ni].ref = child_r[node];
    child_bounds(node, false, items[ni++].b);
    while (ni < A) {
      int pick = -1;
      float best_area = -1.0f;
      for (int i = 0; i < ni; ++i) {
        if (items[i].ref < 0) continue;
        if (count_leaves(items[i].ref, L + 1) <= L) continue;  // stays a leaf row
        float d0 = items[i].b[3] - items[i].b[0];
        float d1 = items[i].b[4] - items[i].b[1];
        float d2 = items[i].b[5] - items[i].b[2];
        float a = d0 * d1 + d0 * d2 + d1 * d2;
        if (a > best_area) {
          best_area = a;
          pick = i;
        }
      }
      if (pick < 0) break;
      int in = items[pick].ref;
      Item l, r;
      l.ref = child_l[in];
      child_bounds(in, true, l.b);
      r.ref = child_r[in];
      child_bounds(in, false, r.b);
      items[pick] = l;
      items[ni++] = r;
    }
    *count = ni;
    for (int i = 0; i < ni; ++i) {
      refs[i] = items[i].ref;
      for (int c = 0; c < 6; ++c) bs[i * 6 + c] = items[i].b[c];
    }
  }

  // capped count: stops descending once the running total reaches cap,
  // keeping the whole collapse O(n)
  int count_leaves(int ref, int cap) const {
    if (ref < 0) return 1;
    int a = count_leaves(child_l[ref], cap);
    if (a >= cap) return a;
    return a + count_leaves(child_r[ref], cap - a);
  }

  void collect_leaves(int ref, int* out, int* k) const {
    if (ref < 0) {
      out[(*k)++] = ~ref;
      return;
    }
    collect_leaves(child_l[ref], out, k);
    collect_leaves(child_r[ref], out, k);
  }

  // leaf rows are SoA by component, so a traversal's triangle test reads
  // 12-wide slices of the row
  void fill_leaf_row(long row, const int* leafpos, int k) {
    float* r = &rows[(size_t)row * RW];
    for (int i = 0; i < L; ++i) {
      int prim = i < k ? prim_ids[leafpos[i]] : prim_ids[leafpos[0]];
      for (int c = 0; c < 3; ++c) {
        r[0 + c * L + i] = p0[prim * 3 + c];
        r[3 * L + c * L + i] = p1[prim * 3 + c];
        r[6 * L + c * L + i] = p2[prim * 3 + c];
      }
      r[9 * L + i] = (float)prim;
    }
    r[10 * L] = (float)k;
    r[RW - 1] = 1.0f;
  }

  void emit(int ref, long row, int depth) {
    if (depth > max_depth) max_depth = depth;
    int nl = count_leaves(ref, L + 1);
    if (nl <= L) {
      int leaves[L + 2];
      int k = 0;
      collect_leaves(ref, leaves, &k);
      fill_leaf_row(row, leaves, k);
      return;
    }
    int refs[A];
    float bs[6 * A];
    int count;
    wide_children(ref, refs, bs, &count);
    long base = alloc(count);
    float* r = &rows[(size_t)row * RW];
    for (int i = 0; i < A; ++i) {
      bool live = i < count;
      r[0 * A + i] = live ? bs[i * 6 + 0] : 1e30f;
      r[1 * A + i] = live ? bs[i * 6 + 1] : 1e30f;
      r[2 * A + i] = live ? bs[i * 6 + 2] : 1e30f;
      r[3 * A + i] = live ? bs[i * 6 + 3] : -1e30f;
      r[4 * A + i] = live ? bs[i * 6 + 4] : -1e30f;
      r[5 * A + i] = live ? bs[i * 6 + 5] : -1e30f;
    }
    r[6 * A] = (float)base;
    r[6 * A + 1] = (float)count;
    r[RW - 1] = 0.0f;
    for (int i = 0; i < count; ++i) emit(refs[i], base + i, depth + 1);
  }
};

}  // namespace

// Binary SAH tree over n primitive boxes (bmin, bmax: (n,3)).  Outputs
// (n-1 internal nodes, at least 1): child_l/child_r, the children's boxes,
// and prim_ids_out (n,).  Returns 0, or < 0 on error.
extern "C" int rs_sah_build(const float* bmin, const float* bmax, int n, int* child_l,
                            int* child_r, float* bmin_l, float* bmax_l, float* bmin_r,
                            float* bmax_r, int* prim_ids_out) {
  if (n < 1) return -1;
  if (n == 1) {
    child_l[0] = ~0;
    child_r[0] = ~0;
    for (int c = 0; c < 3; ++c) {
      bmin_l[c] = bmin_r[c] = bmin[c];
      bmax_l[c] = bmax_r[c] = bmax[c];
    }
    prim_ids_out[0] = 0;
    return 0;
  }
  SahBuilder S;
  S.n = n;
  S.bmin = bmin;
  S.bmax = bmax;
  S.cent.resize(3 * (size_t)n);
  for (size_t i = 0; i < 3 * (size_t)n; ++i) S.cent[i] = 0.5f * (bmin[i] + bmax[i]);
  S.perm.resize(n);
  for (int i = 0; i < n; ++i) S.perm[i] = i;
  S.child_l = child_l;
  S.child_r = child_r;
  S.bmin_l = bmin_l;
  S.bmax_l = bmax_l;
  S.bmin_r = bmin_r;
  S.bmax_r = bmax_r;
  float mn[3], mx[3];
  int root = S.build(0, n, mn, mx);
  if (root != 0 || S.next_node != n - 1) return -2;
  for (int i = 0; i < n; ++i) prim_ids_out[i] = S.perm[i];
  return 0;
}

// The 12-wide rows of a binary tree from rs_sah_build over triangles p0,
// p1, p2 ((T,3), original order).  Returns the number of rows written, or
// -rows needed when cap (in floats) is too small, or 0 on error;
// depth_out[0] = the wide tree's depth (root = 1).
extern "C" long rs_wide12_build(const int* child_l, const int* child_r, const float* bmin_l,
                                const float* bmax_l, const float* bmin_r, const float* bmax_r,
                                const int* prim_ids, const float* p0, const float* p1,
                                const float* p2, int n, float* rows_out, long cap,
                                int* depth_out) {
  if (n < 1) return 0;
  Wide12 W;
  W.child_l = child_l;
  W.child_r = child_r;
  W.bmin_l = bmin_l;
  W.bmax_l = bmax_l;
  W.bmin_r = bmin_r;
  W.bmax_r = bmax_r;
  W.prim_ids = prim_ids;
  W.p0 = p0;
  W.p1 = p1;
  W.p2 = p2;
  W.alloc(1);
  if (n == 1) {
    int leaves[1] = {0};
    W.fill_leaf_row(0, leaves, 1);
  } else {
    W.emit(0, 0, 1);
  }
  if (depth_out) *depth_out = W.max_depth;
  if (W.n_rows * (long)RW > cap) return -W.n_rows;
  std::memcpy(rows_out, W.rows.data(), (size_t)W.n_rows * RW * sizeof(float));
  return W.n_rows;
}
