// Native BVH triangle-mesh ray caster.
//
// Replaces the reference's Embree 4 dependency (cpp/ray_casting.cc:21-121)
// for the latency-critical host paths: single-ray viewport picking and
// small-batch casts where a device round trip would dominate.  The bulk
// batched casts (tracking, BA prim refresh) stay on the accelerator.
//
// Design: binned-SAH BVH (16 bins), max 4 triangles per leaf, iterative
// stack traversal, Möller–Trumbore intersection in double precision on
// the float vertices with a barycentric slack far below float resolution
// (so a ray through an edge two triangles share hits one of them, as in
// Embree's watertight test; a float32 test lets such rays slip through
// to the far side of a closed mesh), closest-hit semantics
// with the reference's masked-triangle rule — the nearest hit is found
// over all triangles and *then* discarded if masked, so masked geometry
// still occludes (cpp/ray_casting.cc:100-120).
//
// Exposed as a plain C ABI consumed via ctypes (polychase_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
    Vec3 lo{+std::numeric_limits<float>::infinity(),
            +std::numeric_limits<float>::infinity(),
            +std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};
    void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    void grow(const Aabb& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
    float area() const {
        Vec3 d = hi - lo;
        if (d.x < 0 || d.y < 0 || d.z < 0) return 0.0f;
        return 2.0f * (d.x * d.y + d.y * d.z + d.z * d.x);
    }
};

struct Node {
    Aabb bounds;
    int32_t left = -1;      // internal: left child (right = left + 1)
    int32_t first = 0;      // leaf: first triangle index
    int32_t count = 0;      // leaf: triangle count (0 → internal)
};

struct Bvh {
    std::vector<Vec3> p1, p2, p3;   // triangle corners in BVH order
    std::vector<uint32_t> prim_id;  // BVH order → original triangle id
    std::vector<Node> nodes;
    uint32_t num_tris = 0;
};

struct BuildPrim {
    Aabb bounds;
    Vec3 centroid;
    uint32_t id;
};

constexpr int kBins = 16;
constexpr int kLeafSize = 4;

int build_recursive(Bvh& bvh, std::vector<BuildPrim>& prims, int first,
                    int count) {
    const int node_idx = static_cast<int>(bvh.nodes.size());
    bvh.nodes.emplace_back();

    Aabb bounds, cbounds;
    for (int i = first; i < first + count; i++) {
        bounds.grow(prims[i].bounds);
        cbounds.grow(prims[i].centroid);
    }
    bvh.nodes[node_idx].bounds = bounds;

    if (count <= kLeafSize) {
        bvh.nodes[node_idx].first = first;
        bvh.nodes[node_idx].count = count;
        return node_idx;
    }

    // Binned SAH over the widest centroid axis
    Vec3 ext = cbounds.hi - cbounds.lo;
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z == std::max({ext.x, ext.y, ext.z})) axis = 2;
    const float lo = (&cbounds.lo.x)[axis];
    const float extent = (&ext.x)[axis];

    int split = -1;
    if (extent > 1e-12f) {
        Aabb bin_bounds[kBins];
        int bin_count[kBins] = {0};
        const float scale = kBins / extent;
        for (int i = first; i < first + count; i++) {
            int b = std::min(
                kBins - 1,
                static_cast<int>(((&prims[i].centroid.x)[axis] - lo) * scale));
            bin_count[b]++;
            bin_bounds[b].grow(prims[i].bounds);
        }
        // Sweep for the best split plane
        float right_area[kBins];
        Aabb acc;
        int total_right = 0;
        for (int b = kBins - 1; b > 0; b--) {
            acc.grow(bin_bounds[b]);
            total_right += bin_count[b];
            right_area[b] = acc.area() * total_right;
        }
        acc = Aabb();
        int left_n = 0;
        float best_cost = std::numeric_limits<float>::infinity();
        for (int b = 0; b < kBins - 1; b++) {
            acc.grow(bin_bounds[b]);
            left_n += bin_count[b];
            if (left_n == 0 || left_n == count) continue;
            const float cost = acc.area() * left_n + right_area[b + 1];
            if (cost < best_cost) {
                best_cost = cost;
                split = b;
            }
        }
        if (split >= 0) {
            const float plane = lo + (split + 1) * (extent / kBins);
            auto mid_it = std::partition(
                prims.begin() + first, prims.begin() + first + count,
                [&](const BuildPrim& p) {
                    return (&p.centroid.x)[axis] < plane;
                });
            int mid = static_cast<int>(mid_it - prims.begin());
            if (mid == first || mid == first + count) split = -1;
            else {
                const int left =
                    build_recursive(bvh, prims, first, mid - first);
                const int right =
                    build_recursive(bvh, prims, mid, first + count - mid);
                (void)right;  // right == left+? not guaranteed; store both
                bvh.nodes[node_idx].left = left;
                bvh.nodes[node_idx].first = right;  // reuse: right child idx
                bvh.nodes[node_idx].count = 0;
                return node_idx;
            }
        }
    }
    // Fallback: median split by index
    if (split < 0) {
        const int mid = first + count / 2;
        std::nth_element(
            prims.begin() + first, prims.begin() + mid,
            prims.begin() + first + count,
            [&](const BuildPrim& a, const BuildPrim& b) {
                return (&a.centroid.x)[axis] < (&b.centroid.x)[axis];
            });
        const int left = build_recursive(bvh, prims, first, count / 2);
        const int right =
            build_recursive(bvh, prims, mid, count - count / 2);
        bvh.nodes[node_idx].left = left;
        bvh.nodes[node_idx].first = right;
        bvh.nodes[node_idx].count = 0;
    }
    return node_idx;
}

inline bool intersect_aabb(const Aabb& b, const Vec3& o, const Vec3& inv_d,
                           float t_max) {
    float tx1 = (b.lo.x - o.x) * inv_d.x, tx2 = (b.hi.x - o.x) * inv_d.x;
    float tmin = std::min(tx1, tx2), tmax = std::max(tx1, tx2);
    float ty1 = (b.lo.y - o.y) * inv_d.y, ty2 = (b.hi.y - o.y) * inv_d.y;
    tmin = std::max(tmin, std::min(ty1, ty2));
    tmax = std::min(tmax, std::max(ty1, ty2));
    float tz1 = (b.lo.z - o.z) * inv_d.z, tz2 = (b.hi.z - o.z) * inv_d.z;
    tmin = std::max(tmin, std::min(tz1, tz2));
    tmax = std::min(tmax, std::max(tz1, tz2));
    // Widen the far end by the slab test's rounding (PBRT's 1 + 2·γ₃) so
    // a ray grazing a box face still visits the triangles inside it.
    tmax *= 1.0f + 2.0f * 3.0f * std::numeric_limits<float>::epsilon();
    return tmax >= std::max(tmin, 0.0f) && tmin < t_max;
}

}  // namespace

extern "C" {

void* bvh_build(const float* vertices, uint32_t num_vertices,
                const uint32_t* triangles, uint32_t num_triangles) {
    (void)num_vertices;
    Bvh* bvh = new Bvh();
    bvh->num_tris = num_triangles;
    if (num_triangles == 0) {
        bvh->nodes.emplace_back();
        return bvh;
    }

    std::vector<BuildPrim> prims(num_triangles);
    bvh->p1.resize(num_triangles);
    bvh->p2.resize(num_triangles);
    bvh->p3.resize(num_triangles);
    std::vector<Vec3> p1_orig(num_triangles), p2_orig(num_triangles),
        p3_orig(num_triangles);
    for (uint32_t i = 0; i < num_triangles; i++) {
        const uint32_t* t = triangles + 3 * i;
        const Vec3 a{vertices[3 * t[0]], vertices[3 * t[0] + 1],
                     vertices[3 * t[0] + 2]};
        const Vec3 b{vertices[3 * t[1]], vertices[3 * t[1] + 1],
                     vertices[3 * t[1] + 2]};
        const Vec3 c{vertices[3 * t[2]], vertices[3 * t[2] + 1],
                     vertices[3 * t[2] + 2]};
        p1_orig[i] = a;
        p2_orig[i] = b;
        p3_orig[i] = c;
        prims[i].bounds.grow(a);
        prims[i].bounds.grow(b);
        prims[i].bounds.grow(c);
        prims[i].centroid = (a + b + c) * (1.0f / 3.0f);
        prims[i].id = i;
    }
    bvh->nodes.reserve(2 * num_triangles);
    build_recursive(*bvh, prims, 0, static_cast<int>(num_triangles));

    // Store triangles in BVH order for cache-friendly leaves
    bvh->prim_id.resize(num_triangles);
    for (uint32_t i = 0; i < num_triangles; i++) {
        bvh->prim_id[i] = prims[i].id;
        bvh->p1[i] = p1_orig[prims[i].id];
        bvh->p2[i] = p2_orig[prims[i].id];
        bvh->p3[i] = p3_orig[prims[i].id];
    }
    return bvh;
}

void bvh_free(void* handle) { delete static_cast<Bvh*>(handle); }

// Cast `n` rays; for each, write hit position/normal/barycentric/t/prim.
// masked: packed u32 bitmask (may be null).  prim_out = 0xFFFFFFFF on miss.
void bvh_raycast(const void* handle, const float* origins, const float* dirs,
                 uint32_t n, const uint32_t* masked, float* pos_out,
                 float* normal_out, float* bary_out, float* t_out,
                 uint32_t* prim_out) {
    const Bvh& bvh = *static_cast<const Bvh*>(handle);
    constexpr uint32_t kInvalid = 0xFFFFFFFFu;
    constexpr double kEps = 1e-10;
    // Barycentric slack that covers the double test's own rounding, so a
    // ray exactly on a shared edge is taken by at least one side.
    constexpr double kBaryTol = 1e-9;

    for (uint32_t r = 0; r < n; r++) {
        const Vec3 o{origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        const Vec3 d{dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        const Vec3 inv_d{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};

        const double ox = o.x, oy = o.y, oz = o.z;
        const double dx = d.x, dy = d.y, dz = d.z;
        double best_t = std::numeric_limits<double>::infinity();
        double best_u = 0, best_v = 0;
        uint32_t best_local = kInvalid;

        if (!bvh.nodes.empty() && bvh.num_tris) {
            int stack[64];
            int sp = 0;
            stack[sp++] = 0;
            while (sp) {
                const Node& node = bvh.nodes[stack[--sp]];
                if (!intersect_aabb(node.bounds, o, inv_d,
                                    static_cast<float>(best_t)))
                    continue;
                if (node.count) {  // leaf
                    for (int i = node.first; i < node.first + node.count;
                         i++) {
                        const Vec3& a = bvh.p1[i];
                        const Vec3& b = bvh.p2[i];
                        const Vec3& c = bvh.p3[i];
                        // Float differences are exact in double.
                        const double e1x = double(b.x) - a.x,
                                     e1y = double(b.y) - a.y,
                                     e1z = double(b.z) - a.z;
                        const double e2x = double(c.x) - a.x,
                                     e2y = double(c.y) - a.y,
                                     e2z = double(c.z) - a.z;
                        const double pvx = dy * e2z - dz * e2y,
                                     pvy = dz * e2x - dx * e2z,
                                     pvz = dx * e2y - dy * e2x;
                        const double det = e1x * pvx + e1y * pvy + e1z * pvz;
                        if (std::fabs(det) < kEps) continue;
                        const double inv_det = 1.0 / det;
                        const double sx = ox - a.x, sy = oy - a.y,
                                     sz = oz - a.z;
                        const double u =
                            (sx * pvx + sy * pvy + sz * pvz) * inv_det;
                        if (u < -kBaryTol || u > 1.0 + kBaryTol) continue;
                        const double qx = sy * e1z - sz * e1y,
                                     qy = sz * e1x - sx * e1z,
                                     qz = sx * e1y - sy * e1x;
                        const double v = (dx * qx + dy * qy + dz * qz) * inv_det;
                        if (v < -kBaryTol || u + v > 1.0 + kBaryTol)
                            continue;
                        const double t =
                            (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                        if (t > 0.0 && t < best_t) {
                            best_t = t;
                            best_u = u;
                            best_v = v;
                            best_local = static_cast<uint32_t>(i);
                        }
                    }
                } else {
                    stack[sp++] = node.left;
                    stack[sp++] = node.first;  // right child
                }
            }
        }

        uint32_t prim = kInvalid;
        if (best_local != kInvalid) {
            prim = bvh.prim_id[best_local];
            // Masked triangles occlude but do not produce hits
            // (cpp/ray_casting.cc:100-120).
            if (masked && ((masked[prim >> 5] >> (prim & 31)) & 1u)) {
                prim = kInvalid;
            }
        }

        if (prim != kInvalid) {
            const Vec3 p = o + d * static_cast<float>(best_t);
            const Vec3& a = bvh.p1[best_local];
            Vec3 ng = cross(bvh.p2[best_local] - a, bvh.p3[best_local] - a);
            const float len =
                std::sqrt(std::max(dot(ng, ng), 1e-30f));
            ng = ng * (1.0f / len);
            pos_out[3 * r] = p.x;
            pos_out[3 * r + 1] = p.y;
            pos_out[3 * r + 2] = p.z;
            normal_out[3 * r] = ng.x;
            normal_out[3 * r + 1] = ng.y;
            normal_out[3 * r + 2] = ng.z;
            bary_out[2 * r] = static_cast<float>(best_u);
            bary_out[2 * r + 1] = static_cast<float>(best_v);
            t_out[r] = static_cast<float>(best_t);
            prim_out[r] = prim;
        } else {
            std::memset(pos_out + 3 * r, 0, 3 * sizeof(float));
            std::memset(normal_out + 3 * r, 0, 3 * sizeof(float));
            bary_out[2 * r] = bary_out[2 * r + 1] = 0.0f;
            t_out[r] = std::numeric_limits<float>::infinity();
            prim_out[r] = kInvalid;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy min-distance corner suppression (cpp/feature_detection/gftt.cc:100-164)
// Candidates must arrive sorted by quality (descending).  Returns the number
// of accepted candidates; their indices (into the input order) are written to
// accepted_out.
// ---------------------------------------------------------------------------

extern "C" uint32_t gftt_min_distance_suppress(
    const float* xs, const float* ys, uint32_t n, int32_t width,
    int32_t height, float min_distance, int32_t max_corners,
    uint32_t* accepted_out) {
    const int cell = static_cast<int>(min_distance + 0.5f);
    if (cell <= 0 || n == 0) return 0;
    const int gw = (width + cell - 1) / cell;
    const int gh = (height + cell - 1) / cell;
    const float md2 = min_distance * min_distance;

    // Grid of small vectors of accepted points
    std::vector<std::vector<std::pair<float, float>>> grid(
        static_cast<size_t>(gw) * gh);

    uint32_t count = 0;
    for (uint32_t i = 0; i < n; i++) {
        const float x = xs[i];
        const float y = ys[i];
        const int xc = static_cast<int>(x) / cell;
        const int yc = static_cast<int>(y) / cell;
        const int x1 = std::max(xc - 1, 0);
        const int y1 = std::max(yc - 1, 0);
        const int x2 = std::min(xc + 1, gw - 1);
        const int y2 = std::min(yc + 1, gh - 1);

        bool good = true;
        for (int yy = y1; yy <= y2 && good; yy++) {
            for (int xx = x1; xx <= x2 && good; xx++) {
                for (const auto& p : grid[yy * gw + xx]) {
                    const float dx = x - p.first;
                    const float dy = y - p.second;
                    if (dx * dx + dy * dy < md2) {
                        good = false;
                        break;
                    }
                }
            }
        }
        if (good) {
            grid[yc * gw + xc].emplace_back(x, y);
            accepted_out[count++] = i;
            if (max_corners > 0 &&
                static_cast<int32_t>(count) == max_corners) {
                break;
            }
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// Fused quality sort + greedy suppression for GFTT candidates.
//
// The Python path (np.lexsort((-lin, -vals)) followed by the grid pass
// above) spends ~10 ms/frame at 16k candidates on a 1-core host; here one
// std::sort plus a flat fixed-capacity grid does the same work in <1 ms.
// Candidates are integer pixel positions given as linear indices
// (lin = y * width + x); ordering matches the reference's deterministic
// sort exactly: quality descending, ties broken by LATER row-major
// position first (cpp/feature_detection/gftt.cc:7-12, the pointer-address
// tie-break).  Accepted original-candidate indices are written to
// accepted_out in acceptance (quality-desc) order.
//
// Grid capacity: any d x d cell holds at most 4 points that are pairwise
// >= d apart (split the cell into quadrants; a quadrant's diagonal is
// < d for every d >= 1 with cell = round(d)), so kCap = 6 never
// overflows; the guard falls back to rejecting the candidate against an
// overflow list to stay exact regardless.
// ---------------------------------------------------------------------------

// Totally-ordered sortable encoding of an IEEE float (sign-magnitude to
// biased-unsigned): preserves < exactly for every non-NaN value.
static inline uint32_t float_key(float v) {
    if (v == 0.0f) v = 0.0f;  // collapse -0.0 to +0.0 (compare equal)
    uint32_t b;
    std::memcpy(&b, &v, sizeof(b));
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Keyed candidate: one 8-byte comparison gives (quality desc, row-major
// position desc) when sorted descending — an indirect two-array
// comparator costs ~3x more wall time at 16k candidates.
struct KeyedIdx {
    uint64_t key;
    uint32_t idx;
};

static void quality_sort(const float* vals, const int64_t* lin, uint32_t n,
                         std::vector<KeyedIdx>& keyed) {
    keyed.resize(n);
    for (uint32_t i = 0; i < n; i++) {
        // lin fits 32 bits for any real frame (2^31 pixels); clamp
        // defensively so huge synthetic inputs stay ordered by quality.
        const uint64_t l = static_cast<uint64_t>(
            lin[i] < 0 ? 0 : (lin[i] > 0x7FFFFFFFll ? 0x7FFFFFFFll
                                                    : lin[i]));
        keyed[i].key = (static_cast<uint64_t>(float_key(vals[i])) << 32) | l;
        keyed[i].idx = i;
    }
    std::sort(keyed.begin(), keyed.end(),
              [](const KeyedIdx& a, const KeyedIdx& b) {
                  return a.key > b.key;
              });
}

extern "C" uint32_t gftt_sort_suppress(
    const float* vals, const int64_t* lin, uint32_t n, int32_t width,
    int32_t height, float min_distance, int32_t max_corners,
    uint32_t* accepted_out) {
    if (n == 0) return 0;

    std::vector<KeyedIdx> keyed;
    quality_sort(vals, lin, n, keyed);

    if (min_distance < 1.0f) {
        uint32_t count = n;
        if (max_corners > 0 && static_cast<uint32_t>(max_corners) < count)
            count = static_cast<uint32_t>(max_corners);
        for (uint32_t oi = 0; oi < count; oi++)
            accepted_out[oi] = keyed[oi].idx;
        return count;
    }

    const int cell = static_cast<int>(min_distance + 0.5f);
    const int gw = (width + cell - 1) / cell;
    const int gh = (height + cell - 1) / cell;
    const float md2 = min_distance * min_distance;

    constexpr int kCap = 6;
    std::vector<float> slots(static_cast<size_t>(gw) * gh * kCap * 2);
    std::vector<uint8_t> counts(static_cast<size_t>(gw) * gh, 0);
    std::vector<std::pair<float, float>> overflow;

    uint32_t count = 0;
    for (uint32_t oi = 0; oi < n; oi++) {
        const uint32_t i = keyed[oi].idx;
        const int64_t l = lin[i];
        const float x = static_cast<float>(l % width);
        const float y = static_cast<float>(l / width);
        const int xc = static_cast<int>(x) / cell;
        const int yc = static_cast<int>(y) / cell;
        const int x1 = std::max(xc - 1, 0);
        const int y1 = std::max(yc - 1, 0);
        const int x2 = std::min(xc + 1, gw - 1);
        const int y2 = std::min(yc + 1, gh - 1);

        bool good = true;
        for (int yy = y1; yy <= y2 && good; yy++) {
            for (int xx = x1; xx <= x2 && good; xx++) {
                const size_t c = static_cast<size_t>(yy) * gw + xx;
                const float* s = &slots[c * kCap * 2];
                const int m = counts[c];
                for (int j = 0; j < m; j++) {
                    const float dx = x - s[2 * j];
                    const float dy = y - s[2 * j + 1];
                    if (dx * dx + dy * dy < md2) {
                        good = false;
                        break;
                    }
                }
            }
        }
        if (good && !overflow.empty()) {
            for (const auto& p : overflow) {
                const float dx = x - p.first;
                const float dy = y - p.second;
                if (dx * dx + dy * dy < md2) {
                    good = false;
                    break;
                }
            }
        }
        if (good) {
            const size_t c = static_cast<size_t>(yc) * gw + xc;
            if (counts[c] < kCap) {
                float* s = &slots[c * kCap * 2];
                s[2 * counts[c]] = x;
                s[2 * counts[c] + 1] = y;
                counts[c]++;
            } else {
                overflow.emplace_back(x, y);
            }
            accepted_out[count++] = i;
            if (max_corners > 0 &&
                static_cast<int32_t>(count) == max_corners) {
                break;
            }
        }
    }
    return count;
}

// Quality-descending order (ties: later row-major position first) without
// the suppression pass — the device-suppressed GFTT branch only needs the
// deterministic ordering of its survivors (np.lexsort is ~20 ms at the 4K
// path's 170k survivors; this is one std::sort).
extern "C" void gftt_quality_order(
    const float* vals, const int64_t* lin, uint32_t n, uint32_t* order_out) {
    std::vector<KeyedIdx> keyed;
    quality_sort(vals, lin, n, keyed);
    for (uint32_t i = 0; i < n; i++) order_out[i] = keyed[i].idx;
}

// ---------------------------------------------------------------------------
// Tracking-chain chunk packer (engine/tracker._track_chunked_scan).
//
// The scan chain's host floor is per-chunk numpy packing: ~256 fancy-index
// gathers + slice writes + a per-frame quantization pass per 32-frame chunk.
// This fuses the whole pack — keypoint-index copy, delta
// gather against the clip keypoint table, max-|delta| scan and i16
// quantization — into one C pass per chunk.  Bit-exact with the numpy path
// (tests/test_tracker.py pins both formats): deltas in f32, scale m/32700.0
// in f64 then cast, rintf round-half-to-even like np.rint, i16 cast exact
// on integral values.
// ---------------------------------------------------------------------------

extern "C" void pack_track_chunk(
    int32_t ch, int32_t gp, int32_t k, int32_t kmax, int32_t idx_dtype,
    int32_t quant,
    const int32_t* tgt_i,    // (ch,) incl. padding rows
    const int32_t* warm_i,   // (ch,)
    const int32_t* g_src,    // (ch, gp) source frame rel index
    const int32_t* g_n,      // (ch, gp) points per group (0 = unused)
    const int64_t* g_off,    // (ch, gp) offset into flat_idx / flat_tpx
    const uint32_t* flat_idx,
    const float* flat_tpx,   // (total, 2)
    const float* kps_all,    // (F, kmax, 2)
    int32_t* meta,           // (ch, 2*gp + 3)
    void* kp_idx_out,        // (ch, gp, k) of u8 / u16 / i32
    void* tgt_out) {         // (ch, gp, k, 2): i16 if quant else f32
    const size_t row_pts = static_cast<size_t>(gp) * k;
    const size_t idx_sz = idx_dtype == 0 ? 1 : (idx_dtype == 1 ? 2 : 4);
    std::memset(kp_idx_out, 0, static_cast<size_t>(ch) * row_pts * idx_sz);
    std::memset(tgt_out, 0,
                static_cast<size_t>(ch) * row_pts * 2 *
                    (quant ? sizeof(int16_t) : sizeof(float)));

    std::vector<float> scratch;
    if (quant) scratch.assign(row_pts * 2, 0.0f);

    const int32_t mw = 2 * gp + 3;
    for (int32_t r = 0; r < ch; r++) {
        int32_t* mrow = meta + static_cast<size_t>(r) * mw;
        std::memcpy(mrow, g_src + static_cast<size_t>(r) * gp,
                    sizeof(int32_t) * gp);
        std::memcpy(mrow + gp, g_n + static_cast<size_t>(r) * gp,
                    sizeof(int32_t) * gp);
        mrow[2 * gp] = tgt_i[r];
        mrow[2 * gp + 1] = warm_i[r];
        mrow[2 * gp + 2] = 0;

        if (quant) std::memset(scratch.data(), 0, row_pts * 2 * sizeof(float));
        float maxabs = 0.0f;
        for (int32_t g = 0; g < gp; g++) {
            const int32_t n = g_n[static_cast<size_t>(r) * gp + g];
            if (n <= 0) continue;
            const int64_t off = g_off[static_cast<size_t>(r) * gp + g];
            const uint32_t* idx = flat_idx + off;
            const float* tpx = flat_tpx + 2 * off;
            const size_t base = (static_cast<size_t>(r) * gp + g) * k;
            // Keypoint indices, cast to the output dtype.
            if (idx_dtype == 0) {
                uint8_t* o = static_cast<uint8_t*>(kp_idx_out) + base;
                for (int32_t i = 0; i < n; i++)
                    o[i] = static_cast<uint8_t>(idx[i]);
            } else if (idx_dtype == 1) {
                uint16_t* o = static_cast<uint16_t*>(kp_idx_out) + base;
                for (int32_t i = 0; i < n; i++)
                    o[i] = static_cast<uint16_t>(idx[i]);
            } else {
                int32_t* o = static_cast<int32_t*>(kp_idx_out) + base;
                for (int32_t i = 0; i < n; i++)
                    o[i] = static_cast<int32_t>(idx[i]);
            }
            if (quant) {
                // Delta vs the clip keypoint table; track max |delta|.
                const float* kp_row =
                    kps_all +
                    static_cast<size_t>(g_src[static_cast<size_t>(r) * gp +
                                              g]) *
                        kmax * 2;
                float* d = scratch.data() + (static_cast<size_t>(g) * k) * 2;
                for (int32_t i = 0; i < n; i++) {
                    const float dx = tpx[2 * i] - kp_row[2 * idx[i]];
                    const float dy = tpx[2 * i + 1] - kp_row[2 * idx[i] + 1];
                    d[2 * i] = dx;
                    d[2 * i + 1] = dy;
                    const float ax = std::fabs(dx);
                    const float ay = std::fabs(dy);
                    if (ax > maxabs) maxabs = ax;
                    if (ay > maxabs) maxabs = ay;
                }
            } else {
                float* o = static_cast<float*>(tgt_out) + base * 2;
                std::memcpy(o, tpx, sizeof(float) * 2 * n);
            }
        }
        if (quant) {
            // scale = m / 32700.0 in f64 (python float), stored as f32
            // bits in the meta row; multiply by f32(1/scale) and
            // round-half-even exactly like np.rint on a f32 array.
            const double scale_d =
                maxabs > 0.0f ? static_cast<double>(maxabs) / 32700.0 : 1.0;
            const float scale_f = static_cast<float>(scale_d);
            const float inv_f = static_cast<float>(1.0 / scale_d);
            std::memcpy(&mrow[2 * gp + 2], &scale_f, sizeof(float));
            int16_t* o =
                static_cast<int16_t*>(tgt_out) + static_cast<size_t>(r) *
                                                     row_pts * 2;
            const float* d = scratch.data();
            for (size_t i = 0; i < row_pts * 2; i++)
                o[i] = static_cast<int16_t>(std::rint(d[i] * inv_f));
        }
    }
}
