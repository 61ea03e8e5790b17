// Native runtime components for sfvp_tpu, exposed via a C ABI for ctypes.
//
// The reference keeps its scene ingest (tinyobjloader, ref main.cpp:28-58)
// and acceleration-structure build (ref main.cpp:414-455) in C++; these are
// their counterparts here:
//   - OBJ/MTL loader with the exact flattening semantics of the Python
//     parser in sfvp_tpu/scene/objload.py (fan triangulation, Y-flip,
//     non-indexed expansion, per-face materials) — byte-identical outputs.
//   - LBVH builder producing the exact topology of
//     sfvp_tpu/accel/lbvh.py (30-bit morton codes, stable sort,
//     highest-differing-bit splits, DFS skip-link flattening).
//
// Build: `make -C csrc` -> csrc/libsfvp_native.so (loaded by
// sfvp_tpu/native.py; everything degrades gracefully to the Python
// implementations when the library is absent).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Material {
  float kd[3] = {0, 0, 0};
  float ke[3] = {0, 0, 0};
  float ks[3] = {0, 0, 0};
  float ns = 0.f, ni = 1.f, illum = 2.f, pr = 0.f;
  std::string map_kd;  // absolute path, empty = none
};

struct SceneData {
  std::vector<float> vertices;   // 3T * 3, Y negated
  std::vector<float> diffuse;    // T * 3
  std::vector<float> emission;   // T * 3
  std::vector<float> specular;   // T * 3
  std::vector<int32_t> mat_type; // T
  std::vector<float> rough;      // T (GGX roughness, mtype 2)
  std::vector<float> uvs;        // T * 6 per-corner vt (0 when absent)
  std::vector<int32_t> face_tex; // T texture index, -1 = none
  std::string tex_paths;         // newline-joined absolute texture paths
  std::vector<int32_t> mat_id;   // T
  std::string names;             // newline-joined material names
  std::string error;
};

std::string strip(const std::string& line) {
  std::string s = line.substr(0, line.find('#'));
  size_t b = s.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(" \t\r\n");
  return s.substr(b, e - b + 1);
}

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  std::istringstream is(s);
  std::string tok;
  while (is >> tok) out.push_back(tok);
  return out;
}

bool parse_mtl(const std::string& path, std::vector<std::string>* order,
               std::map<std::string, Material>* mats) {
  std::ifstream f(path);
  if (!f.is_open()) return false;
  std::string cur, line;
  while (std::getline(f, line)) {
    auto parts = split_ws(strip(line));
    if (parts.empty()) continue;
    const std::string& key = parts[0];
    if (key == "newmtl" && parts.size() >= 2) {
      cur = parts[1];
      (*mats)[cur] = Material();
      order->push_back(cur);
    } else if (!cur.empty() && parts.size() >= 4 &&
               (key == "Kd" || key == "Ke" || key == "Ks")) {
      float* dst = key == "Kd" ? (*mats)[cur].kd
                 : key == "Ke" ? (*mats)[cur].ke
                                : (*mats)[cur].ks;
      for (int i = 0; i < 3; ++i) dst[i] = std::stof(parts[1 + i]);
    } else if (!cur.empty() && parts.size() >= 2 && key == "Ns") {
      (*mats)[cur].ns = std::stof(parts[1]);
    } else if (!cur.empty() && parts.size() >= 2 && key == "Ni") {
      (*mats)[cur].ni = std::stof(parts[1]);
    } else if (!cur.empty() && parts.size() >= 2 && key == "illum") {
      (*mats)[cur].illum = std::stof(parts[1]);
    } else if (!cur.empty() && parts.size() >= 2 && key == "Pr") {
      (*mats)[cur].pr = std::stof(parts[1]);
    } else if (!cur.empty() && parts.size() >= 2 && key == "map_Kd") {
      std::string dir = ".";
      size_t slash = path.find_last_of("/\\");
      if (slash != std::string::npos) dir = path.substr(0, slash);
      (*mats)[cur].map_kd = dir + "/" + parts.back();
    }
  }
  return true;
}

int resolve_index(const std::string& tok, int nverts) {
  // 'v', 'v/vt', 'v//vn'; 1-based; negative = relative
  int i = std::stoi(tok.substr(0, tok.find('/')));
  return i < 0 ? nverts + i : i - 1;
}

int resolve_vt_index(const std::string& tok, int nvt) {
  // vt index from a face token, or -1 when absent ('v' or 'v//vn')
  size_t s1 = tok.find('/');
  if (s1 == std::string::npos) return -1;
  size_t s2 = tok.find('/', s1 + 1);
  std::string vt = s2 == std::string::npos
                       ? tok.substr(s1 + 1)
                       : tok.substr(s1 + 1, s2 - s1 - 1);
  if (vt.empty()) return -1;
  int i = std::stoi(vt);
  return i < 0 ? nvt + i : i - 1;
}

SceneData* load_obj_impl(const std::string& path, bool flip_y) {
  auto* out = new SceneData();
  std::ifstream f(path);
  if (!f.is_open()) {
    out->error = "cannot open " + path;
    return out;
  }
  std::string base = ".";
  size_t slash = path.find_last_of("/\\");
  if (slash != std::string::npos) base = path.substr(0, slash);

  std::vector<float> pos;  // packed xyz
  std::vector<float> vts;  // packed uv
  struct Tri { int a, b, c, mat; int ta, tb, tc; };
  std::vector<Tri> tris;
  std::vector<std::string> order;
  std::map<std::string, Material> mats;
  int cur_mat = -1;

  std::string line;
  while (std::getline(f, line)) {
    auto parts = split_ws(strip(line));
    if (parts.empty()) continue;
    const std::string& key = parts[0];
    if (key == "v" && parts.size() >= 4) {
      pos.push_back(std::stof(parts[1]));
      pos.push_back(std::stof(parts[2]));
      pos.push_back(std::stof(parts[3]));
    } else if (key == "vt" && parts.size() >= 2) {
      vts.push_back(std::stof(parts[1]));
      vts.push_back(parts.size() >= 3 ? std::stof(parts[2]) : 0.f);
    } else if (key == "f" && parts.size() >= 4) {
      int nv = static_cast<int>(pos.size() / 3);
      int nvt = static_cast<int>(vts.size() / 2);
      std::vector<int> idx, vti;
      for (size_t k = 1; k < parts.size(); ++k) {
        idx.push_back(resolve_index(parts[k], nv));
        vti.push_back(resolve_vt_index(parts[k], nvt));
      }
      for (size_t k = 0; k + 2 < idx.size(); ++k)
        tris.push_back({idx[0], idx[k + 1], idx[k + 2], cur_mat,
                        vti[0], vti[k + 1], vti[k + 2]});
    } else if (key == "usemtl" && parts.size() >= 2) {
      auto it = std::find(order.begin(), order.end(), parts[1]);
      cur_mat = it == order.end() ? -1
                                  : static_cast<int>(it - order.begin());
    } else if (key == "mtllib" && parts.size() >= 2) {
      parse_mtl(base + "/" + parts[1], &order, &mats);
    }
  }

  if (flip_y)
    for (size_t i = 1; i < pos.size(); i += 3) pos[i] = -pos[i];

  size_t t = tris.size();
  out->vertices.resize(9 * t);
  out->diffuse.assign(3 * t, 0.f);
  out->emission.assign(3 * t, 0.f);
  out->specular.assign(3 * t, 0.f);
  out->mat_type.assign(t, 0);
  out->rough.assign(t, 0.f);
  out->uvs.assign(6 * t, 0.f);
  out->face_tex.assign(t, -1);
  out->mat_id.resize(t);
  std::vector<std::string> tex_list;
  std::map<std::string, int> tex_index;
  for (size_t i = 0; i < t; ++i) {
    const int vs[3] = {tris[i].a, tris[i].b, tris[i].c};
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 3; ++a)
        out->vertices[9 * i + 3 * c + a] = pos[3 * vs[c] + a];
    const int ts3[3] = {tris[i].ta, tris[i].tb, tris[i].tc};
    bool has_uv = ts3[0] >= 0 && ts3[1] >= 0 && ts3[2] >= 0;
    if (has_uv)
      for (int c = 0; c < 3; ++c)
        for (int a = 0; a < 2; ++a)
          out->uvs[6 * i + 2 * c + a] = vts[2 * ts3[c] + a];
    out->mat_id[i] = tris[i].mat;
    if (tris[i].mat >= 0) {
      const Material& m = mats[order[tris[i].mat]];
      for (int a = 0; a < 3; ++a) {
        out->diffuse[3 * i + a] = m.kd[a];
        out->emission[3 * i + a] = m.ke[a];
        out->specular[3 * i + a] = m.ks[a];
      }
      bool ks_nonzero = m.ks[0] > 0 || m.ks[1] > 0 || m.ks[2] > 0;
      // illum>=4 + Ni>1 -> smooth dielectric (3), rough stores the
      // encoded IOR (Ni-1)/4, Ks tint (white when zero); PBR 'Pr'
      // roughness + Ks -> GGX glossy (2); classic illum>=3 -> perfect
      // mirror (1). Mirrors semantics in scene/objload.py.
      if (m.illum >= 4.f && m.ni > 1.f) {
        out->mat_type[i] = 3;
        float enc = (m.ni - 1.f) / 4.f;
        out->rough[i] = enc < 0.96f ? enc : 0.96f;
        if (!ks_nonzero)
          for (int a = 0; a < 3; ++a) out->specular[3 * i + a] = 1.f;
      } else if (m.pr > 0.f && ks_nonzero) {
        out->mat_type[i] = 2;
        out->rough[i] = m.pr < 1.f ? m.pr : 1.f;
      } else if (m.illum >= 3.f && ks_nonzero) {
        out->mat_type[i] = 1;
      }
      if (!m.map_kd.empty() && has_uv) {
        auto it = tex_index.find(m.map_kd);
        int ti;
        if (it == tex_index.end()) {
          ti = static_cast<int>(tex_list.size());
          tex_index[m.map_kd] = ti;
          tex_list.push_back(m.map_kd);
        } else {
          ti = it->second;
        }
        out->face_tex[i] = ti;
      }
    }
  }
  std::ostringstream names;
  for (size_t i = 0; i < order.size(); ++i) {
    if (i) names << "\n";
    names << order[i];
  }
  out->names = names.str();
  std::ostringstream texs;
  for (size_t i = 0; i < tex_list.size(); ++i) {
    if (i) texs << "\n";
    texs << tex_list[i];
  }
  out->tex_paths = texs.str();
  return out;
}

// ----------------------------------------------------------------------
// LBVH (identical topology to sfvp_tpu/accel/lbvh.py)
// ----------------------------------------------------------------------

uint32_t expand_bits(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

struct BvhData {
  std::vector<float> bmin, bmax;     // M*3
  std::vector<int32_t> skip, first, count;  // M
  std::vector<float> tv;             // 9 * Ts (column-major: 9 rows)
  std::vector<int32_t> prim_id;      // Ts
};

int split_position(const std::vector<uint32_t>& codes, int lo, int hi) {
  uint32_t first = codes[lo], last = codes[hi - 1];
  if (first == last) return (lo + hi) / 2;
  uint32_t diff = first ^ last;
  int split_bit = 31 - __builtin_clz(diff);
  uint32_t prefix = first & ~((1u << (split_bit + 1)) - 1u);
  uint32_t target = prefix | (1u << split_bit);
  auto it = std::lower_bound(codes.begin() + lo, codes.begin() + hi, target);
  int idx = static_cast<int>(it - codes.begin());
  if (idx <= lo || idx >= hi) idx = (lo + hi) / 2;
  return idx;
}

BvhData* build_lbvh_impl(const float* tris, int t, int leaf_size) {
  // per-tri AABBs + centroids
  std::vector<float> tmin(3 * t), tmax(3 * t), cent(3 * t);
  for (int i = 0; i < t; ++i) {
    for (int a = 0; a < 3; ++a) {
      float v0 = tris[9 * i + a], v1 = tris[9 * i + 3 + a],
            v2 = tris[9 * i + 6 + a];
      float lo = std::min(v0, std::min(v1, v2));
      float hi = std::max(v0, std::max(v1, v2));
      tmin[3 * i + a] = lo;
      tmax[3 * i + a] = hi;
      cent[3 * i + a] = 0.5f * (lo + hi);
    }
  }
  float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < t; ++i)
    for (int a = 0; a < 3; ++a) {
      clo[a] = std::min(clo[a], cent[3 * i + a]);
      chi[a] = std::max(chi[a], cent[3 * i + a]);
    }
  std::vector<uint32_t> codes(t);
  for (int i = 0; i < t; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      float ext = std::max(chi[a] - clo[a], 1e-9f);
      // match numpy: clip(((c - lo)/ext) * 1023, 0, 1023) truncated to u32
      float s = (cent[3 * i + a] - clo[a]) / ext * 1023.0f;
      s = std::min(std::max(s, 0.0f), 1023.0f);
      q[a] = static_cast<uint32_t>(s);
    }
    codes[i] = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
               expand_bits(q[2]);
  }
  std::vector<int32_t> order(t);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return codes[a] < codes[b]; });
  std::vector<uint32_t> codes_sorted(t);
  for (int i = 0; i < t; ++i) codes_sorted[i] = codes[order[i]];

  // DFS-order top-down build, same traversal as the Python builder
  struct Node { int lo, hi, left, right; };
  std::vector<Node> nodes;
  struct StackEntry { int lo, hi, parent, which; };
  std::vector<StackEntry> stack{{0, t, -1, 0}};
  while (!stack.empty()) {
    StackEntry e = stack.back();
    stack.pop_back();
    int idx = static_cast<int>(nodes.size());
    nodes.push_back({e.lo, e.hi, -1, -1});
    if (e.parent >= 0) {
      if (e.which == 0) nodes[e.parent].left = idx;
      else nodes[e.parent].right = idx;
    }
    if (e.hi - e.lo > leaf_size) {
      int mid = split_position(codes_sorted, e.lo, e.hi);
      stack.push_back({mid, e.hi, idx, 1});   // right pushed first
      stack.push_back({e.lo, mid, idx, 0});   // left emitted first (DFS)
    }
  }

  int m = static_cast<int>(nodes.size());
  auto* out = new BvhData();
  out->skip.resize(m);
  out->first.resize(m);
  out->count.resize(m);
  out->bmin.assign(3 * m, 0.f);
  out->bmax.assign(3 * m, 0.f);

  std::vector<int32_t> subtree_end(m);
  for (int i = m - 1; i >= 0; --i)
    subtree_end[i] = nodes[i].left < 0 ? i + 1 : subtree_end[nodes[i].right];

  for (int i = m - 1; i >= 0; --i) {
    bool leaf = nodes[i].left < 0;
    out->skip[i] = subtree_end[i];
    out->first[i] = leaf ? nodes[i].lo : -1;
    out->count[i] = leaf ? nodes[i].hi - nodes[i].lo : 0;
    if (leaf) {
      for (int a = 0; a < 3; ++a) {
        float lo = 1e30f, hi = -1e30f;
        for (int k = nodes[i].lo; k < nodes[i].hi; ++k) {
          lo = std::min(lo, tmin[3 * order[k] + a]);
          hi = std::max(hi, tmax[3 * order[k] + a]);
        }
        out->bmin[3 * i + a] = lo;
        out->bmax[3 * i + a] = hi;
      }
    } else {
      int l = nodes[i].left, r = nodes[i].right;
      for (int a = 0; a < 3; ++a) {
        out->bmin[3 * i + a] = std::min(out->bmin[3 * l + a], out->bmin[3 * r + a]);
        out->bmax[3 * i + a] = std::max(out->bmax[3 * l + a], out->bmax[3 * r + a]);
      }
    }
  }

  out->tv.resize(9 * t);
  out->prim_id.resize(t);
  for (int i = 0; i < t; ++i) {
    int src = order[i];
    out->prim_id[i] = src;
    // column-major layout: row r = corner*3+axis, matching lbvh.py's tv
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 3; ++a)
        out->tv[(3 * c + a) * t + i] = tris[9 * src + 3 * c + a];
  }
  return out;
}


// ----------------------------------------------------------------------
// Binned-SAH builder (identical output to sfvp_tpu/accel/sah.py: same
// float32 aggregates, float64 cost math, stable partitions)
// ----------------------------------------------------------------------

float half_area_f32(const float lo[3], const float hi[3]) {
  float d0 = std::max(hi[0] - lo[0], 0.0f);
  float d1 = std::max(hi[1] - lo[1], 0.0f);
  float d2 = std::max(hi[2] - lo[2], 0.0f);
  return d0 * d1 + d1 * d2 + d2 * d0;
}

BvhData* build_sah_impl(const float* tris, int t, int leaf_size,
                        int max_leaf) {
  constexpr int NB = 16;
  std::vector<float> tmin(3 * t), tmax(3 * t), cent(3 * t);
  for (int i = 0; i < t; ++i) {
    for (int a = 0; a < 3; ++a) {
      float v0 = tris[9 * i + a], v1 = tris[9 * i + 3 + a],
            v2 = tris[9 * i + 6 + a];
      float lo = std::min(v0, std::min(v1, v2));
      float hi = std::max(v0, std::max(v1, v2));
      tmin[3 * i + a] = lo;
      tmax[3 * i + a] = hi;
      cent[3 * i + a] = 0.5f * (lo + hi);
    }
  }

  std::vector<int64_t> order(t);
  std::iota(order.begin(), order.end(), 0);
  std::vector<int64_t> scratch(t);

  struct Node { int lo, hi, left, right; };
  std::vector<Node> nodes;
  struct StackEntry { int lo, hi, parent, which; };
  std::vector<StackEntry> stack{{0, t, -1, 0}};
  while (!stack.empty()) {
    StackEntry e = stack.back();
    stack.pop_back();
    int idx = static_cast<int>(nodes.size());
    nodes.push_back({e.lo, e.hi, -1, -1});
    if (e.parent >= 0) {
      if (e.which == 0) nodes[e.parent].left = idx;
      else nodes[e.parent].right = idx;
    }
    int n = e.hi - e.lo;
    if (n <= 1) continue;

    float cmin[3] = {1e30f, 1e30f, 1e30f};
    float cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int k = e.lo; k < e.hi; ++k)
      for (int a = 0; a < 3; ++a) {
        float c = cent[3 * order[k] + a];
        cmin[a] = std::min(cmin[a], c);
        cmax[a] = std::max(cmax[a], c);
      }
    float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
    int axis = 0;  // numpy argmax: first max wins
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 0.0f) {
      if (n <= max_leaf) continue;
      int mid = e.lo + n / 2;
      stack.push_back({mid, e.hi, idx, 1});
      stack.push_back({e.lo, mid, idx, 0});
      continue;
    }

    double scale = NB * (1.0 - 1e-6) / static_cast<double>(ext[axis]);
    int bin_cnt[NB] = {0};
    float bmin[NB][3], bmax[NB][3];
    for (int b = 0; b < NB; ++b)
      for (int a = 0; a < 3; ++a) {
        bmin[b][a] = 1e30f;
        bmax[b][a] = -1e30f;
      }
    std::vector<int8_t> bins(n);
    for (int k = 0; k < n; ++k) {
      int64_t id = order[e.lo + k];
      // numpy: ((c - cmin) * scale).astype(int32) truncates toward zero
      float dc = cent[3 * id + axis] - cmin[axis];
      int b = static_cast<int>(static_cast<double>(dc) * scale);
      b = std::min(std::max(b, 0), NB - 1);
      bins[k] = static_cast<int8_t>(b);
      bin_cnt[b] += 1;
      for (int a = 0; a < 3; ++a) {
        bmin[b][a] = std::min(bmin[b][a], tmin[3 * id + a]);
        bmax[b][a] = std::max(bmax[b][a], tmax[3 * id + a]);
      }
    }

    // left/right sweeps over the NB-1 split planes
    double best_cost = std::numeric_limits<double>::infinity();
    int best = -1;
    {
      float lmin[3] = {1e30f, 1e30f, 1e30f};
      float lmax[3] = {-1e30f, -1e30f, -1e30f};
      // suffix aggregates first
      float rmins[NB][3], rmaxs[NB][3];
      float smin[3] = {1e30f, 1e30f, 1e30f};
      float smax2[3] = {-1e30f, -1e30f, -1e30f};
      for (int b = NB - 1; b >= 1; --b) {
        for (int a = 0; a < 3; ++a) {
          smin[a] = std::min(smin[a], bmin[b][a]);
          smax2[a] = std::max(smax2[a], bmax[b][a]);
          rmins[b][a] = smin[a];
          rmaxs[b][a] = smax2[a];
        }
      }
      int64_t lcnt = 0;
      for (int b = 0; b < NB - 1; ++b) {
        lcnt += bin_cnt[b];
        int64_t rcnt = n - lcnt;
        for (int a = 0; a < 3; ++a) {
          lmin[a] = std::min(lmin[a], bmin[b][a]);
          lmax[a] = std::max(lmax[a], bmax[b][a]);
        }
        if (lcnt > 0 && rcnt > 0) {
          double c = static_cast<double>(half_area_f32(lmin, lmax)) * lcnt +
                     static_cast<double>(half_area_f32(rmins[b + 1],
                                                       rmaxs[b + 1])) * rcnt;
          if (c < best_cost) {  // numpy argmin: first minimum wins
            best_cost = c;
            best = b;
          }
        }
      }
    }

    double leaf_cost = static_cast<double>(n);
    float pmin[3] = {1e30f, 1e30f, 1e30f};
    float pmax2[3] = {-1e30f, -1e30f, -1e30f};
    for (int k = e.lo; k < e.hi; ++k)
      for (int a = 0; a < 3; ++a) {
        pmin[a] = std::min(pmin[a], tmin[3 * order[k] + a]);
        pmax2[a] = std::max(pmax2[a], tmax[3 * order[k] + a]);
      }
    float pa = half_area_f32(pmin, pmax2);
    double parent_area = pa > 1e-30f ? static_cast<double>(pa) : 1e-30;
    double split_cost = 1.0 + best_cost / parent_area;
    if (n <= max_leaf && (n <= leaf_size || split_cost >= leaf_cost)) continue;

    // stable partition (numpy concatenate keeps within-side order)
    int mid;
    int64_t nl = 0;
    for (int k = 0; k < n; ++k) nl += (best >= 0 && bins[k] <= best) ? 1 : 0;
    if (best < 0 || nl == 0 || nl == n) {
      // degenerate: stable sort by centroid on the split axis, median cut
      std::copy(order.begin() + e.lo, order.begin() + e.hi, scratch.begin());
      std::stable_sort(
          scratch.begin(), scratch.begin() + n,
          [&](int64_t x, int64_t y) {
            return cent[3 * x + axis] < cent[3 * y + axis];
          });
      std::copy(scratch.begin(), scratch.begin() + n, order.begin() + e.lo);
      mid = e.lo + n / 2;
    } else {
      int64_t* dst_l = scratch.data();
      int64_t* dst_r = scratch.data() + nl;
      for (int k = 0; k < n; ++k) {
        if (bins[k] <= best) *dst_l++ = order[e.lo + k];
        else *dst_r++ = order[e.lo + k];
      }
      std::copy(scratch.begin(), scratch.begin() + n, order.begin() + e.lo);
      mid = e.lo + static_cast<int>(nl);
    }
    stack.push_back({mid, e.hi, idx, 1});
    stack.push_back({e.lo, mid, idx, 0});
  }

  // flatten: identical to the LBVH path (skip links, AABBs, sorted tv)
  int m = static_cast<int>(nodes.size());
  auto* out = new BvhData();
  out->skip.resize(m);
  out->first.resize(m);
  out->count.resize(m);
  out->bmin.assign(3 * m, 0.f);
  out->bmax.assign(3 * m, 0.f);
  std::vector<int32_t> subtree_end(m);
  for (int i = m - 1; i >= 0; --i)
    subtree_end[i] = nodes[i].left < 0 ? i + 1 : subtree_end[nodes[i].right];
  for (int i = m - 1; i >= 0; --i) {
    bool leaf = nodes[i].left < 0;
    out->skip[i] = subtree_end[i];
    out->first[i] = leaf ? nodes[i].lo : -1;
    out->count[i] = leaf ? nodes[i].hi - nodes[i].lo : 0;
    if (leaf) {
      for (int a = 0; a < 3; ++a) {
        float lo = 1e30f, hi = -1e30f;
        for (int k = nodes[i].lo; k < nodes[i].hi; ++k) {
          lo = std::min(lo, tmin[3 * order[k] + a]);
          hi = std::max(hi, tmax[3 * order[k] + a]);
        }
        out->bmin[3 * i + a] = lo;
        out->bmax[3 * i + a] = hi;
      }
    } else {
      int l = nodes[i].left, r = nodes[i].right;
      for (int a = 0; a < 3; ++a) {
        out->bmin[3 * i + a] =
            std::min(out->bmin[3 * l + a], out->bmin[3 * r + a]);
        out->bmax[3 * i + a] =
            std::max(out->bmax[3 * l + a], out->bmax[3 * r + a]);
      }
    }
  }
  out->tv.resize(9 * static_cast<size_t>(t));
  out->prim_id.resize(t);
  for (int i = 0; i < t; ++i) {
    int src = static_cast<int>(order[i]);
    out->prim_id[i] = src;
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 3; ++a)
        out->tv[(3 * c + a) * static_cast<size_t>(t) + i] =
            tris[9 * src + 3 * c + a];
  }
  return out;
}

}  // namespace

extern "C" {

// ---------------- scene loader ----------------
void* sfvp_load_obj(const char* path, int flip_y) {
  // exceptions must not cross the C ABI (malformed numeric tokens throw
  // from std::stof/std::stoi) — convert to an error string instead
  try {
    return load_obj_impl(path, flip_y != 0);
  } catch (const std::exception& e) {
    auto* out = new SceneData();
    out->error = std::string("parse error: ") + e.what();
    return out;
  }
}
const char* sfvp_scene_error(void* h) {
  return static_cast<SceneData*>(h)->error.c_str();
}
int sfvp_scene_num_tris(void* h) {
  return static_cast<int>(static_cast<SceneData*>(h)->mat_id.size());
}
const char* sfvp_scene_material_names(void* h) {
  return static_cast<SceneData*>(h)->names.c_str();
}
void sfvp_scene_fill(void* h, float* vertices, float* diffuse,
                     float* emission, float* specular, int32_t* mat_type,
                     int32_t* mat_id) {
  auto* s = static_cast<SceneData*>(h);
  std::memcpy(vertices, s->vertices.data(), s->vertices.size() * 4);
  std::memcpy(diffuse, s->diffuse.data(), s->diffuse.size() * 4);
  std::memcpy(emission, s->emission.data(), s->emission.size() * 4);
  std::memcpy(specular, s->specular.data(), s->specular.size() * 4);
  std::memcpy(mat_type, s->mat_type.data(), s->mat_type.size() * 4);
  std::memcpy(mat_id, s->mat_id.data(), s->mat_id.size() * 4);
}
void sfvp_scene_fill_rough(void* h, float* rough) {
  auto* s = static_cast<SceneData*>(h);
  std::memcpy(rough, s->rough.data(), s->rough.size() * 4);
}
void sfvp_scene_fill_uv(void* h, float* uv, int32_t* face_tex) {
  auto* s = static_cast<SceneData*>(h);
  std::memcpy(uv, s->uvs.data(), s->uvs.size() * 4);
  std::memcpy(face_tex, s->face_tex.data(), s->face_tex.size() * 4);
}
const char* sfvp_scene_texture_paths(void* h) {
  return static_cast<SceneData*>(h)->tex_paths.c_str();
}
void sfvp_scene_free(void* h) { delete static_cast<SceneData*>(h); }

// ---------------- LBVH builder ----------------
void* sfvp_build_lbvh(const float* tris, int num_tris, int leaf_size) {
  return build_lbvh_impl(tris, num_tris, leaf_size);
}

void* sfvp_build_sah(const float* tris, int num_tris, int leaf_size,
                     int max_leaf) {
  return build_sah_impl(tris, num_tris, leaf_size, max_leaf);
}

// Topology-only emission from pre-sorted morton codes (the sequential step
// of the on-device build path — codes/sort/bounds run on the accelerator).
// Returns the node count; fills caller buffers sized >= 2*ceil(t/leaf)-1
// ... callers should allocate 2*t (safe upper bound).
int sfvp_emit_topology(const uint32_t* codes_sorted, int t, int leaf_size,
                       int32_t* skip, int32_t* first, int32_t* count) {
  std::vector<uint32_t> codes(codes_sorted, codes_sorted + t);
  struct Node { int lo, hi, left, right; };
  std::vector<Node> nodes;
  struct StackEntry { int lo, hi, parent, which; };
  std::vector<StackEntry> stack{{0, t, -1, 0}};
  while (!stack.empty()) {
    StackEntry e = stack.back();
    stack.pop_back();
    int idx = static_cast<int>(nodes.size());
    nodes.push_back({e.lo, e.hi, -1, -1});
    if (e.parent >= 0) {
      if (e.which == 0) nodes[e.parent].left = idx;
      else nodes[e.parent].right = idx;
    }
    if (e.hi - e.lo > leaf_size) {
      int mid = split_position(codes, e.lo, e.hi);
      stack.push_back({mid, e.hi, idx, 1});
      stack.push_back({e.lo, mid, idx, 0});
    }
  }
  int m = static_cast<int>(nodes.size());
  std::vector<int32_t> subtree_end(m);
  for (int i = m - 1; i >= 0; --i)
    subtree_end[i] = nodes[i].left < 0 ? i + 1 : subtree_end[nodes[i].right];
  for (int i = 0; i < m; ++i) {
    bool leaf = nodes[i].left < 0;
    skip[i] = subtree_end[i];
    first[i] = leaf ? nodes[i].lo : -1;
    count[i] = leaf ? nodes[i].hi - nodes[i].lo : 0;
  }
  return m;
}
int sfvp_bvh_num_nodes(void* h) {
  return static_cast<int>(static_cast<BvhData*>(h)->skip.size());
}
void sfvp_bvh_fill(void* h, float* bmin, float* bmax, int32_t* skip,
                   int32_t* first, int32_t* count, float* tv,
                   int32_t* prim_id) {
  auto* b = static_cast<BvhData*>(h);
  std::memcpy(bmin, b->bmin.data(), b->bmin.size() * 4);
  std::memcpy(bmax, b->bmax.data(), b->bmax.size() * 4);
  std::memcpy(skip, b->skip.data(), b->skip.size() * 4);
  std::memcpy(first, b->first.data(), b->first.size() * 4);
  std::memcpy(count, b->count.data(), b->count.size() * 4);
  std::memcpy(tv, b->tv.data(), b->tv.size() * 4);
  std::memcpy(prim_id, b->prim_id.data(), b->prim_id.size() * 4);
}
void sfvp_bvh_free(void* h) { delete static_cast<BvhData*>(h); }

}  // extern "C"
