// Native OBJ/MTL loader: the C++ runtime component of the asset pipeline.
//
// Fills the role tinyobjloader fills for the reference
// (src/asset/ObjLoader.cpp:52-272) with the same observable semantics:
//   - fan triangulation of polygon faces;
//   - unshared vertices (3 per face corner, no dedup);
//   - face-normal fallback when a corner has no normal index;
//   - optional V flip (default on);
//   - triangles partitioned into contiguous per-material ranges in
//     first-seen material order;
//   - MTL parsing limited to Kd / map_Kd (ResourceManager.cpp:240-259).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image); the
// Python loader in scene/obj_loader.py remains the semantics-defining
// reference and the fallback when the shared library is absent.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Float3 {
  float x, y, z;
};
struct Float2 {
  float u, v;
};

struct Corner {
  int v, t, n;  // 0-based resolved indices, -1 = absent
};

struct MtlMaterial {
  std::string name;
  float kd[3] = {1.f, 1.f, 1.f};
  std::string map_kd;  // absolute-ish path (joined with MTL dir)
};

std::string DirName(const std::string& path) {
  size_t p = path.find_last_of("/\\");
  return p == std::string::npos ? std::string(".") : path.substr(0, p);
}

bool ParseMtl(const std::string& path,
              std::unordered_map<std::string, MtlMaterial>* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::string base = DirName(path);
  char line[2048];
  MtlMaterial* cur = nullptr;
  while (std::fgets(line, sizeof line, f)) {
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (std::strncmp(s, "newmtl", 6) == 0 && std::isspace(s[6])) {
      char name[1024] = {0};
      if (std::sscanf(s + 6, " %1023s", name) == 1) {
        cur = &(*out)[name];
        cur->name = name;
      }
    } else if (cur && s[0] == 'K' && s[1] == 'd' && std::isspace(s[2])) {
      std::sscanf(s + 2, " %f %f %f", &cur->kd[0], &cur->kd[1], &cur->kd[2]);
    } else if (cur && std::strncmp(s, "map_Kd", 6) == 0 && std::isspace(s[6])) {
      char tex[1024] = {0};
      if (std::sscanf(s + 6, " %1023[^\r\n]", tex) == 1) {
        // trim trailing whitespace
        size_t len = std::strlen(tex);
        while (len && std::isspace(static_cast<unsigned char>(tex[len - 1])))
          tex[--len] = 0;
        std::string t(tex);
        cur->map_kd = (t.size() && (t[0] == '/' || (t.size() > 1 && t[1] == ':')))
                          ? t
                          : base + "/" + t;
      }
    }
  }
  std::fclose(f);
  return true;
}

int Resolve(int idx, int count) {
  if (idx > 0) return idx - 1;
  if (idx < 0) return count + idx;
  return -1;
}

}  // namespace

extern "C" {

struct BangSubmesh {
  int32_t start_index;
  int32_t index_count;
  int32_t material_index;
};

struct BangMaterialOut {
  float kd[3];
  char name[256];
  char map_kd[1024];
};

struct BangMesh {
  int32_t num_vertices;  // unshared corners (== 3 * num_triangles)
  float* positions;      // [V*3]
  float* normals;        // [V*3]
  float* uvs;            // [V*2]
  int32_t num_submeshes;
  BangSubmesh* submeshes;
  int32_t num_materials;
  BangMaterialOut* materials;
};

void bang_free_mesh(BangMesh* m) {
  if (!m) return;
  std::free(m->positions);
  std::free(m->normals);
  std::free(m->uvs);
  std::free(m->submeshes);
  std::free(m->materials);
  std::free(m);
}

BangMesh* bang_load_obj(const char* obj_path, const char* mtl_path,
                        int flip_v) {
  FILE* f = std::fopen(obj_path, "rb");
  if (!f) return nullptr;

  std::vector<Float3> vs, vns;
  std::vector<Float2> vts;
  struct Face {
    Corner c[3];
    int mat;
  };
  std::vector<Face> faces;
  std::vector<std::string> mat_order;
  std::unordered_map<std::string, int> mat_index;
  std::vector<std::string> mtllibs;
  int cur_mat = -1;

  char line[8192];
  while (std::fgets(line, sizeof line, f)) {
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && std::isspace(s[1])) {
      Float3 p{0, 0, 0};
      std::sscanf(s + 1, " %f %f %f", &p.x, &p.y, &p.z);
      vs.push_back(p);
    } else if (s[0] == 'v' && s[1] == 't' && std::isspace(s[2])) {
      Float2 t{0, 0};
      std::sscanf(s + 2, " %f %f", &t.u, &t.v);
      vts.push_back(t);
    } else if (s[0] == 'v' && s[1] == 'n' && std::isspace(s[2])) {
      Float3 p{0, 0, 0};
      std::sscanf(s + 2, " %f %f %f", &p.x, &p.y, &p.z);
      vns.push_back(p);
    } else if (std::strncmp(s, "usemtl", 6) == 0 && std::isspace(s[6])) {
      char name[1024] = {0};
      std::sscanf(s + 6, " %1023s", name);
      auto it = mat_index.find(name);
      if (it == mat_index.end()) {
        mat_index[name] = static_cast<int>(mat_order.size());
        mat_order.push_back(name);
      }
      cur_mat = mat_index[name];
    } else if (std::strncmp(s, "mtllib", 6) == 0 && std::isspace(s[6])) {
      char lib[1024] = {0};
      if (std::sscanf(s + 6, " %1023[^\r\n]", lib) == 1) {
        size_t len = std::strlen(lib);
        while (len && std::isspace(static_cast<unsigned char>(lib[len - 1])))
          lib[--len] = 0;
        mtllibs.push_back(lib);
      }
    } else if (s[0] == 'f' && std::isspace(s[1])) {
      // collect corners, fan-triangulate
      std::vector<Corner> corners;
      char* p = s + 1;
      while (*p) {
        while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (!*p) break;
        int vi = 0, ti = 0, ni = 0;
        // formats: v, v/t, v//n, v/t/n
        char tok[256] = {0};
        int k = 0;
        while (*p && !std::isspace(static_cast<unsigned char>(*p)) &&
               k < 255)
          tok[k++] = *p++;
        tok[k] = 0;
        char* slash1 = std::strchr(tok, '/');
        if (!slash1) {
          vi = std::atoi(tok);
        } else {
          *slash1 = 0;
          vi = std::atoi(tok);
          char* rest = slash1 + 1;
          char* slash2 = std::strchr(rest, '/');
          if (!slash2) {
            ti = std::atoi(rest);
          } else {
            *slash2 = 0;
            if (*rest) ti = std::atoi(rest);
            ni = std::atoi(slash2 + 1);
          }
        }
        corners.push_back({Resolve(vi, (int)vs.size()),
                           Resolve(ti, (int)vts.size()),
                           Resolve(ni, (int)vns.size())});
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        faces.push_back({{corners[0], corners[k], corners[k + 1]}, cur_mat});
      }
    }
  }
  std::fclose(f);

  // materials
  std::unordered_map<std::string, MtlMaterial> mtl_map;
  std::string mtl_file = mtl_path ? mtl_path : "";
  if (mtl_file.empty() && !mtllibs.empty())
    mtl_file = DirName(obj_path) + "/" + mtllibs[0];
  if (!mtl_file.empty()) ParseMtl(mtl_file, &mtl_map);

  // partition per material, first-seen order; unmatched (-1) last
  bool has_unmatched = false;
  for (auto& fc : faces)
    if (fc.mat < 0) has_unmatched = true;
  std::vector<int> order;
  for (int i = 0; i < (int)mat_order.size(); ++i) order.push_back(i);
  if (has_unmatched) order.push_back(-1);

  int total = (int)faces.size() * 3;
  auto* mesh = (BangMesh*)std::calloc(1, sizeof(BangMesh));
  mesh->num_vertices = total;
  mesh->positions = (float*)std::malloc(sizeof(float) * total * 3);
  mesh->normals = (float*)std::malloc(sizeof(float) * total * 3);
  mesh->uvs = (float*)std::malloc(sizeof(float) * total * 2);
  mesh->submeshes =
      (BangSubmesh*)std::calloc(order.size() ? order.size() : 1,
                                sizeof(BangSubmesh));
  mesh->materials = (BangMaterialOut*)std::calloc(
      mat_order.size() ? mat_order.size() : 1, sizeof(BangMaterialOut));

  int cursor = 0, sub_count = 0;
  for (int mat : order) {
    int start = cursor;
    for (auto& fc : faces) {
      if (fc.mat != mat) continue;
      // face normal fallback
      const Float3& a = vs[fc.c[0].v];
      const Float3& b = vs[fc.c[1].v];
      const Float3& c = vs[fc.c[2].v];
      float e1x = b.x - a.x, e1y = b.y - a.y, e1z = b.z - a.z;
      float e2x = c.x - a.x, e2y = c.y - a.y, e2z = c.z - a.z;
      float nx = e1y * e2z - e1z * e2y;
      float ny = e1z * e2x - e1x * e2z;
      float nz = e1x * e2y - e1y * e2x;
      float nl = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (nl > 1e-12f) {
        nx /= nl;
        ny /= nl;
        nz /= nl;
      } else {
        nx = 0;
        ny = 1;
        nz = 0;
      }
      for (int k = 0; k < 3; ++k) {
        const Corner& cr = fc.c[k];
        const Float3& p = vs[cr.v];
        mesh->positions[cursor * 3 + 0] = p.x;
        mesh->positions[cursor * 3 + 1] = p.y;
        mesh->positions[cursor * 3 + 2] = p.z;
        if (cr.n >= 0 && cr.n < (int)vns.size()) {
          mesh->normals[cursor * 3 + 0] = vns[cr.n].x;
          mesh->normals[cursor * 3 + 1] = vns[cr.n].y;
          mesh->normals[cursor * 3 + 2] = vns[cr.n].z;
        } else {
          mesh->normals[cursor * 3 + 0] = nx;
          mesh->normals[cursor * 3 + 1] = ny;
          mesh->normals[cursor * 3 + 2] = nz;
        }
        if (cr.t >= 0 && cr.t < (int)vts.size()) {
          mesh->uvs[cursor * 2 + 0] = vts[cr.t].u;
          mesh->uvs[cursor * 2 + 1] =
              flip_v ? 1.0f - vts[cr.t].v : vts[cr.t].v;
        } else {
          mesh->uvs[cursor * 2 + 0] = 0.f;
          mesh->uvs[cursor * 2 + 1] = 0.f;
        }
        ++cursor;
      }
    }
    int count = cursor - start;
    if (count > 0) {
      mesh->submeshes[sub_count].start_index = start;
      mesh->submeshes[sub_count].index_count = count;
      mesh->submeshes[sub_count].material_index = mat;
      ++sub_count;
    }
  }
  mesh->num_submeshes = sub_count;

  mesh->num_materials = (int)mat_order.size();
  for (int i = 0; i < (int)mat_order.size(); ++i) {
    BangMaterialOut& mo = mesh->materials[i];
    std::snprintf(mo.name, sizeof mo.name, "%s", mat_order[i].c_str());
    auto it = mtl_map.find(mat_order[i]);
    if (it != mtl_map.end()) {
      mo.kd[0] = it->second.kd[0];
      mo.kd[1] = it->second.kd[1];
      mo.kd[2] = it->second.kd[2];
      std::snprintf(mo.map_kd, sizeof mo.map_kd, "%s",
                    it->second.map_kd.c_str());
    } else {
      mo.kd[0] = mo.kd[1] = mo.kd[2] = 1.f;
      mo.map_kd[0] = 0;
    }
  }
  return mesh;
}

}  // extern "C"
