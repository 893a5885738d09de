// Native PLY reader/writer + threaded batch loader.
//
// TPU-native counterpart of the reference's C runtime IO (rply —
// code/3rd_party/rply/rply.c — driven by code/PLADE/ply_reader.cpp). The
// reference funnels every value through per-property C callbacks; here the
// dominant format (binary little-endian, fixed-stride vertex records — all
// bundled sample data and RESSO scans) is parsed as one mmap + strided copy,
// and a pthread pool preloads whole batches of pairs so host IO overlaps
// device compute in batch mode (main.cpp:97-158 loads serially).
//
// C ABI, consumed via ctypes from plade_tpu_torch/io/native.py.  A copy of
// plade_tpu/native/ply_io.cpp, so that the port builds its own library.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Prop {
  std::string name;
  int size = 0;      // bytes; 0 for list (unsupported in vertex)
  char kind = 0;     // 'f' float, 'd' double, 'i' int, 'u' uint
  bool is_list = false;
  int list_count_size = 0, list_item_size = 0;
};

struct Element {
  std::string name;
  long count = 0;
  std::vector<Prop> props;
};

int type_size(const std::string& t, char* kind) {
  if (t == "char" || t == "int8") { *kind = 'i'; return 1; }
  if (t == "uchar" || t == "uint8") { *kind = 'u'; return 1; }
  if (t == "short" || t == "int16") { *kind = 'i'; return 2; }
  if (t == "ushort" || t == "uint16") { *kind = 'u'; return 2; }
  if (t == "int" || t == "int32") { *kind = 'i'; return 4; }
  if (t == "uint" || t == "uint32") { *kind = 'u'; return 4; }
  if (t == "float" || t == "float32") { *kind = 'f'; return 4; }
  if (t == "double" || t == "float64") { *kind = 'd'; return 8; }
  *kind = 0;
  return -1;
}

double read_scalar(const uint8_t* p, const Prop& pr, bool big_endian) {
  uint8_t buf[8];
  if (big_endian) {
    for (int i = 0; i < pr.size; ++i) buf[i] = p[pr.size - 1 - i];
    p = buf;
  }
  switch (pr.kind) {
    case 'f': { float v; memcpy(&v, p, 4); return v; }
    case 'd': { double v; memcpy(&v, p, 8); return v; }
    case 'i': {
      int64_t v = 0;
      memcpy(&v, p, pr.size);
      // sign-extend
      int shift = 64 - 8 * pr.size;
      return double((v << shift) >> shift);
    }
    default: {
      uint64_t v = 0;
      memcpy(&v, p, pr.size);
      return double(v);
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. points/normals are malloc'd float32 arrays owned by
// the caller (free via plade_free). *has_normals is 0/1.
int plade_ply_read(const char* path, float** points, float** normals,
                   long* num_points, int* has_normals, char* err,
                   int err_len) {
#define FAIL(msg)                          \
  do {                                     \
    snprintf(err, err_len, "%s", msg);     \
    if (fd >= 0) close(fd);                \
    if (map != MAP_FAILED && map) munmap(map, fsize); \
    return -1;                             \
  } while (0)

  int fd = -1;
  void* map = nullptr;
  size_t fsize = 0;
  fd = open(path, O_RDONLY);
  if (fd < 0) { map = MAP_FAILED; FAIL("cannot open file"); }
  struct stat st;
  if (fstat(fd, &st) != 0) { map = MAP_FAILED; FAIL("stat failed"); }
  fsize = size_t(st.st_size);
  map = mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) FAIL("mmap failed");
  const char* data = static_cast<const char*>(map);

  // ---- header ----
  const char* end = data + fsize;
  const char* p = data;
  auto next_line = [&](std::string* line) -> bool {
    if (p >= end) return false;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) nl = end;
    line->assign(p, nl - p);
    while (!line->empty() &&
           (line->back() == '\r' || line->back() == ' '))
      line->pop_back();
    p = nl + 1;
    return true;
  };

  std::string line;
  if (!next_line(&line) || line != "ply") FAIL("not a ply file");
  std::string fmt;
  std::vector<Element> elements;
  while (next_line(&line)) {
    if (line == "end_header") break;
    char a[64] = {0}, b[64] = {0}, c[64] = {0}, d[64] = {0}, e[64] = {0};
    sscanf(line.c_str(), "%63s %63s %63s %63s %63s", a, b, c, d, e);
    if (!strcmp(a, "format")) {
      fmt = b;
    } else if (!strcmp(a, "element")) {
      Element el;
      el.name = b;
      el.count = atol(c);
      elements.push_back(el);
    } else if (!strcmp(a, "property")) {
      if (elements.empty()) FAIL("property before element");
      Prop pr;
      if (!strcmp(b, "list")) {
        pr.is_list = true;
        char k;
        pr.list_count_size = type_size(c, &k);
        pr.list_item_size = type_size(d, &k);
        pr.name = e;
        if (pr.list_count_size < 0 || pr.list_item_size < 0)
          FAIL("unknown list property type");
      } else {
        pr.size = type_size(b, &pr.kind);
        pr.name = c;
        if (pr.size < 0) FAIL("unknown property type");
      }
      elements.back().props.push_back(pr);
    }
  }
  if (fmt.empty()) FAIL("no format line");
  bool ascii = fmt == "ascii";
  bool big_endian = fmt == "binary_big_endian";

  // ---- locate vertex element ----
  const Element* vertex = nullptr;
  size_t offset = p - data;  // byte offset where body starts (binary)
  for (const auto& el : elements) {
    if (el.name == "vertex") { vertex = &el; break; }
    if (ascii) FAIL("ascii: vertex must be the first element");
    // skip prior binary element (lists unsupported in skipped elements)
    long stride = 0;
    for (const auto& pr : el.props) {
      if (pr.is_list) FAIL("list property before vertex element");
      stride += pr.size;
    }
    offset += size_t(stride) * el.count;
  }
  if (!vertex) FAIL("no vertex element");
  long n = vertex->count;

  int xi = -1, yi = -1, zi = -1, nxi = -1, nyi = -1, nzi = -1;
  long stride = 0;
  std::vector<long> prop_off(vertex->props.size());
  for (size_t i = 0; i < vertex->props.size(); ++i) {
    const Prop& pr = vertex->props[i];
    if (pr.is_list) FAIL("list property in vertex element");
    prop_off[i] = stride;
    stride += pr.size;
    if (pr.name == "x") xi = int(i);
    else if (pr.name == "y") yi = int(i);
    else if (pr.name == "z") zi = int(i);
    else if (pr.name == "nx") nxi = int(i);
    else if (pr.name == "ny") nyi = int(i);
    else if (pr.name == "nz") nzi = int(i);
  }
  if (xi < 0 || yi < 0 || zi < 0) FAIL("vertex lacks x/y/z");
  bool with_normals = nxi >= 0 && nyi >= 0 && nzi >= 0;

  float* pts = static_cast<float*>(malloc(sizeof(float) * 3 * n));
  float* nrm = with_normals
                   ? static_cast<float*>(malloc(sizeof(float) * 3 * n))
                   : nullptr;
  if (!pts || (with_normals && !nrm)) FAIL("out of memory");

  if (ascii) {
    const char* q = data + offset;
    for (long i = 0; i < n; ++i) {
      double vals[64];
      size_t np = vertex->props.size();
      for (size_t j = 0; j < np && j < 64; ++j) {
        char* endp = nullptr;
        vals[j] = strtod(q, &endp);
        if (endp == q) { free(pts); if (nrm) free(nrm); FAIL("ascii parse error"); }
        q = endp;
      }
      pts[3 * i] = float(vals[xi]);
      pts[3 * i + 1] = float(vals[yi]);
      pts[3 * i + 2] = float(vals[zi]);
      if (with_normals) {
        nrm[3 * i] = float(vals[nxi]);
        nrm[3 * i + 1] = float(vals[nyi]);
        nrm[3 * i + 2] = float(vals[nzi]);
      }
    }
  } else {
    if (offset + size_t(stride) * n > fsize) {
      free(pts); if (nrm) free(nrm);
      FAIL("truncated vertex data");
    }
    const uint8_t* base = reinterpret_cast<const uint8_t*>(data) + offset;
    const Prop& px = vertex->props[xi];
    const Prop& py = vertex->props[yi];
    const Prop& pz = vertex->props[zi];
    // fast path: all-float little-endian (the dominant layout)
    bool fast = !big_endian && px.kind == 'f' && py.kind == 'f' &&
                pz.kind == 'f' &&
                (!with_normals || (vertex->props[nxi].kind == 'f' &&
                                   vertex->props[nyi].kind == 'f' &&
                                   vertex->props[nzi].kind == 'f'));
    if (fast) {
      long ox = prop_off[xi], oy = prop_off[yi], oz = prop_off[zi];
      long onx = with_normals ? prop_off[nxi] : 0;
      long ony = with_normals ? prop_off[nyi] : 0;
      long onz = with_normals ? prop_off[nzi] : 0;
      for (long i = 0; i < n; ++i) {
        const uint8_t* r = base + i * stride;
        memcpy(&pts[3 * i], r + ox, 4);
        memcpy(&pts[3 * i + 1], r + oy, 4);
        memcpy(&pts[3 * i + 2], r + oz, 4);
        if (with_normals) {
          memcpy(&nrm[3 * i], r + onx, 4);
          memcpy(&nrm[3 * i + 1], r + ony, 4);
          memcpy(&nrm[3 * i + 2], r + onz, 4);
        }
      }
    } else {
      for (long i = 0; i < n; ++i) {
        const uint8_t* r = base + i * stride;
        pts[3 * i] = float(read_scalar(r + prop_off[xi], px, big_endian));
        pts[3 * i + 1] = float(read_scalar(r + prop_off[yi], py, big_endian));
        pts[3 * i + 2] = float(read_scalar(r + prop_off[zi], pz, big_endian));
        if (with_normals) {
          nrm[3 * i] = float(read_scalar(r + prop_off[nxi],
                                         vertex->props[nxi], big_endian));
          nrm[3 * i + 1] = float(read_scalar(r + prop_off[nyi],
                                             vertex->props[nyi], big_endian));
          nrm[3 * i + 2] = float(read_scalar(r + prop_off[nzi],
                                             vertex->props[nzi], big_endian));
        }
      }
    }
  }

  munmap(map, fsize);
  close(fd);
  *points = pts;
  *normals = nrm;
  *num_points = n;
  *has_normals = with_normals ? 1 : 0;
  return 0;
#undef FAIL
}

int plade_ply_write(const char* path, const float* points,
                    const float* normals, long n, int binary, char* err,
                    int err_len) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    snprintf(err, err_len, "cannot open %s", path);
    return -1;
  }
  fprintf(f, "ply\nformat %s 1.0\nelement vertex %ld\n"
             "property float x\nproperty float y\nproperty float z\n",
          binary ? "binary_little_endian" : "ascii", n);
  if (normals)
    fprintf(f, "property float nx\nproperty float ny\nproperty float nz\n");
  fprintf(f, "end_header\n");
  if (binary) {
    if (normals) {
      std::vector<float> row(6);
      for (long i = 0; i < n; ++i) {
        memcpy(row.data(), &points[3 * i], 12);
        memcpy(row.data() + 3, &normals[3 * i], 12);
        fwrite(row.data(), 4, 6, f);
      }
    } else {
      fwrite(points, 4, size_t(3) * n, f);
    }
  } else {
    for (long i = 0; i < n; ++i) {
      if (normals)
        fprintf(f, "%.8g %.8g %.8g %.8g %.8g %.8g\n", points[3 * i],
                points[3 * i + 1], points[3 * i + 2], normals[3 * i],
                normals[3 * i + 1], normals[3 * i + 2]);
      else
        fprintf(f, "%.8g %.8g %.8g\n", points[3 * i], points[3 * i + 1],
                points[3 * i + 2]);
    }
  }
  fclose(f);
  return 0;
}

// Threaded batch read: n files in parallel. Results arrays are per-file;
// status[i] != 0 marks failure (err strings not kept per-file).
int plade_ply_read_batch(const char** paths, int n_files, int n_threads,
                         float** points_out, float** normals_out,
                         long* counts_out, int* has_normals_out,
                         int* status_out) {
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads > n_files) n_threads = n_files;
  std::vector<std::thread> workers;
  std::vector<int> next(1, 0);
  // simple strided partition; files are similar sizes in practice
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      char err[256];
      for (int i = t; i < n_files; i += n_threads) {
        status_out[i] = plade_ply_read(paths[i], &points_out[i],
                                       &normals_out[i], &counts_out[i],
                                       &has_normals_out[i], err, sizeof(err));
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

void plade_free(void* p) { free(p); }

}  // extern "C"
