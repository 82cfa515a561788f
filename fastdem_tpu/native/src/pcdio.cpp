// fastdem_tpu native IO: fast PCD / KITTI-bin parsing and writing.
//
// Native-code counterpart of the reference's C++ IO layer
// (/root/reference/fastdem/lib/nanoPCL/include/nanopcl/io/pcd_io.hpp,
// bin_io.hpp). The framework keeps compute in XLA; file parsing is
// host work where Python costs 10-100x, so it lives here behind a ctypes
// ABI (plain C structs + malloc'd buffers, no Python headers needed).
//
// Build: g++ -O3 -march=native -shared -fPIC pcdio.cpp -o libfastdem_io.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct CloudBuffers {
  // malloc'd; caller frees via fastdem_free. Null when absent.
  float* xyz;        // [n * 3]
  float* intensity;  // [n]
  uint8_t* rgb;      // [n * 3]
  float* time;       // [n]
  int32_t* ring;     // [n]
  float* normal;     // [n * 3]
  int64_t n;
  int32_t error;  // 0 ok; 1 open; 2 header; 3 data
  // Preserved header VIEWPOINT (tx ty tz qw qx qy qz), like nanoPCL's
  // PCDMetadata (io/pcd_io.hpp:52-57). Identity when absent.
  float viewpoint[7];
};

void fastdem_free(void* p) { std::free(p); }

void fastdem_free_cloud(CloudBuffers* c) {
  if (!c) return;
  std::free(c->xyz);
  std::free(c->intensity);
  std::free(c->rgb);
  std::free(c->time);
  std::free(c->ring);
  std::free(c->normal);
  c->xyz = nullptr;
  c->intensity = nullptr;
  c->rgb = nullptr;
  c->time = nullptr;
  c->ring = nullptr;
  c->normal = nullptr;
  c->n = 0;
}

namespace {

struct Field {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
  int offset = 0;  // byte offset within a record
};

bool read_line(FILE* f, std::string& out) {
  out.clear();
  int ch;
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == '\n') return true;
    out.push_back(static_cast<char>(ch));
  }
  return !out.empty();
}

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && std::isspace(static_cast<unsigned char>(s[i]))) ++i;
    size_t j = i;
    while (j < s.size() && !std::isspace(static_cast<unsigned char>(s[j]))) ++j;
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

float field_as_float(const uint8_t* rec, const Field& f) {
  switch (f.type) {
    case 'F':
      if (f.size == 4) {
        float v;
        std::memcpy(&v, rec + f.offset, 4);
        return v;
      } else {
        double v;
        std::memcpy(&v, rec + f.offset, 8);
        return static_cast<float>(v);
      }
    case 'U': {
      uint32_t v = 0;
      std::memcpy(&v, rec + f.offset, f.size);
      return static_cast<float>(v);
    }
    case 'I': {
      int32_t v = 0;
      if (f.size == 1) {
        int8_t t;
        std::memcpy(&t, rec + f.offset, 1);
        v = t;
      } else if (f.size == 2) {
        int16_t t;
        std::memcpy(&t, rec + f.offset, 2);
        v = t;
      } else {
        std::memcpy(&v, rec + f.offset, 4);
      }
      return static_cast<float>(v);
    }
  }
  return 0.f;
}

}  // namespace

// Parse a PCD v0.7 file (ascii or binary). Fills CloudBuffers.
void fastdem_load_pcd(const char* path, CloudBuffers* out) {
  std::memset(out, 0, sizeof(*out));
  const float kIdentityVp[7] = {0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  std::memcpy(out->viewpoint, kIdentityVp, sizeof(kIdentityVp));
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = 1;
    return;
  }

  std::vector<Field> fields;
  int64_t n = -1;
  bool binary = false;
  std::string line;
  bool got_data = false;

  while (read_line(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    auto tok = split_ws(line);
    if (tok.empty()) continue;
    const std::string& key = tok[0];
    if (key == "FIELDS") {
      fields.clear();
      for (size_t i = 1; i < tok.size(); ++i) {
        Field fd;
        fd.name = tok[i];
        fields.push_back(fd);
      }
    } else if (key == "SIZE") {
      for (size_t i = 1; i < tok.size() && i - 1 < fields.size(); ++i)
        fields[i - 1].size = std::atoi(tok[i].c_str());
    } else if (key == "TYPE") {
      for (size_t i = 1; i < tok.size() && i - 1 < fields.size(); ++i)
        fields[i - 1].type = tok[i][0];
    } else if (key == "COUNT") {
      for (size_t i = 1; i < tok.size() && i - 1 < fields.size(); ++i)
        fields[i - 1].count = std::atoi(tok[i].c_str());
    } else if (key == "VIEWPOINT") {
      for (size_t i = 1; i < tok.size() && i <= 7; ++i)
        out->viewpoint[i - 1] = static_cast<float>(std::atof(tok[i].c_str()));
    } else if (key == "POINTS") {
      n = std::atoll(tok[1].c_str());
    } else if (key == "DATA") {
      binary = tok.size() > 1 && tok[1] == "binary";
      got_data = true;
      break;
    }
  }
  if (!got_data || n < 0 || fields.empty()) {
    std::fclose(f);
    out->error = 2;
    return;
  }

  int rec_size = 0;
  for (auto& fd : fields) {
    fd.offset = rec_size;
    rec_size += fd.size * fd.count;
  }
  const Field* fx = nullptr;
  const Field* fy = nullptr;
  const Field* fz = nullptr;
  const Field* fi = nullptr;
  const Field* frgb = nullptr;
  const Field* ft = nullptr;
  const Field* fr = nullptr;
  const Field* fnx = nullptr;
  const Field* fny = nullptr;
  const Field* fnz = nullptr;
  for (const auto& fd : fields) {
    if (fd.name == "x") fx = &fd;
    if (fd.name == "y") fy = &fd;
    if (fd.name == "z") fz = &fd;
    if (fd.name == "intensity") fi = &fd;
    if (fd.name == "rgb" || fd.name == "rgba") frgb = &fd;
    if (fd.name == "time" || fd.name == "t") ft = &fd;
    if (fd.name == "ring") fr = &fd;
    if (fd.name == "normal_x") fnx = &fd;
    if (fd.name == "normal_y") fny = &fd;
    if (fd.name == "normal_z") fnz = &fd;
  }
  if (!fx || !fy || !fz) {
    std::fclose(f);
    out->error = 2;
    return;
  }

  out->xyz = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  if (fi) out->intensity = static_cast<float*>(std::malloc(sizeof(float) * n));
  if (frgb) out->rgb = static_cast<uint8_t*>(std::malloc(3 * n));
  if (ft) out->time = static_cast<float*>(std::malloc(sizeof(float) * n));
  if (fr) out->ring = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * n));
  const bool has_nrm = fnx && fny && fnz;
  if (has_nrm)
    out->normal = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));

  if (binary) {
    std::vector<uint8_t> buf(static_cast<size_t>(rec_size) * n);
    size_t got = std::fread(buf.data(), 1, buf.size(), f);
    int64_t n_have = static_cast<int64_t>(got / rec_size);
    if (n_have < n) n = n_have;
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* rec = buf.data() + static_cast<size_t>(i) * rec_size;
      out->xyz[i * 3 + 0] = field_as_float(rec, *fx);
      out->xyz[i * 3 + 1] = field_as_float(rec, *fy);
      out->xyz[i * 3 + 2] = field_as_float(rec, *fz);
      if (fi) out->intensity[i] = field_as_float(rec, *fi);
      if (frgb) {
        uint32_t bits;
        std::memcpy(&bits, rec + frgb->offset, 4);
        out->rgb[i * 3 + 0] = (bits >> 16) & 0xFF;
        out->rgb[i * 3 + 1] = (bits >> 8) & 0xFF;
        out->rgb[i * 3 + 2] = bits & 0xFF;
      }
      if (ft) out->time[i] = field_as_float(rec, *ft);
      if (fr) out->ring[i] = static_cast<int32_t>(field_as_float(rec, *fr));
      if (has_nrm) {
        out->normal[i * 3 + 0] = field_as_float(rec, *fnx);
        out->normal[i * 3 + 1] = field_as_float(rec, *fny);
        out->normal[i * 3 + 2] = field_as_float(rec, *fnz);
      }
    }
  } else {
    // ascii: token stream in field order.
    int total_cols = 0;
    for (const auto& fd : fields) total_cols += fd.count;
    std::vector<double> row(total_cols);
    std::vector<int> col_of_field(fields.size());
    {
      int c = 0;
      for (size_t k = 0; k < fields.size(); ++k) {
        col_of_field[k] = c;
        c += fields[k].count;
      }
    }
    auto col_of = [&](const Field* fd) {
      for (size_t k = 0; k < fields.size(); ++k)
        if (&fields[k] == fd) return col_of_field[k];
      return 0;
    };
    int cx = col_of(fx), cy = col_of(fy), cz = col_of(fz);
    int ci = fi ? col_of(fi) : -1, crgb = frgb ? col_of(frgb) : -1;
    int ct = ft ? col_of(ft) : -1, cr = fr ? col_of(fr) : -1;
    int cnx = fnx ? col_of(fnx) : -1, cny = fny ? col_of(fny) : -1;
    int cnz = fnz ? col_of(fnz) : -1;
    for (int64_t i = 0; i < n; ++i) {
      for (int c = 0; c < total_cols; ++c) {
        if (std::fscanf(f, "%lf", &row[c]) != 1) {
          n = i;
          break;
        }
      }
      out->xyz[i * 3 + 0] = static_cast<float>(row[cx]);
      out->xyz[i * 3 + 1] = static_cast<float>(row[cy]);
      out->xyz[i * 3 + 2] = static_cast<float>(row[cz]);
      if (fi) out->intensity[i] = static_cast<float>(row[ci]);
      if (frgb) {
        uint32_t bits;
        if (frgb->type == 'F') {
          // Packed-float convention: ascii prints the float whose BITS
          // hold the color — rarely meaningful in ascii, but mirror the
          // binary decode.
          float fv = static_cast<float>(row[crgb]);
          std::memcpy(&bits, &fv, 4);
        } else {
          // nanoPCL's convention (TYPE U): the packed integer itself.
          bits = static_cast<uint32_t>(row[crgb]);
        }
        out->rgb[i * 3 + 0] = (bits >> 16) & 0xFF;
        out->rgb[i * 3 + 1] = (bits >> 8) & 0xFF;
        out->rgb[i * 3 + 2] = bits & 0xFF;
      }
      if (ft) out->time[i] = static_cast<float>(row[ct]);
      if (fr) out->ring[i] = static_cast<int32_t>(row[cr]);
      if (has_nrm) {
        out->normal[i * 3 + 0] = static_cast<float>(row[cnx]);
        out->normal[i * 3 + 1] = static_cast<float>(row[cny]);
        out->normal[i * 3 + 2] = static_cast<float>(row[cnz]);
      }
    }
  }
  out->n = n;
  std::fclose(f);
}

// KITTI velodyne .bin: N x (x, y, z, intensity) float32.
void fastdem_load_kitti(const char* path, CloudBuffers* out) {
  std::memset(out, 0, sizeof(*out));
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = 1;
    return;
  }
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int64_t n = bytes / (4 * sizeof(float));
  out->xyz = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  out->intensity = static_cast<float*>(std::malloc(sizeof(float) * n));
  std::vector<float> rec(4);
  // Read in chunks for speed.
  const int64_t CH = 65536;
  std::vector<float> buf(CH * 4);
  int64_t i = 0;
  while (i < n) {
    int64_t take = std::min(CH, n - i);
    size_t got = std::fread(buf.data(), sizeof(float) * 4, take, f);
    for (size_t k = 0; k < got; ++k) {
      out->xyz[(i + k) * 3 + 0] = buf[k * 4 + 0];
      out->xyz[(i + k) * 3 + 1] = buf[k * 4 + 1];
      out->xyz[(i + k) * 3 + 2] = buf[k * 4 + 2];
      out->intensity[i + k] = buf[k * 4 + 3];
    }
    if (got < static_cast<size_t>(take)) {
      n = i + static_cast<int64_t>(got);
      break;
    }
    i += take;
  }
  out->n = n;
  std::fclose(f);
}

// Binary PCD writer (x, y, z [, intensity] [, rgb] [, normal_xyz]).
// rgb is written as TYPE U (nanoPCL's convention, io/pcd_io.hpp:440) —
// identical bytes to the packed-float form in binary mode. `viewpoint`
// (7 floats, tx ty tz qw qx qy qz) is preserved in the header; null
// writes identity.
int32_t fastdem_save_pcd(const char* path, int64_t n, const float* xyz,
                         const float* intensity, const uint8_t* rgb,
                         const float* normal, const float* viewpoint) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::string fields = "x y z";
  std::string sizes = "4 4 4";
  std::string types = "F F F";
  std::string counts = "1 1 1";
  int ncols = 3;
  if (intensity) {
    fields += " intensity";
    sizes += " 4";
    types += " F";
    counts += " 1";
    ++ncols;
  }
  if (rgb) {
    fields += " rgb";
    sizes += " 4";
    types += " U";
    counts += " 1";
    ++ncols;
  }
  if (normal) {
    fields += " normal_x normal_y normal_z";
    sizes += " 4 4 4";
    types += " F F F";
    counts += " 1 1 1";
    ncols += 3;
  }
  const float kIdentityVp[7] = {0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  const float* vp = viewpoint ? viewpoint : kIdentityVp;
  std::fprintf(f,
               "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS %s\nSIZE %s\nTYPE %s\nCOUNT %s\n"
               "WIDTH %lld\nHEIGHT 1\nVIEWPOINT %g %g %g %g %g %g %g\n"
               "POINTS %lld\nDATA binary\n",
               fields.c_str(), sizes.c_str(), types.c_str(), counts.c_str(),
               static_cast<long long>(n), vp[0], vp[1], vp[2], vp[3], vp[4],
               vp[5], vp[6], static_cast<long long>(n));
  std::vector<float> rec(ncols);
  for (int64_t i = 0; i < n; ++i) {
    int c = 0;
    rec[c++] = xyz[i * 3 + 0];
    rec[c++] = xyz[i * 3 + 1];
    rec[c++] = xyz[i * 3 + 2];
    if (intensity) rec[c++] = intensity[i];
    if (rgb) {
      uint32_t bits = (static_cast<uint32_t>(rgb[i * 3 + 0]) << 16) |
                      (static_cast<uint32_t>(rgb[i * 3 + 1]) << 8) |
                      static_cast<uint32_t>(rgb[i * 3 + 2]);
      float fv;
      std::memcpy(&fv, &bits, 4);
      rec[c++] = fv;
    }
    if (normal) {
      rec[c++] = normal[i * 3 + 0];
      rec[c++] = normal[i * 3 + 1];
      rec[c++] = normal[i * 3 + 2];
    }
    std::fwrite(rec.data(), sizeof(float), ncols, f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
