// nanoGrid API-compatibility layer — written from the call-site contract
// documented in SURVEY.md §2.3 (the real nanoGrid is fetched from GitHub at
// build time by the reference's CMake and is NOT present in this
// environment). This header exists ONLY to compile the reference FastDEM
// C++ sources into a golden-output generator (tests/refbuild/golden_gen.cpp)
// so this implementation can be validated against the reference's actual
// numerics. It is original code: the circular-buffer grid semantics mirror
// the public ETH grid_map design the reference documents itself against
// (src/raycasting.cpp:60-117 spells out the coordinate mapping; iterator
// member usage is taken from src/{inpainting,uncertainty_fusion,
// feature_extraction,elevation_mapping}.cpp).
//
// Contract notes (derived from the call sites):
//  * Index            = Eigen::Vector2i STORAGE (buffer) index.
//  * Matrix           = Eigen::MatrixXf (column-major; io_npz relies on it).
//  * getIndex(pos)    -> storage index: unwrapped = floor((origin - p)/res),
//                        storage = (unwrapped + start) mod size, where
//                        origin = position + length/2 (row -> -x, col -> -y).
//  * move(p)          = start-index shift by round((p - position)/res);
//                        entering rows/cols are NaN-cleared in every layer;
//                        position advances by whole cells (no data copy).
//  * cells()          yields {index: linear storage offset (col-major),
//                        row, col: UNWRAPPED coordinates} — linear index is
//                        used directly as Eigen linear indexing at call
//                        sites; row/col differences are used as spatial
//                        displacements (feature_extraction.cpp:75-77).
//  * region(radius)   = offsets with hypot(dr,dc)*res <= radius (incl.
//                        center); region(Size(k,k)) = full k x k window.
//                        entries[i].dist_sq is metric (meters^2,
//                        uncertainty_fusion.cpp:156).
//  * neighbors(c,reg) yields in-bounds entries {index: linear storage,
//                        row, col: unwrapped, dist_sq}.
//  * colorVectorToValue packs 0xRRGGBB into the float's bit pattern.

#ifndef NANOGRID_COMPAT_HPP
#define NANOGRID_COMPAT_HPP

#include <Eigen/Dense>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace nanogrid {

using Index = Eigen::Vector2i;
using Size = Eigen::Vector2i;
using Position = Eigen::Vector2d;
using Length = Eigen::Vector2d;
using Matrix = Eigen::MatrixXf;

struct IndexHash {
  std::size_t operator()(const Index& i) const {
    return std::hash<std::int64_t>()(
        (static_cast<std::int64_t>(i(0)) << 32) ^
        static_cast<std::int64_t>(static_cast<std::uint32_t>(i(1))));
  }
};

struct IndexEqual {
  bool operator()(const Index& a, const Index& b) const {
    return a(0) == b(0) && a(1) == b(1);
  }
};

inline void colorVectorToValue(const Eigen::Vector3i& rgb, float& out) {
  const std::uint32_t packed = (static_cast<std::uint32_t>(rgb(0)) << 16) |
                               (static_cast<std::uint32_t>(rgb(1)) << 8) |
                               static_cast<std::uint32_t>(rgb(2));
  std::memcpy(&out, &packed, sizeof(out));
}

inline void colorValueToVector(float value, Eigen::Vector3i& rgb) {
  std::uint32_t packed;
  std::memcpy(&packed, &value, sizeof(packed));
  rgb = Eigen::Vector3i((packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                        packed & 0xFF);
}

// Precomputed relative neighborhood (region()).
struct Region {
  struct Entry {
    int dr;
    int dc;
    float dist_sq;  // meters^2
  };
  std::vector<Entry> entries;
};

class GridMap {
 public:
  struct CellRef {
    Eigen::Index index;  // linear storage offset (column-major)
    int row;             // unwrapped row
    int col;             // unwrapped col
  };
  struct NeighborRef {
    Eigen::Index index;
    int row;
    int col;
    float dist_sq;
  };

  GridMap() = default;
  GridMap(std::initializer_list<std::string> layers) {
    for (const auto& l : layers) layer_names_.push_back(l);
  }
  explicit GridMap(const std::vector<std::string>& layers)
      : layer_names_(layers) {}

  // -- geometry ------------------------------------------------------------
  void setGeometry(const Length& length, double resolution) {
    resolution_ = resolution;
    size_ = Size(static_cast<int>(std::round(length(0) / resolution)),
                 static_cast<int>(std::round(length(1) / resolution)));
    length_ = Length(size_(0) * resolution, size_(1) * resolution);
    position_.setZero();
    start_ = Index(0, 0);
    data_.clear();
    for (const auto& name : layer_names_) {
      data_[name] = Matrix::Constant(size_(0), size_(1), NAN);
    }
  }

  const Size& getSize() const { return size_; }
  const Length& getLength() const { return length_; }
  double getResolution() const { return resolution_; }
  const Position& getPosition() const { return position_; }
  void setPosition(const Position& p) { position_ = p; }
  const std::string& getFrameId() const { return frame_id_; }
  void setFrameId(const std::string& f) { frame_id_ = f; }
  std::uint64_t getTimestamp() const { return timestamp_; }
  void setTimestamp(std::uint64_t t) { timestamp_ = t; }
  const Index& getStartIndex() const { return start_; }
  void setStartIndex(const Index& s) { start_ = s; }

  // -- layer store -----------------------------------------------------------
  void add(const std::string& name, float fill = NAN) {
    if (!exists(name)) layer_names_.push_back(name);
    data_[name] = Matrix::Constant(size_(0), size_(1), fill);
  }
  void add(const std::string& name, const Matrix& m) {
    if (!exists(name)) layer_names_.push_back(name);
    data_[name] = m;
  }
  bool exists(const std::string& name) const { return data_.count(name) > 0; }
  Matrix& get(const std::string& name) {
    auto it = data_.find(name);
    if (it == data_.end())
      throw std::out_of_range("nanogrid: no layer '" + name + "'");
    return it->second;
  }
  const Matrix& get(const std::string& name) const {
    auto it = data_.find(name);
    if (it == data_.end())
      throw std::out_of_range("nanogrid: no layer '" + name + "'");
    return it->second;
  }
  float& at(const std::string& name, const Index& idx) {
    return get(name)(idx(0), idx(1));
  }
  float at(const std::string& name, const Index& idx) const {
    return get(name)(idx(0), idx(1));
  }
  float atPosition(const std::string& name, const Position& pos) const {
    Index idx;
    if (!getIndex(pos, idx)) return NAN;
    return at(name, idx);
  }
  void clear(const std::string& name) { get(name).setConstant(NAN); }
  void clearAll() {
    for (auto& kv : data_) kv.second.setConstant(NAN);
  }
  const std::vector<std::string>& getLayers() const { return layer_names_; }

  // -- world <-> index -------------------------------------------------------
  bool getIndex(const Position& pos, Index& idx) const {
    const double ox = position_(0) + length_(0) / 2.0;
    const double oy = position_(1) + length_(1) / 2.0;
    const int r = static_cast<int>(std::floor((ox - pos(0)) / resolution_));
    const int c = static_cast<int>(std::floor((oy - pos(1)) / resolution_));
    if (r < 0 || r >= size_(0) || c < 0 || c >= size_(1)) return false;
    idx = Index(wrap(r + start_(0), size_(0)), wrap(c + start_(1), size_(1)));
    return true;
  }

  bool getPosition(const Index& idx, Position& pos) const {
    if (idx(0) < 0 || idx(0) >= size_(0) || idx(1) < 0 || idx(1) >= size_(1))
      return false;
    const int ur = wrap(idx(0) - start_(0), size_(0));
    const int uc = wrap(idx(1) - start_(1), size_(1));
    const double ox = position_(0) + length_(0) / 2.0;
    const double oy = position_(1) + length_(1) / 2.0;
    pos = Position(ox - (ur + 0.5) * resolution_,
                   oy - (uc + 0.5) * resolution_);
    return true;
  }

  bool isInside(const Position& pos) const {
    Index idx;
    return getIndex(pos, idx);
  }

  // -- circular-buffer move ---------------------------------------------------
  void move(const Position& target) {
    const int dr = static_cast<int>(
        std::round((target(0) - position_(0)) / resolution_));
    const int dc = static_cast<int>(
        std::round((target(1) - position_(1)) / resolution_));
    if (dr == 0 && dc == 0) return;

    // Moving the center +d cells along x moves origin (= center + L/2)
    // up by d, so a FIXED world point's unwrapped row u = (origin_x -
    // p_x)/res grows by +d; its storage cell (u + start) mod n stays put
    // iff start -= d. Unwrapped rows entering the new window are [0, d)
    // for d > 0 (new ground at high x) or [n + d, n) for d < 0.
    clearEntering(0, dr);
    clearEntering(1, dc);
    start_(0) = wrap(start_(0) - dr, size_(0));
    start_(1) = wrap(start_(1) - dc, size_(1));
    position_ += Position(dr * resolution_, dc * resolution_);
  }

  // -- iteration ---------------------------------------------------------------
  std::vector<CellRef> cells() const {
    std::vector<CellRef> out;
    out.reserve(static_cast<std::size_t>(size_(0)) * size_(1));
    for (int j = 0; j < size_(1); ++j) {
      for (int i = 0; i < size_(0); ++i) {
        out.push_back(CellRef{linear(i, j), wrap(i - start_(0), size_(0)),
                              wrap(j - start_(1), size_(1))});
      }
    }
    return out;
  }

  Region region(double radius_m) const {
    Region reg;
    const int r_cells =
        static_cast<int>(std::floor(radius_m / resolution_ + 1e-6));
    for (int dr = -r_cells; dr <= r_cells; ++dr) {
      for (int dc = -r_cells; dc <= r_cells; ++dc) {
        const double d = std::hypot(static_cast<double>(dr),
                                    static_cast<double>(dc)) *
                         resolution_;
        if (d <= radius_m + 1e-6) {
          reg.entries.push_back(
              {dr, dc,
               static_cast<float>((dr * dr + dc * dc) * resolution_ *
                                  resolution_)});
        }
      }
    }
    return reg;
  }

  Region region(const Size& window) const {
    Region reg;
    const int hr = window(0) / 2;
    const int hc = window(1) / 2;
    for (int dr = -hr; dr <= hr; ++dr) {
      for (int dc = -hc; dc <= hc; ++dc) {
        reg.entries.push_back(
            {dr, dc,
             static_cast<float>((dr * dr + dc * dc) * resolution_ *
                                resolution_)});
      }
    }
    return reg;
  }

  std::vector<NeighborRef> neighbors(const CellRef& cell,
                                     const Region& reg) const {
    std::vector<NeighborRef> out;
    out.reserve(reg.entries.size());
    for (const auto& e : reg.entries) {
      const int ur = cell.row + e.dr;
      const int uc = cell.col + e.dc;
      if (ur < 0 || ur >= size_(0) || uc < 0 || uc >= size_(1)) continue;
      const int sr = wrap(ur + start_(0), size_(0));
      const int sc = wrap(uc + start_(1), size_(1));
      out.push_back(NeighborRef{linear(sr, sc), ur, uc, e.dist_sq});
    }
    return out;
  }

 private:
  static int wrap(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
  }
  Eigen::Index linear(int i, int j) const {
    // Column-major storage: linear = row + col * rows.
    return static_cast<Eigen::Index>(i) +
           static_cast<Eigen::Index>(j) * size_(0);
  }
  void clearEntering(int axis, int d) {
    if (d == 0) return;
    const int n = size_(axis);
    int lo, hi;  // entering UNWRAPPED range in the POST-move frame
    if (d > 0) {
      lo = 0;
      hi = std::min(d, n);
    } else {
      lo = std::max(0, n + d);
      hi = n;
    }
    // Post-move start on this axis:
    const int new_start = wrap(start_(axis) - d, n);
    for (int u = lo; u < hi; ++u) {
      const int s = wrap(u + new_start, n);
      for (auto& kv : data_) {
        if (axis == 0) {
          kv.second.row(s).setConstant(NAN);
        } else {
          kv.second.col(s).setConstant(NAN);
        }
      }
    }
  }

  std::vector<std::string> layer_names_;
  std::map<std::string, Matrix> data_;
  Size size_ = Size(0, 0);
  Length length_ = Length(0.0, 0.0);
  double resolution_ = 0.0;
  Position position_ = Position(0.0, 0.0);
  Index start_ = Index(0, 0);
  std::string frame_id_;
  std::uint64_t timestamp_ = 0;
};

}  // namespace nanogrid

#endif  // NANOGRID_COMPAT_HPP
