// Native stroke-preprocessing kernels for the offline IAM data build.
//
// The dataset build runs combine_strokes (pairwise collinear merge +
// re-normalization, reference utils/io.py:118-147) three times per line over
// ~10k lines; this is the CPU hot loop of cache construction. The Python
// path (dhg/data/strokes.py) stays as the reference implementation and
// fallback; this library is selected via ctypes when built
// (dhg/native/__init__.py).
//
// Tie-breaking note: pair-merge candidates are chosen by std::stable_sort on
// the collinearity cost; the Python path uses np.argsort(kind="stable") so
// both paths produce bit-identical merge choices.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

double std_xy(const double* xyz, int64_t n) {
  // Population std over BOTH delta channels, two-pass like np.std on the
  // flattened [n, 2] view.
  const int64_t m = 2 * n;
  double sum = 0.0;
  for (int64_t i = 0; i < n; ++i) sum += xyz[3 * i] + xyz[3 * i + 1];
  const double mean = sum / static_cast<double>(m);
  double ss = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double dx = xyz[3 * i] - mean;
    const double dy = xyz[3 * i + 1] - mean;
    ss += dx * dx + dy * dy;
  }
  return std::sqrt(ss / static_cast<double>(m));
}

// One combine pass: merge the n_merge lowest-cost (even, odd) consecutive
// pairs, OR the pen-lift bits, delete the odd rows, renormalize by std.
int64_t combine_pass(std::vector<double>& xyz, int64_t n, int64_t n_merge) {
  const int64_t pairs = n / 2;
  if (n_merge > pairs) n_merge = pairs;

  std::vector<double> cost(pairs);
  for (int64_t p = 0; p < pairs; ++p) {
    const double ax = xyz[3 * (2 * p)], ay = xyz[3 * (2 * p) + 1];
    const double bx = xyz[3 * (2 * p + 1)], by = xyz[3 * (2 * p + 1) + 1];
    cost[p] = std::sqrt(ax * ax + ay * ay) + std::sqrt(bx * bx + by * by) -
              std::sqrt((ax + bx) * (ax + bx) + (ay + by) * (ay + by));
  }

  std::vector<int64_t> order(pairs);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return cost[a] < cost[b]; });

  std::vector<uint8_t> merge(pairs, 0);
  for (int64_t i = 0; i < n_merge; ++i) merge[order[i]] = 1;

  // Merge in place, then compact (delete the odd row of merged pairs).
  std::vector<double> out;
  out.reserve(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = i / 2;
    if (i % 2 == 0 && p < pairs && merge[p]) {
      const double mx = xyz[3 * i] + xyz[3 * (i + 1)];
      const double my = xyz[3 * i + 1] + xyz[3 * (i + 1) + 1];
      const double pen = (xyz[3 * i + 2] + xyz[3 * (i + 1) + 2]) > 0.0 ? 1.0 : 0.0;
      out.push_back(mx);
      out.push_back(my);
      out.push_back(pen);
      ++i;  // skip the merged odd row
    } else {
      out.push_back(xyz[3 * i]);
      out.push_back(xyz[3 * i + 1]);
      out.push_back(xyz[3 * i + 2]);
    }
  }

  const int64_t n_out = static_cast<int64_t>(out.size()) / 3;
  // Unconditional divide like np.std-based renormalization (0/0 -> NaN,
  // x/0 -> inf): degenerate inputs must produce the same rows as numpy.
  const double s = std_xy(out.data(), n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    out[3 * i] /= s;
    out[3 * i + 1] /= s;
  }
  xyz.assign(out.begin(), out.end());
  return n_out;
}

// ---------------------------------------------------------------------------
// IAM stroke-XML parsing (reference utils/io.py:11-66).
//
// A targeted scanner for the IAM lineStrokes format — not a general XML
// parser. It understands exactly what ElementTree extracts on these files:
// <Point x y> elements that are children of <Stroke> elements inside the
// <StrokeSet>, in document order. Comments, <?...?> declarations, CDATA and
// quoted attribute values (either quote style, any attribute order, extra
// attributes like time="...") are handled; on ANY structural surprise the
// parse returns a negative code and the Python caller falls back to the
// ElementTree reference path, so divergence is impossible by construction.
// ---------------------------------------------------------------------------

struct Tag {
  const char* name;
  int64_t name_len;
  const char* attrs;
  const char* attrs_end;
  bool closing;
  bool self_closing;
};

// Advance `p` to just past the next element tag, filling `tag`.
// Returns 0 = tag found, 1 = clean EOF, -1 = malformed/unterminated.
int next_tag(const char*& p, const char* end, Tag& tag) {
  while (true) {
    const void* lt = memchr(p, '<', static_cast<size_t>(end - p));
    if (lt == nullptr) {
      p = end;
      return 1;
    }
    p = static_cast<const char*>(lt);
    if (end - p >= 4 && memcmp(p, "<!--", 4) == 0) {
      const char* c = p + 4;
      while (c + 3 <= end && memcmp(c, "-->", 3) != 0) ++c;
      if (c + 3 > end) return -1;
      p = c + 3;
      continue;
    }
    if (end - p >= 9 && memcmp(p, "<![CDATA[", 9) == 0) {
      const char* c = p + 9;
      while (c + 3 <= end && memcmp(c, "]]>", 3) != 0) ++c;
      if (c + 3 > end) return -1;
      p = c + 3;
      continue;
    }
    if (end - p >= 2 && (p[1] == '?' || p[1] == '!')) {
      // Declaration / DOCTYPE: skip to '>' (IAM files have no nesting here).
      const void* gt = memchr(p, '>', static_cast<size_t>(end - p));
      if (gt == nullptr) return -1;
      p = static_cast<const char*>(gt) + 1;
      continue;
    }
    break;
  }
  const char* q = p + 1;
  tag.closing = (q < end && *q == '/');
  if (tag.closing) ++q;
  tag.name = q;
  while (q < end && (std::isalnum(static_cast<unsigned char>(*q)) || *q == '_' ||
                     *q == ':' || *q == '-' || *q == '.')) {
    ++q;
  }
  tag.name_len = q - tag.name;
  if (tag.name_len == 0) return -1;
  tag.attrs = q;
  char quote = 0;
  const char* r = q;
  while (r < end) {
    const char c = *r;
    if (quote != 0) {
      if (c == quote) quote = 0;
    } else if (c == '"' || c == '\'') {
      quote = c;
    } else if (c == '>') {
      break;
    }
    ++r;
  }
  if (r >= end) return -1;
  tag.self_closing = (r > q && r[-1] == '/');
  tag.attrs_end = tag.self_closing ? r - 1 : r;
  p = r + 1;
  return 0;
}

bool tag_is(const Tag& t, const char* name) {
  const int64_t n = static_cast<int64_t>(strlen(name));
  return t.name_len == n && memcmp(t.name, name, static_cast<size_t>(n)) == 0;
}

// Integer attribute lookup (like Python's int(p.attrib[key])): scans the
// name="value" list; false on absence or a non-integer value.
bool int_attr(const Tag& t, const char* key, long long* val) {
  const char* p = t.attrs;
  while (p < t.attrs_end) {
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end) break;
    const char* ns = p;
    while (p < t.attrs_end && *p != '=' &&
           !std::isspace(static_cast<unsigned char>(*p))) {
      ++p;
    }
    const int64_t nlen = p - ns;
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end || *p != '=') return false;
    ++p;
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end || (*p != '"' && *p != '\'')) return false;
    const char q = *p++;
    const char* vs = p;
    while (p < t.attrs_end && *p != q) ++p;
    if (p >= t.attrs_end) return false;
    const char* ve = p;
    ++p;
    const int64_t klen = static_cast<int64_t>(strlen(key));
    if (nlen == klen && memcmp(ns, key, static_cast<size_t>(klen)) == 0) {
      const std::string s(vs, ve);  // bounded copy for strtoll
      errno = 0;
      char* endp = nullptr;
      const long long v = strtoll(s.c_str(), &endp, 10);
      while (endp != nullptr && std::isspace(static_cast<unsigned char>(*endp))) ++endp;
      if (errno != 0 || endp == s.c_str() || (endp != nullptr && *endp != '\0')) {
        return false;
      }
      *val = v;
      return true;
    }
  }
  return false;
}

// Any tag with a repeated attribute name is malformed XML (ElementTree
// raises ParseError on the whole file) — the scanner must decline, not
// silently pick one value.
bool has_dup_attrs(const Tag& t) {
  const char* names[16];
  int64_t lens[16];
  int count = 0;
  const char* p = t.attrs;
  while (p < t.attrs_end) {
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end) break;
    const char* ns = p;
    while (p < t.attrs_end && *p != '=' &&
           !std::isspace(static_cast<unsigned char>(*p))) {
      ++p;
    }
    const int64_t nlen = p - ns;
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end || *p != '=') return true;  // malformed attr list
    ++p;
    while (p < t.attrs_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= t.attrs_end || (*p != '"' && *p != '\'')) return true;
    const char q = *p++;
    while (p < t.attrs_end && *p != q) ++p;
    if (p >= t.attrs_end) return true;
    ++p;
    for (int i = 0; i < count; ++i) {
      if (lens[i] == nlen && memcmp(names[i], ns, static_cast<size_t>(nlen)) == 0) {
        return true;
      }
    }
    if (count == 16) return true;  // absurd attr count: decline
    names[count] = ns;
    lens[count] = nlen;
    ++count;
  }
  return false;
}

// Collect (x, y, is_last_point_of_stroke) for every Point that is a direct
// child of a Stroke that is a direct child of the (single) StrokeSet —
// exactly the ElementTree reference's findall nesting. The whole document
// is checked for tag balance (a name stack), duplicate attributes, a
// single root, and no trailing junk, so files ElementTree would reject
// with ParseError decline here too instead of parsing differently.
// Returns point count, or -1 (no StrokeSet) / -2 (malformed or a structure
// the scanner can't guarantee matches ElementTree).
int64_t parse_points(const char* buf, int64_t len, std::vector<double>& xs,
                     std::vector<double>& ys, std::vector<double>& ends) {
  const char* p = buf;
  const char* end = buf + len;
  Tag t;
  std::vector<std::pair<const char*, int64_t>> stack;  // open-tag names
  bool root_seen = false, root_closed = false;
  bool in_ss = false, found_ss = false;
  int64_t ss_depth = -1;      // stack depth of the open <StrokeSet>
  int64_t stroke_depth = -1;  // stack depth of the open <Stroke>, or -1
  int64_t stroke_start = -1;  // first point index of the open <Stroke>

  while (true) {
    const int rc = next_tag(p, end, t);
    if (rc == 1) break;  // clean EOF
    if (rc < 0) return -2;
    if (root_closed) return -2;  // content after the root element
    if (has_dup_attrs(t)) return -2;

    if (t.closing) {
      if (stack.empty()) return -2;
      const auto& top = stack.back();
      if (top.second != t.name_len ||
          memcmp(top.first, t.name, static_cast<size_t>(t.name_len)) != 0) {
        return -2;  // mismatched close tag
      }
      stack.pop_back();
      const int64_t depth = static_cast<int64_t>(stack.size());
      if (stroke_depth >= 0 && depth == stroke_depth) {
        // The active <Stroke> just closed: its last point ends the stroke.
        if (stroke_start >= 0 && static_cast<int64_t>(xs.size()) > stroke_start) {
          ends.back() = 1.0;
        }
        stroke_depth = -1;
        stroke_start = -1;
      }
      if (in_ss && depth == ss_depth) in_ss = false;  // </StrokeSet>
      if (stack.empty()) root_closed = true;
      continue;
    }

    // Opening tag.
    if (stack.empty()) {
      if (root_seen) return -2;  // second root element
      root_seen = true;
      if (t.self_closing) {
        root_closed = true;
        continue;
      }
    }
    if (tag_is(t, "StrokeSet")) {
      if (in_ss || found_ss) return -2;  // nested or second StrokeSet
      if (static_cast<int64_t>(stack.size()) != 1) {
        return -2;  // ET's root.find() only sees direct children of the root
      }
      found_ss = true;
      if (!t.self_closing) {
        in_ss = true;
        ss_depth = static_cast<int64_t>(stack.size());
      }
    } else if (in_ss && tag_is(t, "Stroke")) {
      if (stroke_depth >= 0) return -2;  // nested Stroke
      if (static_cast<int64_t>(stack.size()) != ss_depth + 1) {
        return -2;  // not a direct child of StrokeSet: ET would ignore it
      }
      if (!t.self_closing) {
        stroke_depth = static_cast<int64_t>(stack.size());
        stroke_start = static_cast<int64_t>(xs.size());
      }
    } else if (in_ss && tag_is(t, "Point")) {
      if (stroke_depth < 0 ||
          static_cast<int64_t>(stack.size()) != stroke_depth + 1) {
        return -2;  // Point not a direct child of a Stroke: ET would ignore
      }
      long long x = 0, y = 0;
      if (!int_attr(t, "x", &x) || !int_attr(t, "y", &y)) return -2;
      xs.push_back(static_cast<double>(x));
      ys.push_back(static_cast<double>(y));
      ends.push_back(0.0);
    }
    if (!t.self_closing) stack.emplace_back(t.name, t.name_len);
  }
  if (!stack.empty()) return -2;  // unbalanced at EOF
  if (!found_ss) return -1;
  return static_cast<int64_t>(xs.size());
}

}  // namespace

extern "C" {

// Parse an IAM stroke XML buffer -> [n-1, 3] normalized delta rows
// (dx, -dy, pen-rolled(+1)), exactly like parse_strokes_xml's pre-simplify
// stage (utils/io.py:11-59). Returns the row count, or a negative code on
// which the caller must fall back to the Python parser:
//   -1 no StrokeSet, -2 malformed XML or non-integer coordinate,
//   -3 fewer than 2 points, -4 out capacity exceeded.
int64_t dhg_parse_strokes_xml(const char* buf, int64_t len, double* out,
                              int64_t max_rows) {
  std::vector<double> xs, ys, ends;
  const int64_t n = parse_points(buf, len, xs, ys, ends);
  if (n < 0) return n;
  if (n < 2) return -3;
  if (n - 1 > max_rows) return -4;
  // Deltas with y negated; pen channel rolled by +1 (the segment AFTER a
  // pen-up is "not drawn"): out_pen[0] = ends[n-1], out_pen[j] = ends[j].
  for (int64_t i = 0; i + 1 < n; ++i) {
    out[3 * i] = xs[i + 1] - xs[i];
    out[3 * i + 1] = -(ys[i + 1] - ys[i]);
    out[3 * i + 2] = (i == 0) ? ends[n - 1] : ends[i];
  }
  const int64_t rows = n - 1;
  // Unconditional divide, matching `strokes[:, :2] /= np.std(...)` exactly
  // (utils/io.py:59): two identical points -> 0/0 -> NaN rows, same as the
  // ElementTree/numpy path, so cache contents can't depend on whether the
  // native library built.
  const double s = std_xy(out, rows);
  for (int64_t i = 0; i < rows; ++i) {
    out[3 * i] /= s;
    out[3 * i + 1] /= s;
  }
  return rows;
}

// Parse + the full simplification pipeline in ONE native call (the per-line
// unit of work of the IAM cache build).
int64_t dhg_parse_and_simplify(const char* buf, int64_t len, int64_t passes,
                               double frac, double* out, int64_t max_rows) {
  const int64_t n = dhg_parse_strokes_xml(buf, len, out, max_rows);
  if (n < 0) return n;
  std::vector<double> xyz(out, out + 3 * n);
  int64_t cur = n;
  for (int64_t p = 0; p < passes; ++p) {
    const int64_t n_merge = static_cast<int64_t>(static_cast<double>(cur) * frac);
    cur = combine_pass(xyz, cur, n_merge);
  }
  memcpy(out, xyz.data(), sizeof(double) * 3 * static_cast<size_t>(cur));
  return cur;
}

// Full simplification pipeline on a [n, 3] row-major (dx, dy, pen) array:
// `passes` combine passes, each merging floor(frac * current_n) pairs.
// Writes at most n rows to `out` (simplification only shrinks); returns the
// output row count.
int64_t dhg_simplify_strokes(const double* xyz_in, int64_t n, int64_t passes,
                             double frac, double* out) {
  std::vector<double> xyz(xyz_in, xyz_in + 3 * n);
  int64_t cur = n;
  for (int64_t p = 0; p < passes; ++p) {
    const int64_t n_merge = static_cast<int64_t>(static_cast<double>(cur) * frac);
    cur = combine_pass(xyz, cur, n_merge);
  }
  std::memcpy(out, xyz.data(), sizeof(double) * 3 * cur);
  return cur;
}

// One combine pass (exposed for parity tests against the Python reference).
int64_t dhg_combine_strokes(const double* xyz_in, int64_t n, int64_t n_merge,
                            double* out) {
  std::vector<double> xyz(xyz_in, xyz_in + 3 * n);
  const int64_t cur = combine_pass(xyz, n, n_merge);
  std::memcpy(out, xyz.data(), sizeof(double) * 3 * cur);
  return cur;
}

}  // extern "C"
