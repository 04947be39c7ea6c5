// Native host-runtime helpers for renderengine_tpu_torch (a copy of the
// JAX package's, so the port imports nothing of it).
//
// The reference engine's host side is C++ throughout; the rebuild keeps
// the compute path on the device but implements the host-side hot loops
// natively too. The two that dominate scene loading:
//
//  1. PNG scanline unfiltering (per-byte sequential dependency — the Paeth/
//     Sub/Average filters can't be vectorized in numpy; the pure-Python
//     fallback is ~1000x slower on megapixel textures). Plays the role of
//     stb_image's hot loop (reference TextureCache.cpp:50-106).
//  2. Wavefront OBJ tokenization (reference AssimpSceneLoader's per-vertex
//     append loop, AssimpSceneLoader.cpp:226-248).
//
// Plain C ABI, consumed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// --- PNG unfilter ----------------------------------------------------------
// raw: concatenated (filter_byte + row_bytes) scanlines, h rows of `stride`
// bytes each, `bpp` bytes per pixel. out: h*stride bytes.
int unfilter_png(const uint8_t* raw, int64_t raw_len, int h, int stride,
                 int bpp, uint8_t* out) {
  if (raw_len < (int64_t)h * (stride + 1)) return -1;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + (int64_t)y * (stride + 1);
    uint8_t ftype = src[0];
    const uint8_t* row = src + 1;
    uint8_t* dst = out + (int64_t)y * stride;
    switch (ftype) {
      case 0:
        memcpy(dst, row, stride);
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          dst[i] = row[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          dst[i] = row[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          dst[i] = row[i] + ((left + up) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = row[i] + pred;
        }
        break;
      default:
        return -2;
    }
    prev = dst;
  }
  return 0;
}

// --- OBJ parser -------------------------------------------------------------
// Two-phase: obj_parse() tokenizes the whole file into flat per-corner
// arrays (fan-triangulated, indices resolved, 3 corners per triangle) and
// returns a handle; obj_fetch() copies the arrays out; obj_free() releases.

struct ObjData {
  std::vector<float> pos;       // 9 floats per tri (3 corners x xyz)
  std::vector<float> nrm;       // 9 per tri (zeros when absent)
  std::vector<float> uv;        // 6 per tri (v already negated)
  std::vector<int32_t> mat;     // 1 per tri: material index into names
  std::vector<char> mat_names;  // \0-joined material names (usemtl order)
  std::vector<char> mtllibs;    // \0-joined mtllib paths
  int32_t n_tris = 0;
  int32_t n_mats = 0;
};

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

extern "C" void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(len + 1);
  if (fread(buf.data(), 1, len, f) != (size_t)len) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[len] = '\n';

  auto* d = new ObjData();
  std::vector<float> vs, vns, vts;
  std::vector<const char*> mat_name_ptrs;
  int cur_mat = -1;

  const char* p = buf.data();
  const char* end = buf.data() + len;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q + 1 < line_end && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* e;
      float x = strtof(q + 2, &e), y = strtof(e, &e), z = strtof(e, &e);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n') {
      char* e;
      float x = strtof(q + 3, &e), y = strtof(e, &e), z = strtof(e, &e);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't') {
      char* e;
      float u = strtof(q + 3, &e), v = strtof(e, &e);
      vts.push_back(u); vts.push_back(-v);  // reference v flip
    } else if (q < line_end && q[0] == 'f') {
      // corners: v[/vt[/vn]]
      int vi[64], ti[64], ni[64], n = 0;
      const char* c = q + 1;
      while (c < line_end && n < 64) {
        c = skip_ws(c, line_end);
        if (c >= line_end) break;
        char* e;
        long a = strtol(c, &e, 10);
        if (e == c) break;
        long b = 0, cc = 0;
        if (*e == '/') {
          const char* e2 = e + 1;
          if (*e2 != '/') b = strtol(e2, (char**)&e2, 10);
          if (*e2 == '/') cc = strtol(e2 + 1, &e, 10);
          else e = (char*)e2;
        }
        vi[n] = (int)a; ti[n] = (int)b; ni[n] = (int)cc;
        ++n;
        c = e;
      }
      int nv = (int)(vs.size() / 3), nt = (int)(vts.size() / 2),
          nn = (int)(vns.size() / 3);
      auto rv = [&](int i, int cnt) { return i > 0 ? i - 1 : cnt + i; };
      for (int k = 1; k + 1 < n; ++k) {
        int idx[3] = {0, k, k + 1};
        for (int cnr = 0; cnr < 3; ++cnr) {
          int i = idx[cnr];
          int v3 = rv(vi[i], nv) * 3;
          d->pos.push_back(vs[v3]); d->pos.push_back(vs[v3 + 1]);
          d->pos.push_back(vs[v3 + 2]);
          if (ni[i] != 0) {
            int n3 = rv(ni[i], nn) * 3;
            d->nrm.push_back(vns[n3]); d->nrm.push_back(vns[n3 + 1]);
            d->nrm.push_back(vns[n3 + 2]);
          } else {
            d->nrm.push_back(0); d->nrm.push_back(0); d->nrm.push_back(0);
          }
          if (ti[i] != 0) {
            int t2 = rv(ti[i], nt) * 2;
            d->uv.push_back(vts[t2]); d->uv.push_back(vts[t2 + 1]);
          } else {
            d->uv.push_back(0); d->uv.push_back(0);
          }
        }
        d->mat.push_back(cur_mat);
        ++d->n_tris;
      }
    } else if (line_end - q > 7 && !strncmp(q, "usemtl", 6)) {
      const char* name = skip_ws(q + 6, line_end);
      size_t sz = line_end - name;
      while (sz && (name[sz - 1] == '\r' || name[sz - 1] == ' ')) --sz;
      d->mat_names.insert(d->mat_names.end(), name, name + sz);
      d->mat_names.push_back('\0');
      cur_mat = d->n_mats++;
    } else if (line_end - q > 7 && !strncmp(q, "mtllib", 6)) {
      const char* name = skip_ws(q + 6, line_end);
      size_t sz = line_end - name;
      while (sz && (name[sz - 1] == '\r' || name[sz - 1] == ' ')) --sz;
      d->mtllibs.insert(d->mtllibs.end(), name, name + sz);
      d->mtllibs.push_back('\0');
    }
    p = line_end + 1;
  }
  return d;
}

extern "C" int32_t obj_n_tris(void* h) { return ((ObjData*)h)->n_tris; }
extern "C" int32_t obj_n_mats(void* h) { return ((ObjData*)h)->n_mats; }
extern "C" int64_t obj_names_len(void* h) { return (int64_t)((ObjData*)h)->mat_names.size(); }
extern "C" int64_t obj_mtllibs_len(void* h) { return (int64_t)((ObjData*)h)->mtllibs.size(); }

extern "C" void obj_fetch(void* h, float* pos, float* nrm, float* uv,
                          int32_t* mat, char* names, char* mtllibs) {
  auto* d = (ObjData*)h;
  memcpy(pos, d->pos.data(), d->pos.size() * 4);
  memcpy(nrm, d->nrm.data(), d->nrm.size() * 4);
  memcpy(uv, d->uv.data(), d->uv.size() * 4);
  memcpy(mat, d->mat.data(), d->mat.size() * 4);
  if (names && !d->mat_names.empty())
    memcpy(names, d->mat_names.data(), d->mat_names.size());
  if (mtllibs && !d->mtllibs.empty())
    memcpy(mtllibs, d->mtllibs.data(), d->mtllibs.size());
}

extern "C" void obj_free(void* h) { delete (ObjData*)h; }

}  // extern "C"

// --- JPEG decoder ------------------------------------------------------------
// Sequential-DCT baseline (SOF0/SOF1) AND progressive (SOF2) JFIF, 8-bit,
// 1 or 3 components, any sampling factors up to 4x4, DRI/RSTn restarts.
// Plays the role of stb_image's JPEG path (reference TextureCache.cpp:67
// loads the skybox .jpgs and any Sponza asset set via stb, which decodes
// both modes). Progressive scans follow ITU T.81 G.1.2: spectral selection
// (Ss..Se) x successive approximation (Ah/Al), DC interleaved or not, AC
// single-component with EOB runs and refinement-bit passes; coefficients
// accumulate across scans and are dequantized + IDCT'd at EOI.
//
// IDCT is exact float separable. Chroma upsampling is a centered triangle
// filter. Both are within the codec's allowed decoder variance
// (ITU T.81 annex A).

namespace jpegdec {

static const uint8_t kZig[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  uint8_t lens[17] = {0};   // codes per bit length
  uint8_t vals[256] = {0};
  int32_t mincode[17], maxcode[18], valptr[17];
  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += lens[l];
      k += lens[l];
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dc_pred = 0;
  int bw = 0, bh = 0;             // plane size in blocks
  std::vector<uint8_t> plane;     // bw*8 x bh*8 samples
  std::vector<int16_t> coef;      // progressive: 64 per block, zigzag order
};

struct Jpeg {
  int w = 0, h = 0, ncomp = 0;
  bool progressive = false;
  int eobrun = 0;                 // progressive AC end-of-band run
  int hmax = 1, vmax = 1, restart_interval = 0;
  uint16_t qt[4][64] = {{0}};
  Huff hdc[4], hac[4];
  Comp comp[3];
  const uint8_t* data = nullptr;
  int64_t len = 0, pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool marker_pending = false;  // next bytes are a marker: pad, don't consume
  bool ok = false;

  int byte() { return pos < len ? data[pos++] : -1; }

  void refill() {
    while (bitcnt <= 24) {
      int b = 0;
      if (!marker_pending && pos < len) {
        b = data[pos++];
        if (b == 0xFF) {
          int m = pos < len ? data[pos] : 0xD9;
          if (m == 0x00) ++pos;  // stuffed byte
          else { --pos; marker_pending = true; b = 0; }  // leave pos AT 0xFF
        }
      }
      bitbuf |= (uint32_t)b << (24 - bitcnt);
      bitcnt += 8;
    }
  }

  int getbits(int n) {
    if (n == 0) return 0;
    refill();
    int v = (int)(bitbuf >> (32 - n));
    bitbuf <<= n;
    bitcnt -= n;
    return v;
  }

  int decode_huff(const Huff& t) {
    refill();
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | (int)(bitbuf >> 31);
      bitbuf <<= 1;
      --bitcnt;
      if (code <= t.maxcode[l])
        return t.vals[t.valptr[l] + code - t.mincode[l]];
    }
    return -1;
  }

  static int extend(int v, int s) {
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
  }

  bool decode_block(Comp& c, float* out) {
    int zz[64] = {0};
    int s = decode_huff(hdc[c.td]);
    if (s < 0 || s > 11) return false;
    c.dc_pred += extend(getbits(s), s);
    zz[0] = c.dc_pred;
    for (int k = 1; k < 64;) {
      int rs = decode_huff(hac[c.ta]);
      if (rs < 0) return false;
      int r = rs >> 4, sz = rs & 15;
      if (sz == 0) {
        if (r == 15) { k += 16; continue; }  // ZRL
        break;                                // EOB
      }
      k += r;
      if (k > 63) return false;
      zz[k++] = extend(getbits(sz), sz);
    }
    const uint16_t* q = qt[c.tq];
    for (int k = 0; k < 64; ++k) out[kZig[k]] = (float)(zz[k] * q[k]);
    return true;
  }

  // --- progressive scan passes (ITU T.81 G.1.2) --------------------------

  bool dc_block(Comp& c, int16_t* cf, int Ah, int Al) {
    if (Ah == 0) {                 // first DC pass at this precision
      int s = decode_huff(hdc[c.td]);
      if (s < 0 || s > 11) return false;
      c.dc_pred += extend(getbits(s), s);
      cf[0] = (int16_t)(c.dc_pred << Al);
    } else {                       // refinement: one bit per block
      if (getbits(1)) cf[0] = (int16_t)(cf[0] | (1 << Al));
    }
    return true;
  }

  bool ac_first(Comp& c, int16_t* cf, int Ss, int Se, int Al) {
    if (eobrun > 0) { --eobrun; return true; }
    for (int k = Ss; k <= Se;) {
      int rs = decode_huff(hac[c.ta]);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r < 15) {              // EOBn: run of (1<<r)-1 + bits blocks
          eobrun = (1 << r) - 1;
          if (r) eobrun += getbits(r);
          break;
        }
        k += 16;                   // ZRL
      } else {
        k += r;
        if (k > 63) return false;
        cf[k++] = (int16_t)(extend(getbits(s), s) << Al);
      }
    }
    return true;
  }

  bool ac_refine(Comp& c, int16_t* cf, int Ss, int Se, int Al) {
    const int bit = 1 << Al;
    int k = Ss;
    if (eobrun == 0) {
      while (k <= Se) {
        int rs = decode_huff(hac[c.ta]);
        if (rs < 0) return false;
        int r = rs >> 4, s = rs & 15;
        int newval = 0;
        if (s == 0) {
          if (r < 15) {            // EOBn includes THIS block's tail
            eobrun = (1 << r);
            if (r) eobrun += getbits(r);
            break;
          }
          // ZRL: skip 16 zero-history coefficients (r == 15)
        } else {                   // s must be 1: a new +-(1<<Al) coef
          newval = getbits(1) ? bit : -bit;
        }
        while (k <= Se) {          // advance: correct nonzeros, count zeros
          int16_t& cc = cf[k];
          if (cc != 0) {
            if (getbits(1) && !(cc & bit))
              cc = (int16_t)(cc + (cc > 0 ? bit : -bit));
            ++k;
          } else {
            if (r == 0) {
              if (newval) cc = (int16_t)newval;
              ++k;
              break;
            }
            --r;
            ++k;
          }
        }
      }
    }
    if (eobrun > 0) {              // correction bits through Se, then count
      for (; k <= Se; ++k) {
        int16_t& cc = cf[k];
        if (cc != 0 && getbits(1) && !(cc & bit))
          cc = (int16_t)(cc + (cc > 0 ? bit : -bit));
      }
      --eobrun;
    }
    return true;
  }
};

// exact separable float IDCT (precomputed cos basis), then level shift
static void idct8x8(const float* in, uint8_t* out, int stride) {
  static float cs[8][8];
  static bool init = false;
  if (!init) {
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u)
        cs[x][u] = (u == 0 ? 0.353553390593f : 0.5f) *
                   cosf((2 * x + 1) * u * 3.14159265358979f / 16.0f);
    init = true;
  }
  float tmp[64];
  for (int y = 0; y < 8; ++y)       // rows: sum over u
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int u = 0; u < 8; ++u) s += cs[x][u] * in[y * 8 + u];
      tmp[y * 8 + x] = s;
    }
  for (int x = 0; x < 8; ++x)       // cols: sum over v
    for (int y = 0; y < 8; ++y) {
      float s = 0;
      for (int v = 0; v < 8; ++v) s += cs[y][v] * tmp[v * 8 + x];
      int p = (int)lrintf(s) + 128;
      out[y * stride + x] = (uint8_t)(p < 0 ? 0 : p > 255 ? 255 : p);
    }
}

// one progressive scan: DC interleaved over MCUs (ns > 1) or a single
// component over its effective block grid (DC or AC, first or refine)
static bool decode_prog_scan(Jpeg& J, int ns, const int* scomp, int Ss,
                             int Se, int Ah, int Al, int mcux, int mcuy) {
  J.bitbuf = 0; J.bitcnt = 0; J.marker_pending = false; J.eobrun = 0;
  for (int i = 0; i < J.ncomp; ++i) J.comp[i].dc_pred = 0;
  if (Ss == 0 && Se != 0) return false;   // DC scan is exactly [0,0]
  if (Ss != 0 && ns != 1) return false;   // AC scans are single-component
  int todo = J.restart_interval ? J.restart_interval : 0x7fffffff;
  auto restart = [&J, &todo]() {
    J.bitbuf = 0; J.bitcnt = 0; J.marker_pending = false; J.eobrun = 0;
    while (J.pos + 1 < J.len &&
           !(J.data[J.pos] == 0xFF && J.data[J.pos + 1] >= 0xD0 &&
             J.data[J.pos + 1] <= 0xD7))
      ++J.pos;
    if (J.pos + 1 < J.len) J.pos += 2;
    for (int i = 0; i < J.ncomp; ++i) J.comp[i].dc_pred = 0;
    todo = J.restart_interval;
  };
  if (Ss == 0 && ns > 1) {
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        if (todo == 0) restart();
        for (int i = 0; i < ns; ++i) {
          Comp& c = J.comp[scomp[i]];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t bi = (size_t)(my * c.v + by) * c.bw + (mx * c.h + bx);
              if (!J.dc_block(c, &c.coef[bi * 64], Ah, Al)) return false;
            }
        }
        --todo;
      }
  } else {
    Comp& c = J.comp[scomp[0]];
    int bw_eff = (J.w * c.h + 8 * J.hmax - 1) / (8 * J.hmax);
    int bh_eff = (J.h * c.v + 8 * J.vmax - 1) / (8 * J.vmax);
    for (int by = 0; by < bh_eff; ++by)
      for (int bx = 0; bx < bw_eff; ++bx) {
        if (todo == 0) restart();
        int16_t* cf = &c.coef[((size_t)by * c.bw + bx) * 64];
        bool okb = (Ss == 0) ? J.dc_block(c, cf, Ah, Al)
                 : (Ah == 0) ? J.ac_first(c, cf, Ss, Se, Al)
                             : J.ac_refine(c, cf, Ss, Se, Al);
        if (!okb) return false;
        --todo;
      }
  }
  return true;
}

// all scans seen: dequantize the accumulated coefficients and IDCT
static bool finish_progressive(Jpeg& J) {
  float blk[64];
  for (int i = 0; i < J.ncomp; ++i) {
    Comp& c = J.comp[i];
    const uint16_t* q = J.qt[c.tq];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* cf = &c.coef[((size_t)by * c.bw + bx) * 64];
        for (int k = 0; k < 64; ++k) blk[kZig[k]] = (float)(cf[k] * q[k]);
        idct8x8(blk, c.plane.data() + (size_t)by * 8 * c.bw * 8 + bx * 8,
                c.bw * 8);
      }
    c.coef.clear();
    c.coef.shrink_to_fit();
  }
  J.ok = true;
  return true;
}

static bool parse(Jpeg& J) {
  if (J.len < 4 || J.data[0] != 0xFF || J.data[1] != 0xD8) return false;
  J.pos = 2;
  bool have_sof = false;
  while (J.pos + 3 < J.len) {
    if (J.data[J.pos] != 0xFF) return false;
    int m = J.data[J.pos + 1];
    J.pos += 2;
    if (m == 0xD9) break;                      // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    int seg = (J.data[J.pos] << 8) | J.data[J.pos + 1];
    int64_t next = J.pos + seg;
    J.pos += 2;
    if (m == 0xDB) {                           // DQT
      while (J.pos < next) {
        int pq_tq = J.byte();
        int tq = pq_tq & 15, pq = pq_tq >> 4;
        if (tq > 3) return false;
        for (int k = 0; k < 64; ++k)
          J.qt[tq][k] = pq ? (uint16_t)((J.byte() << 8) | J.byte())
                           : (uint16_t)J.byte();
      }
    } else if (m == 0xC4) {                    // DHT
      while (J.pos < next) {
        int tc_th = J.byte();
        Huff& t = (tc_th >> 4) ? J.hac[tc_th & 3] : J.hdc[tc_th & 3];
        int total = 0;
        for (int l = 1; l <= 16; ++l) total += (t.lens[l] = (uint8_t)J.byte());
        if (total > 256) return false;
        for (int k = 0; k < total; ++k) t.vals[k] = (uint8_t)J.byte();
        t.build();
      }
    } else if (m == 0xC0 || m == 0xC1 || m == 0xC2) {  // SOF0/1/2
      J.progressive = (m == 0xC2);
      J.byte();  // precision (8)
      J.h = (J.byte() << 8) | J.byte();
      J.w = (J.byte() << 8) | J.byte();
      J.ncomp = J.byte();
      if (J.ncomp != 1 && J.ncomp != 3) return false;
      for (int i = 0; i < J.ncomp; ++i) {
        Comp& c = J.comp[i];
        c.id = J.byte();
        int hv = J.byte();
        c.h = hv >> 4; c.v = hv & 15;
        c.tq = J.byte();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return false;
        if (c.h > J.hmax) J.hmax = c.h;
        if (c.v > J.vmax) J.vmax = c.v;
      }
      have_sof = true;
    } else if (m == 0xDD) {                    // DRI
      J.restart_interval = (J.data[J.pos] << 8) | J.data[J.pos + 1];
    } else if (m == 0xDA) {                    // SOS -> entropy data
      if (!have_sof) return false;
      int ns = J.byte();
      if (ns < 1 || ns > J.ncomp) return false;
      if (!J.progressive && ns != J.ncomp) return false;
      int scomp[3] = {0, 0, 0};
      for (int i = 0; i < ns; ++i) {
        int id = J.byte(), tt = J.byte();
        for (int k = 0; k < J.ncomp; ++k)
          if (J.comp[k].id == id) {
            scomp[i] = k;
            J.comp[k].td = tt >> 4;
            J.comp[k].ta = tt & 15;
          }
      }
      int Ss = J.byte(), Se = J.byte(), AhAl = J.byte();

      int mcux = (J.w + 8 * J.hmax - 1) / (8 * J.hmax);
      int mcuy = (J.h + 8 * J.vmax - 1) / (8 * J.vmax);
      if (J.comp[0].plane.empty()) {   // first scan: allocate planes
        for (int i = 0; i < J.ncomp; ++i) {
          Comp& c = J.comp[i];
          c.bw = mcux * c.h;
          c.bh = mcuy * c.v;
          c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
          if (J.progressive) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
      }
      if (J.progressive) {
        if (!decode_prog_scan(J, ns, scomp, Ss, Se, AhAl >> 4, AhAl & 15,
                              mcux, mcuy))
          return false;
        // resync: skip entropy remainder + RSTs to the next real marker
        J.bitbuf = 0; J.bitcnt = 0; J.marker_pending = false;
        while (J.pos + 1 < J.len &&
               !(J.data[J.pos] == 0xFF && J.data[J.pos + 1] != 0x00 &&
                 !(J.data[J.pos + 1] >= 0xD0 && J.data[J.pos + 1] <= 0xD7)))
          ++J.pos;
        continue;
      }
      int todo = J.restart_interval ? J.restart_interval : 0x7fffffff;
      float blk[64];
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (todo == 0) {  // align to byte, expect RSTn
            J.bitbuf = 0; J.bitcnt = 0; J.marker_pending = false;
            while (J.pos + 1 < J.len &&
                   !(J.data[J.pos] == 0xFF && J.data[J.pos + 1] >= 0xD0 &&
                     J.data[J.pos + 1] <= 0xD7))
              ++J.pos;
            if (J.pos + 1 < J.len) J.pos += 2;
            for (int i = 0; i < J.ncomp; ++i) J.comp[i].dc_pred = 0;
            todo = J.restart_interval;
          }
          for (int i = 0; i < J.ncomp; ++i) {
            Comp& c = J.comp[i];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx) {
                if (!J.decode_block(c, blk)) return false;
                int px = (mx * c.h + bx) * 8, py = (my * c.v + by) * 8;
                idct8x8(blk, c.plane.data() + (size_t)py * c.bw * 8 + px,
                        c.bw * 8);
              }
          }
          --todo;
        }
      J.ok = true;
      return true;
    }
    J.pos = next;
  }
  // progressive streams land here at EOI (or truncated input) with the
  // coefficients accumulated across every scan seen
  if (J.progressive && !J.comp[0].coef.empty()) return finish_progressive(J);
  return false;
}

}  // namespace jpegdec

extern "C" {

void* jpeg_parse(const uint8_t* data, int64_t len) {
  auto* J = new jpegdec::Jpeg();
  J->data = data;
  J->len = len;
  if (!jpegdec::parse(*J)) { delete J; return nullptr; }
  return J;
}

int32_t jpeg_width(void* h) { return ((jpegdec::Jpeg*)h)->w; }
int32_t jpeg_height(void* h) { return ((jpegdec::Jpeg*)h)->h; }

// out: w*h*4 RGBA8 (alpha 255); JFIF YCbCr -> RGB. Subsampled chroma is
// upsampled with a centered triangle (bilinear) filter — the same weights
// as libjpeg's "fancy" 2x upsampling, generalized to any factor.
void jpeg_fetch_rgba(void* hnd, uint8_t* out) {
  auto& J = *(jpegdec::Jpeg*)hnd;
  for (int y = 0; y < J.h; ++y)
    for (int x = 0; x < J.w; ++x) {
      uint8_t* px = out + ((size_t)y * J.w + x) * 4;
      if (J.ncomp == 1) {
        const jpegdec::Comp& c = J.comp[0];
        uint8_t g = c.plane[(size_t)y * c.bw * 8 + x];
        px[0] = px[1] = px[2] = g;
      } else {
        float ycc[3];
        for (int i = 0; i < 3; ++i) {
          const jpegdec::Comp& c = J.comp[i];
          int stride = c.bw * 8;
          if (c.h == J.hmax && c.v == J.vmax) {
            ycc[i] = (float)c.plane[(size_t)y * stride + x];
            continue;
          }
          int cw = (J.w * c.h + J.hmax - 1) / J.hmax;   // valid chroma extent
          int ch = (J.h * c.v + J.vmax - 1) / J.vmax;
          float fx = (x + 0.5f) * c.h / J.hmax - 0.5f;
          float fy = (y + 0.5f) * c.v / J.vmax - 0.5f;
          int x0 = (int)floorf(fx), y0 = (int)floorf(fy);
          float ax = fx - x0, ay = fy - y0;
          int x1 = x0 + 1, y1 = y0 + 1;
          x0 = x0 < 0 ? 0 : x0 >= cw ? cw - 1 : x0;
          x1 = x1 < 0 ? 0 : x1 >= cw ? cw - 1 : x1;
          y0 = y0 < 0 ? 0 : y0 >= ch ? ch - 1 : y0;
          y1 = y1 < 0 ? 0 : y1 >= ch ? ch - 1 : y1;
          const uint8_t* pl = c.plane.data();
          float t = pl[(size_t)y0 * stride + x0] * (1 - ax) +
                    pl[(size_t)y0 * stride + x1] * ax;
          float b = pl[(size_t)y1 * stride + x0] * (1 - ax) +
                    pl[(size_t)y1 * stride + x1] * ax;
          ycc[i] = t * (1 - ay) + b * ay;
        }
        float Y = ycc[0], cb = ycc[1] - 128.0f, cr = ycc[2] - 128.0f;
        float r = Y + 1.402f * cr;
        float g = Y - 0.344136f * cb - 0.714136f * cr;
        float b = Y + 1.772f * cb;
        px[0] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : (int)lrintf(r));
        px[1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : (int)lrintf(g));
        px[2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : (int)lrintf(b));
      }
      px[3] = 255;
    }
}

void jpeg_free(void* h) { delete (jpegdec::Jpeg*)h; }

}  // extern "C"
