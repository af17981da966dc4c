// Native inference runtime — the C++ rebuild of libVeles/libZnicz
// (SURVEY.md §3.2 "near-native adjacent repos": a C++ inference-only
// runtime loading exported workflow packages; §4.5 forward-only path).
//
// Loads a znicz_tpu forward package (utils/export.py: one .npz = ZIP of
// .npy members + an __arch__ JSON manifest) STANDALONE — no Python, no
// JAX — and runs the forward chain on the host CPU in f32.  This is the
// deployment artifact: the training stack exports, this serves.
//
// Supported layer types (the exported zoo's forward set): all2all{,_tanh,
// _relu,_str,_sigmoid}, softmax, conv{,_tanh,_relu,_str,_sigmoid},
// max/maxabs/avg pooling, norm (LRN), dropout (inference = identity).
// Geometry and activation formulas mirror znicz_tpu.ops exactly
// (ops/activations.py, ops/conv.py::normalize_geometry/out_size,
// ops/pooling.py::pool_out_size + clipped-border windows,
// ops/lrn.py::window_sum asymmetric even-n centring).
//
// Exposed via ctypes (znicz_tpu/native/infer.py), like loader_core.cpp.
// Build: g++ -O3 -shared -fPIC -std=c++17 infer_core.cpp -lz

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// minimal JSON (objects/arrays/strings/numbers/bools/null — the manifest
// subset json.dumps emits)
// ---------------------------------------------------------------------------
struct JValue {
    enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
    bool b = false;
    double num = 0.0;
    std::string str;
    std::vector<JValue> arr;
    std::map<std::string, JValue> obj;
};

struct JParser {
    const char *p, *end;
    std::string err;
    explicit JParser(const std::string &s) : p(s.data()), end(s.data() + s.size()) {}
    void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; }
    bool fail(const char *m) { if (err.empty()) err = m; return false; }
    bool parse(JValue &v) {
        ws();
        if (p >= end) return fail("eof");
        char c = *p;
        if (c == '{') return obj(v);
        if (c == '[') return arr(v);
        if (c == '"') { v.kind = JValue::STR; return str(v.str); }
        if (c == 't') { v.kind = JValue::BOOL; v.b = true; return lit("true"); }
        if (c == 'f') { v.kind = JValue::BOOL; v.b = false; return lit("false"); }
        if (c == 'n') { v.kind = JValue::NUL; return lit("null"); }
        return num(v);
    }
    bool lit(const char *s) {
        size_t n = strlen(s);
        if ((size_t)(end - p) < n || strncmp(p, s, n) != 0) return fail("bad literal");
        p += n;
        return true;
    }
    bool num(JValue &v) {
        char *e = nullptr;
        v.num = strtod(p, &e);
        if (e == p) return fail("bad number");
        v.kind = JValue::NUM;
        p = e;
        return true;
    }
    bool str(std::string &out) {
        if (*p != '"') return fail("expect string");
        ++p;
        out.clear();
        while (p < end && *p != '"') {
            if (*p == '\\' && p + 1 < end) {
                ++p;
                switch (*p) {
                    case 'n': out += '\n'; break;
                    case 't': out += '\t'; break;
                    case 'r': out += '\r'; break;
                    case 'u': {  // manifest strings are ASCII; keep low byte
                        if (end - p < 5) return fail("bad \\u");
                        unsigned code = (unsigned)strtoul(std::string(p + 1, 4).c_str(), nullptr, 16);
                        out += (char)(code & 0x7F);
                        p += 4;
                        break;
                    }
                    default: out += *p;
                }
            } else {
                out += *p;
            }
            ++p;
        }
        if (p >= end) return fail("unterminated string");
        ++p;
        return true;
    }
    bool arr(JValue &v) {
        v.kind = JValue::ARR;
        ++p;
        ws();
        if (p < end && *p == ']') { ++p; return true; }
        while (true) {
            v.arr.emplace_back();
            if (!parse(v.arr.back())) return false;
            ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == ']') { ++p; return true; }
            return fail("expect , or ]");
        }
    }
    bool obj(JValue &v) {
        v.kind = JValue::OBJ;
        ++p;
        ws();
        if (p < end && *p == '}') { ++p; return true; }
        while (true) {
            ws();
            std::string key;
            if (!str(key)) return false;
            ws();
            if (p >= end || *p != ':') return fail("expect :");
            ++p;
            if (!parse(v.obj[key])) return false;
            ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == '}') { ++p; return true; }
            return fail("expect , or }");
        }
    }
};

// ---------------------------------------------------------------------------
// ZIP reader (stored + deflate members, EOCD + central directory walk)
// ---------------------------------------------------------------------------
uint32_t rd32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
uint16_t rd16(const uint8_t *p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

bool zip_members(const std::vector<uint8_t> &buf,
                 std::map<std::string, std::vector<uint8_t>> &out,
                 std::string &err) {
    if (buf.size() < 22) { err = "file too small for a zip"; return false; }
    // EOCD scan from the back (comment can pad up to 64 KiB)
    size_t lo = buf.size() > (1 << 16) + 22 ? buf.size() - ((1 << 16) + 22) : 0;
    size_t eocd = std::string::npos;
    for (size_t i = buf.size() - 22 + 1; i-- > lo;) {
        if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
    }
    if (eocd == std::string::npos) { err = "no zip end-of-central-directory"; return false; }
    uint16_t n_entries = rd16(&buf[eocd + 10]);
    uint32_t cd_off = rd32(&buf[eocd + 16]);
    size_t p = cd_off;
    for (uint16_t e = 0; e < n_entries; ++e) {
        if (p + 46 > buf.size() || rd32(&buf[p]) != 0x02014b50) {
            err = "corrupt central directory";
            return false;
        }
        uint16_t method = rd16(&buf[p + 10]);
        uint32_t csize = rd32(&buf[p + 20]);
        uint32_t usize = rd32(&buf[p + 24]);
        uint16_t nlen = rd16(&buf[p + 28]);
        uint16_t xlen = rd16(&buf[p + 30]);
        uint16_t clen = rd16(&buf[p + 32]);
        uint32_t lho = rd32(&buf[p + 42]);
        std::string name((const char *)&buf[p + 46], nlen);
        p += 46 + nlen + xlen + clen;
        if (lho + 30 > buf.size() || rd32(&buf[lho]) != 0x04034b50) {
            err = "corrupt local header for " + name;
            return false;
        }
        uint16_t lnlen = rd16(&buf[lho + 26]);
        uint16_t lxlen = rd16(&buf[lho + 28]);
        size_t data = lho + 30 + lnlen + lxlen;
        if (data + csize > buf.size()) { err = "truncated member " + name; return false; }
        std::vector<uint8_t> raw(usize);
        if (method == 0) {
            if (csize != usize) { err = "stored size mismatch " + name; return false; }
            memcpy(raw.data(), &buf[data], usize);
        } else if (method == 8) {
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) { err = "zlib init failed"; return false; }
            zs.next_in = const_cast<Bytef *>(&buf[data]);
            zs.avail_in = csize;
            zs.next_out = raw.data();
            zs.avail_out = usize;
            int rc = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (rc != Z_STREAM_END) { err = "inflate failed for " + name; return false; }
        } else {
            err = "unsupported zip method for " + name;
            return false;
        }
        out[name] = std::move(raw);
    }
    return true;
}

// ---------------------------------------------------------------------------
// NPY parser ('<f4' tensors + the '<U#' 0-d manifest string, C order)
// ---------------------------------------------------------------------------
struct Tensor {
    std::vector<int64_t> shape;
    std::vector<float> data;
    int64_t numel() const {
        int64_t n = 1;
        for (int64_t d : shape) n *= d;
        return n;
    }
};

bool npy_header(const std::vector<uint8_t> &raw, std::string &descr,
                std::vector<int64_t> &shape, size_t &data_off,
                std::string &err) {
    if (raw.size() < 10 || memcmp(raw.data(), "\x93NUMPY", 6) != 0) {
        err = "not an npy member";
        return false;
    }
    uint8_t major = raw[6];
    size_t hlen, hoff;
    if (major == 1) {
        hlen = rd16(&raw[8]);
        hoff = 10;
    } else {
        if (raw.size() < 12) { err = "truncated npy v2 header"; return false; }
        hlen = rd32(&raw[8]);
        hoff = 12;
    }
    if (hoff + hlen > raw.size()) { err = "truncated npy header"; return false; }
    std::string hdr((const char *)&raw[hoff], hlen);
    data_off = hoff + hlen;
    auto find_val = [&](const char *key) -> std::string {
        size_t k = hdr.find(key);
        if (k == std::string::npos) return "";
        k = hdr.find(':', k);
        return k == std::string::npos ? "" : hdr.substr(k + 1);
    };
    std::string d = find_val("'descr'");
    size_t q0 = d.find('\'');
    size_t q1 = d.find('\'', q0 + 1);
    if (q0 == std::string::npos || q1 == std::string::npos) { err = "bad descr"; return false; }
    descr = d.substr(q0 + 1, q1 - q0 - 1);
    if (find_val("'fortran_order'").substr(0, 6).find("True") != std::string::npos) {
        err = "fortran order unsupported";
        return false;
    }
    std::string s = find_val("'shape'");
    size_t o = s.find('(');
    size_t c = s.find(')');
    if (o == std::string::npos || c == std::string::npos) { err = "bad shape"; return false; }
    shape.clear();
    std::string body = s.substr(o + 1, c - o - 1);
    const char *q = body.c_str();
    while (*q) {
        while (*q && (*q == ' ' || *q == ',')) ++q;
        if (!*q) break;
        shape.push_back(strtoll(q, const_cast<char **>(&q), 10));
    }
    return true;
}

bool npy_f32(const std::vector<uint8_t> &raw, Tensor &t, std::string &err) {
    std::string descr;
    size_t off;
    if (!npy_header(raw, descr, t.shape, off, err)) return false;
    int64_t n = t.numel();
    t.data.resize(n);
    if (descr == "<f4") {
        if (off + 4 * n > raw.size()) { err = "truncated f4 data"; return false; }
        memcpy(t.data.data(), &raw[off], 4 * n);
    } else if (descr == "<f8") {
        if (off + 8 * n > raw.size()) { err = "truncated f8 data"; return false; }
        const double *src = (const double *)&raw[off];
        for (int64_t i = 0; i < n; ++i) t.data[i] = (float)src[i];
    } else {
        err = "unsupported npy dtype " + descr;
        return false;
    }
    return true;
}

bool npy_ustring(const std::vector<uint8_t> &raw, std::string &out,
                 std::string &err) {
    std::string descr;
    std::vector<int64_t> shape;
    size_t off;
    if (!npy_header(raw, descr, shape, off, err)) return false;
    if (descr.size() < 2 || descr.substr(0, 2) != "<U") {
        err = "manifest is not a <U string array";
        return false;
    }
    int64_t nchars = strtoll(descr.c_str() + 2, nullptr, 10);
    out.clear();
    for (int64_t i = 0; i < nchars; ++i) {  // UCS4 LE; manifest is ASCII
        if (off + 4 * i + 4 > raw.size()) break;
        uint32_t cp = rd32(&raw[off + 4 * i]);
        if (cp == 0) break;
        out += (char)(cp & 0x7F);
    }
    return true;
}

// ---------------------------------------------------------------------------
// layers
// ---------------------------------------------------------------------------
struct Layer {
    std::string type;
    Tensor w, b;
    bool has_w = false, has_b = false;
    // kx/ky default 2 — the Pooling units' Python default
    // (units/pooling.py); conv layers always carry explicit kx/ky
    // (Conv.__init__ requires them)
    int kx = 2, ky = 2, sy = 1, sx = 1, pt = 0, pb = 0, pl = 0, pr = 0;
    float alpha = 1e-4f, beta = 0.75f, k = 2.0f;
    int n = 5;
};

struct Model {
    std::vector<Layer> layers;
    std::vector<int64_t> in_shape;  // per-sample
    int64_t out_numel = 0;          // validated at load
    std::string name;
    std::string err;
};

int conv_out_size(int size, int k, int stride, int pad0, int pad1) {
    return (size + pad0 + pad1 - k) / stride + 1;  // ops/conv.py::out_size
}

int pool_out_size(int size, int k, int stride) {  // ops/pooling.py semantics
    if (size <= k) return 1;
    int out = (size - k + stride - 1) / stride + 1;
    if ((out - 1) * stride >= size) out -= 1;
    return out;
}

float activate(const std::string &type, float v) {
    // ops/activations.py — formulas verbatim, suffix selects
    if (type.size() >= 5 && type.compare(type.size() - 5, 5, "_tanh") == 0)
        return 1.7159f * tanhf((2.0f / 3.0f) * v);
    if (type.size() >= 5 && type.compare(type.size() - 5, 5, "_relu") == 0)
        return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));  // soft relu
    if (type.size() >= 4 && type.compare(type.size() - 4, 4, "_str") == 0)
        return fmaxf(0.0f, v);
    if (type.size() >= 8 && type.compare(type.size() - 8, 8, "_sigmoid") == 0)
        return 1.0f / (1.0f + expf(-v));
    return v;  // linear
}

// fc: x (B, F) @ W (F, O) + b, activation or softmax
void run_fc(const Layer &L, const Tensor &x, Tensor &y) {
    int64_t B = x.shape[0];
    int64_t F = x.numel() / B;
    int64_t O = L.w.shape[1];
    y.shape = {B, O};
    y.data.assign(B * O, 0.0f);
    for (int64_t i = 0; i < B; ++i) {
        const float *xi = &x.data[i * F];
        float *yi = &y.data[i * O];
        for (int64_t f = 0; f < F; ++f) {
            float xv = xi[f];
            const float *wf = &L.w.data[f * O];
            for (int64_t o = 0; o < O; ++o) yi[o] += xv * wf[o];
        }
        if (L.has_b)
            for (int64_t o = 0; o < O; ++o) yi[o] += L.b.data[o];
        if (L.type == "softmax") {  // row-max-subtract exp-normalize
            float m = yi[0];
            for (int64_t o = 1; o < O; ++o) m = fmaxf(m, yi[o]);
            float s = 0.0f;
            for (int64_t o = 0; o < O; ++o) { yi[o] = expf(yi[o] - m); s += yi[o]; }
            for (int64_t o = 0; o < O; ++o) yi[o] /= s;
        } else {
            for (int64_t o = 0; o < O; ++o) yi[o] = activate(L.type, yi[o]);
        }
    }
}

// conv: NHWC x, HWIO w — ops/conv.py::forward_linear + activation
void run_conv(const Layer &L, const Tensor &x, Tensor &y) {
    int64_t B = x.shape[0], H = x.shape[1], W = x.shape[2], C = x.shape[3];
    int64_t KO = L.w.shape[3];
    int OH = conv_out_size((int)H, L.ky, L.sy, L.pt, L.pb);
    int OW = conv_out_size((int)W, L.kx, L.sx, L.pl, L.pr);
    y.shape = {B, OH, OW, KO};
    y.data.assign(B * OH * OW * KO, 0.0f);
    for (int64_t b = 0; b < B; ++b)
        for (int oy = 0; oy < OH; ++oy)
            for (int ox = 0; ox < OW; ++ox) {
                float *yo = &y.data[((b * OH + oy) * OW + ox) * KO];
                for (int iy = 0; iy < L.ky; ++iy) {
                    int64_t srcy = (int64_t)oy * L.sy + iy - L.pt;
                    if (srcy < 0 || srcy >= H) continue;
                    for (int ix = 0; ix < L.kx; ++ix) {
                        int64_t srcx = (int64_t)ox * L.sx + ix - L.pl;
                        if (srcx < 0 || srcx >= W) continue;
                        const float *xi = &x.data[((b * H + srcy) * W + srcx) * C];
                        const float *wk = &L.w.data[((int64_t)iy * L.kx + ix) * C * KO];
                        for (int64_t c = 0; c < C; ++c) {
                            float xv = xi[c];
                            const float *wc = &wk[c * KO];
                            for (int64_t o = 0; o < KO; ++o) yo[o] += xv * wc[o];
                        }
                    }
                }
                if (L.has_b)
                    for (int64_t o = 0; o < KO; ++o) yo[o] += L.b.data[o];
                for (int64_t o = 0; o < KO; ++o) yo[o] = activate(L.type, yo[o]);
            }
}

// pooling: clipped-border windows (ops/pooling.py)
void run_pool(const Layer &L, const Tensor &x, Tensor &y) {
    int64_t B = x.shape[0], H = x.shape[1], W = x.shape[2], C = x.shape[3];
    int OH = pool_out_size((int)H, L.ky, L.sy);
    int OW = pool_out_size((int)W, L.kx, L.sx);
    bool is_max = L.type == "max_pooling";
    bool is_abs = L.type == "maxabs_pooling";
    y.shape = {B, OH, OW, C};
    y.data.assign(B * OH * OW * C, 0.0f);
    for (int64_t b = 0; b < B; ++b)
        for (int oy = 0; oy < OH; ++oy)
            for (int ox = 0; ox < OW; ++ox)
                for (int64_t c = 0; c < C; ++c) {
                    float best = -1e30f, best_key = -1e30f, sum = 0.0f;
                    int count = 0;
                    for (int iy = 0; iy < L.ky; ++iy) {
                        int64_t srcy = (int64_t)oy * L.sy + iy;
                        if (srcy >= H) continue;
                        for (int ix = 0; ix < L.kx; ++ix) {
                            int64_t srcx = (int64_t)ox * L.sx + ix;
                            if (srcx >= W) continue;
                            float v = x.data[((b * H + srcy) * W + srcx) * C + c];
                            float key = is_abs ? fabsf(v) : v;
                            if (key > best_key) { best_key = key; best = v; }
                            sum += v;
                            ++count;
                        }
                    }
                    y.data[((b * OH + oy) * OW + ox) * C + c] =
                        (is_max || is_abs) ? best : sum / (float)(count > 0 ? count : 1);
                }
}

// LRN: ops/lrn.py — window n centred (even n: [i-n/2, i+n-1-n/2])
void run_lrn(const Layer &L, const Tensor &x, Tensor &y) {
    int64_t rows = x.numel() / x.shape.back();
    int64_t C = x.shape.back();
    y.shape = x.shape;
    y.data.resize(x.data.size());
    int half = L.n / 2;
    for (int64_t r = 0; r < rows; ++r) {
        const float *xi = &x.data[r * C];
        float *yi = &y.data[r * C];
        for (int64_t c = 0; c < C; ++c) {
            float s = 0.0f;
            for (int j = -half; j <= L.n - 1 - half; ++j) {
                int64_t cc = c + j;
                if (cc >= 0 && cc < C) s += xi[cc] * xi[cc];
            }
            float d = L.k + L.alpha * s;
            yi[c] = xi[c] * powf(d, -L.beta);
        }
    }
}

bool parse_geometry(const JValue &cfg, Layer &L, std::string &err) {
    auto geti = [&](const char *key, int dflt) -> int {
        auto it = cfg.obj.find(key);
        return it == cfg.obj.end() ? dflt : (int)it->second.num;
    };
    L.kx = geti("kx", L.kx);
    L.ky = geti("ky", L.ky);
    auto sl = cfg.obj.find("sliding");
    if (sl != cfg.obj.end()) {
        if (sl->second.kind == JValue::NUM) {
            L.sy = L.sx = (int)sl->second.num;
        } else if (sl->second.arr.size() == 2) {
            L.sy = (int)sl->second.arr[0].num;
            L.sx = (int)sl->second.arr[1].num;
        } else {
            err = "bad sliding";
            return false;
        }
    }
    auto pd = cfg.obj.find("padding");
    if (pd != cfg.obj.end()) {
        const JValue &v = pd->second;
        if (v.kind == JValue::NUM) {
            L.pt = L.pb = L.pl = L.pr = (int)v.num;
        } else if (v.arr.size() == 2) {  // (pt, pl) mirrored
            L.pt = L.pb = (int)v.arr[0].num;
            L.pl = L.pr = (int)v.arr[1].num;
        } else if (v.arr.size() == 4) {
            L.pt = (int)v.arr[0].num;
            L.pb = (int)v.arr[1].num;
            L.pl = (int)v.arr[2].num;
            L.pr = (int)v.arr[3].num;
        } else {
            err = "bad padding";
            return false;
        }
    }
    return true;
}

bool layer_supported(const std::string &t) {
    static const char *kTypes[] = {
        "all2all", "all2all_tanh", "all2all_relu", "all2all_str",
        "all2all_sigmoid", "softmax", "conv", "conv_tanh", "conv_relu",
        "conv_str", "conv_sigmoid", "max_pooling", "maxabs_pooling",
        "avg_pooling", "norm", "dropout"};
    for (const char *k : kTypes)
        if (t == k) return true;
    return false;
}

// Load-time shape propagation + per-layer validation: every run()-path
// assumption (weight ranks, feature counts, NHWC where needed, positive
// geometry) is proved HERE so a bad package fails to load with a named
// reason instead of reading out of bounds later.
bool validate_model(Model &m, std::string &err) {
    std::vector<int64_t> s = m.in_shape;
    for (size_t i = 0; i < m.layers.size(); ++i) {
        const Layer &L = m.layers[i];
        char where[96];
        snprintf(where, sizeof(where), " (layer %zu: %s)", i, L.type.c_str());
        int64_t feats = 1;
        for (int64_t d : s) feats *= d;
        if (L.type.rfind("all2all", 0) == 0 || L.type == "softmax") {
            if (!L.has_w || L.w.shape.size() != 2) {
                err = std::string("fc layer needs rank-2 weights") + where;
                return false;
            }
            if (L.w.shape[0] != feats) {
                err = std::string("fc weight rows != input features") + where;
                return false;
            }
            if (L.has_b && L.b.numel() != L.w.shape[1]) {
                err = std::string("bias size != output width") + where;
                return false;
            }
            s = {L.w.shape[1]};
        } else if (L.type.rfind("conv", 0) == 0) {
            if (s.size() != 3) { err = std::string("conv wants NHWC") + where; return false; }
            if (!L.has_w || L.w.shape.size() != 4) {
                err = std::string("conv layer needs rank-4 HWIO weights") + where;
                return false;
            }
            if (L.ky < 1 || L.kx < 1 || L.sy < 1 || L.sx < 1) {
                err = std::string("bad conv geometry") + where;
                return false;
            }
            if (L.w.shape[0] != L.ky || L.w.shape[1] != L.kx ||
                L.w.shape[2] != s[2]) {
                err = std::string("conv weights do not match geometry/"
                                  "input channels") + where;
                return false;
            }
            int oh = conv_out_size((int)s[0], L.ky, L.sy, L.pt, L.pb);
            int ow = conv_out_size((int)s[1], L.kx, L.sx, L.pl, L.pr);
            if (oh < 1 || ow < 1) {
                err = std::string("conv output collapses to zero") + where;
                return false;
            }
            s = {oh, ow, L.w.shape[3]};
        } else if (L.type.find("pooling") != std::string::npos) {
            if (s.size() != 3) { err = std::string("pooling wants NHWC") + where; return false; }
            if (L.ky < 1 || L.kx < 1 || L.sy < 1 || L.sx < 1) {
                err = std::string("bad pooling geometry") + where;
                return false;
            }
            s = {pool_out_size((int)s[0], L.ky, L.sy),
                 pool_out_size((int)s[1], L.kx, L.sx), s[2]};
        } else if (L.type == "norm") {
            if (L.n < 1) { err = std::string("bad LRN window") + where; return false; }
        }  // dropout keeps shape
    }
    m.out_numel = 1;
    for (int64_t d : s) m.out_numel *= d;
    return true;
}

}  // namespace

extern "C" {

// Load a forward package; returns an opaque handle or nullptr (see
// znicz_infer_error for the reason — the error survives load failure via
// a thread-local slot).
static thread_local std::string g_load_err;

static void *infer_load_impl(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) { g_load_err = std::string("cannot open ") + path; return nullptr; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(sz > 0 ? (size_t)sz : 0);
    if (sz <= 0 || fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
        fclose(f);
        g_load_err = "short read";
        return nullptr;
    }
    fclose(f);

    std::map<std::string, std::vector<uint8_t>> members;
    if (!zip_members(buf, members, g_load_err)) return nullptr;
    auto arch_it = members.find("__arch__.npy");
    if (arch_it == members.end()) { g_load_err = "no __arch__ member"; return nullptr; }
    std::string manifest;
    if (!npy_ustring(arch_it->second, manifest, g_load_err)) return nullptr;
    JParser jp(manifest);
    JValue meta;
    if (!jp.parse(meta)) { g_load_err = "manifest json: " + jp.err; return nullptr; }
    if (meta.obj["format"].str != "znicz_tpu.forward") {
        g_load_err = "not a znicz_tpu.forward package";
        return nullptr;
    }

    auto model = std::make_unique<Model>();
    model->name = meta.obj["name"].str;
    for (const JValue &d : meta.obj["input_shape"].arr)
        model->in_shape.push_back((int64_t)d.num);
    if (model->in_shape.empty()) {
        g_load_err = "manifest carries no input_shape";
        return nullptr;
    }
    const JValue &arch = meta.obj["arch"];
    for (size_t i = 0; i < arch.arr.size(); ++i) {
        const JValue &spec = arch.arr[i];
        Layer L;
        if (!spec.obj.count("type")) {
            g_load_err = "arch entry without a type";
            return nullptr;
        }
        L.type = spec.obj.at("type").str;
        if (!layer_supported(L.type)) {
            g_load_err = "unsupported layer type '" + L.type +
                         "' (native runtime v1 forward set)";
            return nullptr;
        }
        const JValue &cfg = spec.obj.count("config") ? spec.obj.at("config") : JValue();
        if (!parse_geometry(cfg, L, g_load_err)) return nullptr;
        // pooling's default stride is the WINDOW (units/pooling.py:
        // sliding=None -> (ky, kx)); conv's default stays (1, 1)
        if (L.type.find("pooling") != std::string::npos &&
            !cfg.obj.count("sliding")) {
            L.sy = L.ky;
            L.sx = L.kx;
        }
        auto getf = [&](const char *key, float dflt) -> float {
            auto it = cfg.obj.find(key);
            return it == cfg.obj.end() ? dflt : (float)it->second.num;
        };
        L.alpha = getf("alpha", L.alpha);
        L.beta = getf("beta", L.beta);
        L.k = getf("k", L.k);
        L.n = (int)getf("n", (float)L.n);
        char key[64];
        snprintf(key, sizeof(key), "%zu.weights", i);
        auto wit = members.find(std::string(key) + ".npy");
        if (wit != members.end()) {
            if (!npy_f32(wit->second, L.w, g_load_err)) return nullptr;
            L.has_w = true;
        }
        snprintf(key, sizeof(key), "%zu.bias", i);
        auto bit = members.find(std::string(key) + ".npy");
        if (bit != members.end()) {
            if (!npy_f32(bit->second, L.b, g_load_err)) return nullptr;
            L.has_b = true;
        }
        // weights_transposed (All2All.xla_apply_linear uses W.T): honor
        // it by densifying the transpose once at load
        auto wt = cfg.obj.find("weights_transposed");
        if (wt != cfg.obj.end() && wt->second.kind == JValue::BOOL &&
            wt->second.b) {
            if (L.type.rfind("all2all", 0) != 0 && L.type != "softmax") {
                g_load_err = "weights_transposed on a non-fc layer";
                return nullptr;
            }
            if (!L.has_w || L.w.shape.size() != 2) {
                g_load_err = "weights_transposed without rank-2 weights";
                return nullptr;
            }
            Tensor t;
            t.shape = {L.w.shape[1], L.w.shape[0]};
            t.data.resize(L.w.data.size());
            for (int64_t r = 0; r < L.w.shape[0]; ++r)
                for (int64_t c = 0; c < L.w.shape[1]; ++c)
                    t.data[c * L.w.shape[0] + r] =
                        L.w.data[r * L.w.shape[1] + c];
            L.w = std::move(t);
        }
        model->layers.push_back(std::move(L));
    }
    if (!validate_model(*model, g_load_err)) return nullptr;
    return model.release();
}

void *znicz_infer_load(const char *path) {
    g_load_err.clear();
    // nothing may throw across the extern "C"/ctypes boundary
    try {
        return infer_load_impl(path);
    } catch (const std::exception &e) {
        g_load_err = std::string("load failed: ") + e.what();
        return nullptr;
    } catch (...) {
        g_load_err = "load failed: unknown C++ exception";
        return nullptr;
    }
}

const char *znicz_infer_error(void *h) {
    if (!h) return g_load_err.c_str();
    return ((Model *)h)->err.c_str();
}

int znicz_infer_input_rank(void *h) { return (int)((Model *)h)->in_shape.size(); }

void znicz_infer_input_shape(void *h, int64_t *out) {
    Model *m = (Model *)h;
    for (size_t i = 0; i < m->in_shape.size(); ++i) out[i] = m->in_shape[i];
}

// Per-sample output element count (validated at load).
int64_t znicz_infer_output_numel(void *h) {
    return ((Model *)h)->out_numel;
}

// Run the forward chain on (batch, *input_shape) f32 x; writes
// batch * znicz_infer_output_numel floats into out.  Returns 0 on
// success, -1 on error (znicz_infer_error).
static int infer_run_impl(Model *m, const float *x, int64_t batch,
                          float *out) {
    Tensor cur;
    cur.shape = {batch};
    for (int64_t d : m->in_shape) cur.shape.push_back(d);
    cur.data.assign(x, x + cur.numel());
    Tensor next;
    for (const Layer &L : m->layers) {
        if (L.type.rfind("all2all", 0) == 0 || L.type == "softmax") {
            if (!L.has_w || cur.numel() / batch != L.w.shape[0]) {
                m->err = "fc input features do not match weight rows "
                         "(layer " + L.type + ")";
                return -1;
            }
            run_fc(L, cur, next);
        } else if (L.type.rfind("conv", 0) == 0) {
            if (cur.shape.size() != 4) { m->err = "conv wants NHWC"; return -1; }
            run_conv(L, cur, next);
        } else if (L.type.find("pooling") != std::string::npos) {
            if (cur.shape.size() != 4) { m->err = "pooling wants NHWC"; return -1; }
            run_pool(L, cur, next);
        } else if (L.type == "norm") {
            run_lrn(L, cur, next);
        } else if (L.type == "dropout") {
            next = cur;  // inference: identity (DropoutForward.forward_mode)
        } else {
            m->err = "unsupported layer " + L.type;
            return -1;
        }
        cur = std::move(next);
        next = Tensor();
    }
    memcpy(out, cur.data.data(), cur.data.size() * sizeof(float));
    return 0;
}

int znicz_infer_run(void *h, const float *x, int64_t batch, float *out) {
    Model *m = (Model *)h;
    m->err.clear();
    try {
        return infer_run_impl(m, x, batch, out);
    } catch (const std::exception &e) {
        m->err = std::string("run failed: ") + e.what();
        return -1;
    } catch (...) {
        m->err = "run failed: unknown C++ exception";
        return -1;
    }
}

void znicz_infer_free(void *h) { delete (Model *)h; }

}  // extern "C"
