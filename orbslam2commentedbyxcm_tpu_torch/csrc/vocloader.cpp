// DBoW2 text vocabulary parser (ORBvoc.txt format,
// TemplatedVocabulary::loadFromTextFile, Thirdparty/DBoW2/DBoW2/
// TemplatedVocabulary.h:1338) for utils/vocab_tools.py, on the host.
//
// It reads as utils/vocab_tools._parse_dbow2_text_py does, to the bit: lines
// end at "\n", "\r\n" or "\r"; tokens split at ASCII whitespace (with
// \x1c-\x1f, as str.split); the first line's first two tokens are k and L;
// every later line with fewer than 35 tokens is skipped, and one with 35 or
// more is "parent is_leaf d0 .. d31 weight". Integers take int()'s syntax
// (sign, digits, single underscores between digits); the weight takes
// float()'s (no hex), is parsed to double with strtod and then rounded to
// float32, as float() followed by np.asarray(..., np.float32) does.
//
// API: voc_parse scans a buffer the caller read and returns a handle with the
// node count, or null with the failing line and reason; voc_fill copies the
// columns into caller arrays; voc_free releases the handle.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Vocabulary {
    int64_t k = 0, depth = 0;
    std::vector<int32_t> parent;
    std::vector<uint8_t> leaf;
    std::vector<uint8_t> desc;  // 32 bytes per node
    std::vector<float> weight;
};

// reasons reported through info[3]
enum { OK = 0, NO_HEADER = 1, BAD_INT = 2, INT_RANGE = 3, BAD_FLOAT = 4 };

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f' || (c >= 0x1c && c <= 0x1f);
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

struct Token {
    const char* p;
    size_t n;
};

// int(): [+-] digit (_? digit)*, into *out; false on bad syntax or a value
// past +-2^62 (range errors are the caller's).
bool parse_int(Token t, int64_t* out) {
    size_t i = 0;
    bool neg = false;
    if (i < t.n && (t.p[i] == '+' || t.p[i] == '-')) neg = t.p[i++] == '-';
    if (i >= t.n || !is_digit(t.p[i])) return false;
    int64_t v = 0;
    for (; i < t.n; ++i) {
        if (t.p[i] == '_') {
            if (i + 1 >= t.n || !is_digit(t.p[i + 1])) return false;
            continue;
        }
        if (!is_digit(t.p[i])) return false;
        if (v > (int64_t(1) << 62) / 10) return false;
        v = v * 10 + (t.p[i] - '0');
    }
    *out = neg ? -v : v;
    return true;
}

// Whether `s` spells one of float()'s special words, case-insensitively.
bool special_word(const char* s, size_t n) {
    static const char* words[] = {"inf", "infinity", "nan"};
    for (const char* w : words) {
        if (strlen(w) != n) continue;
        size_t i = 0;
        while (i < n && (s[i] | 0x20) == w[i]) ++i;
        if (i == n) return true;
    }
    return false;
}

// float(): [+-] (digits [. [digits]] | . digits) [(e|E) [+-] digits], digits
// with single underscores between them, or [+-] inf / infinity / nan. `s`
// is scratch space, reused across calls.
bool parse_float(Token t, double* out, std::string& s) {
    s.clear();
    size_t i = 0;
    if (i < t.n && (t.p[i] == '+' || t.p[i] == '-')) s += t.p[i++];
    if (special_word(t.p + i, t.n - i)) {
        s.append(t.p + i, t.n - i);
    } else {
        // digit runs: at least one digit, underscores only between digits
        auto digits = [&](bool required) {
            size_t start = s.size();
            while (i < t.n && (is_digit(t.p[i]) || t.p[i] == '_')) {
                if (t.p[i] == '_') {
                    if (s.size() == start || i + 1 >= t.n || !is_digit(t.p[i + 1])) return false;
                } else {
                    s += t.p[i];
                }
                ++i;
            }
            return !required || s.size() > start;
        };
        const size_t before = s.size();
        if (!digits(false)) return false;
        const bool int_part = s.size() > before;
        if (i < t.n && t.p[i] == '.') {
            s += t.p[i++];
            const size_t frac = s.size();
            if (!digits(false)) return false;
            if (!int_part && s.size() == frac) return false;
        } else if (!int_part) {
            return false;
        }
        if (i < t.n && (t.p[i] == 'e' || t.p[i] == 'E')) {
            s += t.p[i++];
            if (i < t.n && (t.p[i] == '+' || t.p[i] == '-')) s += t.p[i++];
            if (!digits(true)) return false;
        }
        if (i != t.n) return false;
    }
    char* end = nullptr;
    *out = strtod(s.c_str(), &end);
    return end == s.c_str() + s.size();
}

// Splits [p, end) into the tokens of one line; returns the line's end.
const char* line_tokens(const char* p, const char* end, std::vector<Token>& toks) {
    toks.clear();
    while (p < end && *p != '\n' && *p != '\r') {
        if (is_space(*p)) {
            ++p;
            continue;
        }
        const char* q = p;
        while (q < end && !is_space(*q)) ++q;
        toks.push_back({p, (size_t)(q - p)});
        p = q;
    }
    return p;
}

}  // namespace

extern "C" {

// info: {k, depth, n_nodes, reason, line (1-based)}. Returns the parsed
// vocabulary's handle, or null with info[3] > 0 saying why and info[4] where.
void* voc_parse(const char* buf, int64_t len, int64_t* info) {
    const char* p = buf;
    const char* end = buf + len;
    std::vector<Token> toks;
    std::string scratch;
    auto* v = new Vocabulary();
    int64_t line = 1;
    auto fail = [&](int reason) -> void* {
        info[3] = reason;
        info[4] = line;
        delete v;
        return nullptr;
    };
    p = line_tokens(p, end, toks);
    if (toks.size() < 2) return fail(NO_HEADER);
    if (!parse_int(toks[0], &v->k) || !parse_int(toks[1], &v->depth)) return fail(BAD_INT);
    for (;;) {
        if (p >= end) break;
        if (*p == '\r' && p + 1 < end && p[1] == '\n') p += 2;
        else ++p;
        if (p >= end) break;
        ++line;
        p = line_tokens(p, end, toks);
        if (toks.size() < 35) continue;
        int64_t parent, leaf, byte;
        if (!parse_int(toks[0], &parent) || !parse_int(toks[1], &leaf)) return fail(BAD_INT);
        if (parent < INT32_MIN || parent > INT32_MAX) return fail(INT_RANGE);
        uint8_t d[32];
        for (int j = 0; j < 32; ++j) {
            if (!parse_int(toks[2 + j], &byte)) return fail(BAD_INT);
            if (byte < 0 || byte > 255) return fail(INT_RANGE);
            d[j] = (uint8_t)byte;
        }
        double w;
        if (!parse_float(toks[34], &w, scratch)) return fail(BAD_FLOAT);
        v->parent.push_back((int32_t)parent);
        v->leaf.push_back(leaf != 0);
        v->desc.insert(v->desc.end(), d, d + 32);
        v->weight.push_back((float)w);
    }
    info[0] = v->k;
    info[1] = v->depth;
    info[2] = (int64_t)v->parent.size();
    info[3] = OK;
    info[4] = line;
    return v;
}

// Copies the n_nodes rows: parent int32[n], leaf uint8[n], desc uint8[n*32],
// weight float32[n].
int voc_fill(void* h, int32_t* parent, uint8_t* leaf, uint8_t* desc, float* weight) {
    auto* v = static_cast<Vocabulary*>(h);
    const size_t n = v->parent.size();
    memcpy(parent, v->parent.data(), n * sizeof(int32_t));
    memcpy(leaf, v->leaf.data(), n);
    memcpy(desc, v->desc.data(), n * 32);
    memcpy(weight, v->weight.data(), n * sizeof(float));
    return 0;
}

int voc_free(void* h) {
    delete static_cast<Vocabulary*>(h);
    return 0;
}

}  // extern "C"
