// Host-side native code of dpark_tpu_torch (a copy of
// dpark_tpu/native/native.cpp): bulk portable hashing, crc32c, newline
// splitting and the dictionary token encoder that feeds the text ingest
// (textFile -> flatMap(split) -> map((w, 1)) becomes int64 id columns on
// the host, then tensors on the card).  Compiled with plain g++ into
// libdpark_native.so, bound via ctypes (native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <unordered_map>
#include <string>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// portable hash: murmur3 fmix32 over (lo ^ hi) words, bit-identical to
// dpark_tpu/utils/phash.py portable_hash()/_hash_int and phash_device().
// --------------------------------------------------------------------------
static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

uint32_t phash_i64(int64_t x) {
    uint64_t u = (uint64_t)x;
    uint32_t lo = (uint32_t)(u & 0xFFFFFFFFu);
    uint32_t hi = (uint32_t)((u >> 32) & 0xFFFFFFFFu);
    return fmix32(lo ^ hi);
}

void phash_i64_array(const int64_t* xs, uint32_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = phash_i64(xs[i]);
}

// Composite (tuple) key hash over `ncols` int64 columns laid out
// contiguously (cols[c*n + i] = column c, row i): portable_hash's own
// tuple recipe — h = 0x345678; per item h = (h ^ hash(item)) *
// 0x9E3779B1; fmix32(h ^ ncols) — applied per row.  Bit-identical to
// phash.py portable_hash((k1, ..., kn)) / phash_np_cols /
// phash_device_cols, so multi-column shuffle routing agrees across
// every implementation.
void phash_i64_cols(const int64_t* cols, int64_t ncols, int64_t n,
                    uint32_t* out) {
    if (ncols == 1) { phash_i64_array(cols, out, n); return; }
    for (int64_t i = 0; i < n; i++) {
        uint32_t h = 0x345678u;
        for (int64_t c = 0; c < ncols; c++) {
            h = (h ^ phash_i64(cols[c * n + i])) * 0x9E3779B1u;
        }
        out[i] = fmix32(h ^ (uint32_t)ncols);
    }
}

// FNV-1a over bytes + fmix32 finalizer — matches phash.py _hash_bytes.
uint32_t phash_bytes(const uint8_t* data, int64_t n) {
    uint32_t h = 0x811C9DC5u;
    for (int64_t i = 0; i < n; i++) {
        h = (h ^ data[i]) * 0x01000193u;
    }
    return fmix32(h);
}

// --------------------------------------------------------------------------
// crc32c (Castagnoli), table-driven — storage integrity (beansdb records,
// tabular chunks).  Standard polynomial 0x82F63B78.
// --------------------------------------------------------------------------
static uint32_t crc32c_table[256];
static bool crc32c_ready = false;

static void crc32c_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    crc32c_ready = true;
}

uint32_t crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
    if (!crc32c_ready) crc32c_init();
    crc = ~crc;
    for (int64_t i = 0; i < n; i++)
        crc = crc32c_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// --------------------------------------------------------------------------
// newline splitter: fill start/length arrays for each line in buf.
// Returns the number of lines found (at most max_lines); a trailing
// fragment without '\n' counts as a line.
// --------------------------------------------------------------------------
int64_t split_lines(const uint8_t* buf, int64_t n,
                    int64_t* starts, int64_t* lens, int64_t max_lines) {
    int64_t count = 0;
    int64_t start = 0;
    for (int64_t i = 0; i < n && count < max_lines; i++) {
        if (buf[i] == '\n') {
            int64_t len = i - start;
            if (len > 0 && buf[start + len - 1] == '\r') len--;
            starts[count] = start;
            lens[count] = len;
            count++;
            start = i + 1;
        }
    }
    if (start < n && count < max_lines) {
        starts[count] = start;
        lens[count] = n - start;
        count++;
    }
    return count;
}

// --------------------------------------------------------------------------
// TokenDict: exact string -> dense int64 id dictionary encoder.  Feeds the
// device wordcount path: host tokenizes+encodes, device reduces int64 ids,
// host decodes ids back to strings.  (The reference counts Python strings
// in dicts; this is the columnar equivalent.)
// --------------------------------------------------------------------------
struct TokenDict {
    std::unordered_map<std::string, int64_t> map;
    std::vector<std::string> rev;
};

void* tokendict_new() { return new TokenDict(); }

void tokendict_free(void* h) { delete (TokenDict*)h; }

int64_t tokendict_size(void* h) {
    return (int64_t)((TokenDict*)h)->rev.size();
}

// Tokenize buf on ASCII whitespace, encode each token to its id (assigning
// new ids in first-seen order), write ids into out (capacity max_tokens).
// Returns the number of tokens written.
int64_t tokendict_encode(void* h, const uint8_t* buf, int64_t n,
                         int64_t* out, int64_t max_tokens) {
    TokenDict* d = (TokenDict*)h;
    int64_t count = 0;
    int64_t i = 0;
    while (i < n && count < max_tokens) {
        while (i < n && (buf[i] == ' ' || buf[i] == '\t' ||
                         buf[i] == '\n' || buf[i] == '\r')) i++;
        if (i >= n) break;
        int64_t start = i;
        while (i < n && !(buf[i] == ' ' || buf[i] == '\t' ||
                          buf[i] == '\n' || buf[i] == '\r')) i++;
        std::string tok((const char*)buf + start, (size_t)(i - start));
        auto it = d->map.find(tok);
        int64_t id;
        if (it == d->map.end()) {
            id = (int64_t)d->rev.size();
            d->map.emplace(std::move(tok), id);
            d->rev.push_back(std::string((const char*)buf + start,
                                         (size_t)(i - start)));
        } else {
            id = it->second;
        }
        out[count++] = id;
    }
    return count;
}

// Single-byte-separator tokenizer: split buf into \n-lines (stripping
// trailing \r runs, like TextFileRDD's rstrip(b"\r\n")), then each
// line on `sep`, encoding EVERY field INCLUDING empty ones — exact
// str.split(sep) semantics, which unlike whitespace split preserves
// empty fields between consecutive separators and yields [""] for an
// empty line.  Backs canonical chains like
// flatMap(lambda l: l.split("\t")).
int64_t tokendict_encode_sep(void* h, const uint8_t* buf, int64_t n,
                             uint8_t sep, int64_t* out,
                             int64_t max_tokens) {
    TokenDict* d = (TokenDict*)h;
    int64_t count = 0;
    int64_t i = 0;
    while (i < n && count < max_tokens) {
        int64_t line_end = i;
        while (line_end < n && buf[line_end] != '\n') line_end++;
        int64_t e = line_end;
        while (e > i && buf[e - 1] == '\r') e--;
        int64_t start = i;
        for (int64_t j = i; j <= e && count < max_tokens; j++) {
            if (j == e || buf[j] == sep) {
                std::string tok((const char*)buf + start,
                                (size_t)(j - start));
                auto it = d->map.find(tok);
                int64_t id;
                if (it == d->map.end()) {
                    id = (int64_t)d->rev.size();
                    d->rev.push_back(tok);
                    d->map.emplace(std::move(tok), id);
                } else {
                    id = it->second;
                }
                out[count++] = id;
                start = j + 1;
            }
        }
        i = line_end + 1;
    }
    return count;
}

// Encode ONE exact string (no tokenization — the key may contain
// whitespace) to its dense id, assigning a new id on first sight.
int64_t tokendict_put(void* h, const uint8_t* buf, int64_t n) {
    TokenDict* d = (TokenDict*)h;
    std::string tok((const char*)buf, (size_t)n);
    auto it = d->map.find(tok);
    if (it != d->map.end()) return it->second;
    int64_t id = (int64_t)d->rev.size();
    d->rev.push_back(tok);
    d->map.emplace(std::move(tok), id);
    return id;
}

// CSV record-boundary scanner: exact RFC4180-style state machine.  A
// quote only OPENS a quoted field at field start (after delimiter or
// newline); inside a quoted field a doubled quote is a literal; a bare
// quote inside an unquoted field is a literal and never flips state —
// which is where the simpler quote-parity heuristic corrupts records.
// Emits record-start offsets >= target stepping by `step` into out.
// state bits: 1 = in_quoted, 2 = field_start, 4 = pending close quote.
int64_t csv_scan(const uint8_t* buf, int64_t n, uint8_t quote,
                 uint8_t delim, int64_t state_in, int64_t* state_out,
                 int64_t base, int64_t target, int64_t step,
                 int64_t* target_out, int64_t* out, int64_t max_out) {
    bool in_quoted = state_in & 1;
    bool field_start = state_in & 2;
    bool pending = state_in & 4;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = buf[i];
        if (pending) {
            pending = false;
            if (c == quote) continue;        // doubled quote: literal
            in_quoted = false;               // previous quote closed
        }
        if (in_quoted) {
            if (c == quote) pending = true;  // close or doubled?
            continue;
        }
        if (c == '\n') {
            int64_t off = base + i + 1;
            if (off >= target && cnt < max_out) {
                out[cnt++] = off;
                target = off + step;
            }
            field_start = true;
        } else if (c == delim) {
            field_start = true;
        } else if (c == quote && field_start) {
            in_quoted = true;
            field_start = false;
        } else {
            field_start = false;
        }
    }
    *state_out = (in_quoted ? 1 : 0) | (field_start ? 2 : 0)
               | (pending ? 4 : 0);
    *target_out = target;
    return cnt;
}

// Merge src's vocabulary into dst IN src-id ORDER, writing
// remap[i] = dst id of src token i.  Backbone of the parallel text
// ingest: worker threads tokenize into private dicts with the GIL
// released, the driver merges them in split order so global ids come
// out identical to a serial walk.  Returns src's size.
int64_t tokendict_merge(void* dst_h, void* src_h, int64_t* remap) {
    TokenDict* dst = (TokenDict*)dst_h;
    TokenDict* src = (TokenDict*)src_h;
    int64_t m = (int64_t)src->rev.size();
    for (int64_t i = 0; i < m; i++) {
        const std::string& tok = src->rev[(size_t)i];
        auto it = dst->map.find(tok);
        int64_t id;
        if (it != dst->map.end()) {
            id = it->second;
        } else {
            id = (int64_t)dst->rev.size();
            dst->rev.push_back(tok);
            dst->map.emplace(tok, id);
        }
        remap[i] = id;
    }
    return m;
}

// Copy token `id` into out (capacity cap); returns its length or -1.
int64_t tokendict_get(void* h, int64_t id, uint8_t* out, int64_t cap) {
    TokenDict* d = (TokenDict*)h;
    if (id < 0 || id >= (int64_t)d->rev.size()) return -1;
    const std::string& s = d->rev[(size_t)id];
    int64_t n = (int64_t)s.size();
    if (n > cap) return -1;
    std::memcpy(out, s.data(), (size_t)n);
    return n;
}

}  // extern "C"
