// fastdata: the native offline data tier of the PyTorch port.
//
// A copy of the JAX package's native/fastdata.cpp (the port imports nothing
// of that package).  C++ implementations of the two offline parsers behind
// a minimal C ABI, loaded through ctypes by fewshot_torch/data/native.py;
// the pure-Python implementations (fewshot_torch/data/lyrics.py, midi.py)
// are the reference semantics, and the two agree byte for byte.
//
//  * fd_tokenize: the lyrics word tokenizer.  Byte-exact with
//    fewshot_torch.data.lyrics.tokenize_line: lowercased [a-z0-9]+('[a-z]+)?
//    word tokens or single non-space punctuation tokens, with multi-byte
//    UTF-8 sequences kept whole (matching Python's per-character regex).
//  * fd_count_corpus / fd_encode_corpus: the two corpus passes (token
//    counts, then ids against a fixed vocab) over a blob of rows.
//  * fd_parse_smf: the Standard-MIDI-File note extractor.  Same semantics
//    as fewshot_torch.data.midi.parse_midi: running status, global tempo
//    map, FIFO note-on/off pairing, notes sorted by (start, pitch).
//
// Built at first use by fewshot_torch/data/native.py (g++ -O3 -shared
// -fPIC into .torch_ext/, named by a hash of this file).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

// ---------------------------------------------------------------------------
// Lyrics tokenizer
// ---------------------------------------------------------------------------

// Writes token (start, end) byte offsets into the LOWERCASED text, which is
// written to `lowered` (same length as input; caller allocates).  Returns
// the token count, or -1 if max_tokens was too small.
extern "C" int fd_tokenize(const char* text, int32_t len, char* lowered,
                int32_t* starts, int32_t* ends, int32_t max_tokens) {
    for (int32_t i = 0; i < len; ++i) {
        char c = text[i];
        lowered[i] = (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : c;
    }
    auto is_word = [](char c) {
        return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
    };
    auto is_alpha = [](char c) { return c >= 'a' && c <= 'z'; };
    auto is_space = [](unsigned char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    int32_t n = 0;
    int32_t i = 0;
    while (i < len) {
        unsigned char c = (unsigned char)lowered[i];
        if (is_space(c)) { ++i; continue; }
        if (n >= max_tokens) return -1;
        int32_t start = i;
        if (is_word(lowered[i])) {
            while (i < len && is_word(lowered[i])) ++i;
            // optional internal apostrophe: '[a-z]+
            if (i + 1 < len && lowered[i] == '\'' && is_alpha(lowered[i+1])) {
                ++i;
                while (i < len && is_alpha(lowered[i])) ++i;
            }
        } else if (c < 0x80) {
            ++i;                       // single ASCII punctuation char
        } else {
            // one whole UTF-8 sequence == one Python character token
            int32_t adv = 1;
            if ((c & 0xE0) == 0xC0) adv = 2;
            else if ((c & 0xF0) == 0xE0) adv = 3;
            else if ((c & 0xF8) == 0xF0) adv = 4;
            i += adv;
            if (i > len) i = len;
        }
        starts[n] = start;
        ends[n] = i;
        ++n;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Whole-corpus tokenize passes (no per-token Python strings)
// ---------------------------------------------------------------------------

#include <string_view>
#include <unordered_map>

namespace {

// Shared scanner: calls fn(start, end) for each token in lowered[s, e).
template <typename F>
inline void scan_tokens(const char* lowered, int32_t s, int32_t e, F&& fn) {
    auto is_word = [](char c) {
        return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
    };
    auto is_alpha = [](char c) { return c >= 'a' && c <= 'z'; };
    auto is_space = [](unsigned char c) {
        return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
               c == '\f' || c == '\v';
    };
    int32_t i = s;
    while (i < e) {
        unsigned char c = (unsigned char)lowered[i];
        if (is_space(c)) { ++i; continue; }
        int32_t start = i;
        if (is_word(lowered[i])) {
            while (i < e && is_word(lowered[i])) ++i;
            if (i + 1 < e && lowered[i] == '\'' && is_alpha(lowered[i + 1])) {
                ++i;
                while (i < e && is_alpha(lowered[i])) ++i;
            }
        } else if (c < 0x80) {
            ++i;
        } else {
            int32_t adv = 1;
            if ((c & 0xE0) == 0xC0) adv = 2;
            else if ((c & 0xF0) == 0xE0) adv = 3;
            else if ((c & 0xF8) == 0xF0) adv = 4;
            i += adv;
            if (i > e) i = e;
        }
        fn(start, i);
    }
}

inline void lower_inplace(const char* text, char* lowered, int32_t len) {
    for (int32_t i = 0; i < len; ++i) {
        char c = text[i];
        lowered[i] = (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : c;
    }
}

}  // namespace

// Pass 1: count unique tokens over the whole corpus (rows = byte ranges of
// `text`).  Writes the unique tokens concatenated into tok_buf with
// tok_offsets (n_unique+1 entries) and per-unique counts.  Returns n_unique,
// -1 if a capacity is exceeded.  `lowered` is scratch of size len.
extern "C" int fd_count_corpus(const char* text, int32_t len, char* lowered,
                    const int32_t* row_starts, const int32_t* row_ends,
                    int32_t n_rows, char* tok_buf, int32_t tok_buf_cap,
                    int32_t* tok_offsets, int64_t* counts,
                    int32_t max_unique) {
    lower_inplace(text, lowered, len);
    std::unordered_map<std::string_view, int64_t> table;
    table.reserve(1 << 14);
    for (int32_t r = 0; r < n_rows; ++r) {
        scan_tokens(lowered, row_starts[r], row_ends[r],
                    [&](int32_t s, int32_t e) {
                        table[std::string_view(lowered + s, e - s)] += 1;
                    });
    }
    if ((int32_t)table.size() > max_unique) return -1;
    int32_t n = 0;
    int32_t pos = 0;
    for (auto& [tok, cnt] : table) {
        if (pos + (int32_t)tok.size() > tok_buf_cap) return -1;
        tok_offsets[n] = pos;
        std::memcpy(tok_buf + pos, tok.data(), tok.size());
        pos += (int32_t)tok.size();
        counts[n] = cnt;
        ++n;
    }
    tok_offsets[n] = pos;
    return n;
}

// Pass 2: encode every row to int32 ids against a vocab (concatenated token
// bytes + offsets).  Unknown tokens map to unk_id.  Writes ids sequentially
// into out_ids and per-row counts into row_counts.  Returns total id count,
// -1 on overflow.
extern "C" int fd_encode_corpus(const char* text, int32_t len, char* lowered,
                     const int32_t* row_starts, const int32_t* row_ends,
                     int32_t n_rows, const char* vocab_buf,
                     const int32_t* vocab_offsets, int32_t n_vocab,
                     int32_t unk_id, int32_t* out_ids, int64_t out_cap,
                     int32_t* row_counts) {
    lower_inplace(text, lowered, len);
    std::unordered_map<std::string_view, int32_t> table;
    table.reserve(n_vocab * 2);
    for (int32_t v = 0; v < n_vocab; ++v) {
        table.emplace(std::string_view(vocab_buf + vocab_offsets[v],
                                       vocab_offsets[v + 1] -
                                       vocab_offsets[v]), v);
    }
    int64_t total = 0;
    bool overflow = false;
    for (int32_t r = 0; r < n_rows; ++r) {
        int32_t row_n = 0;
        scan_tokens(lowered, row_starts[r], row_ends[r],
                    [&](int32_t s, int32_t e) {
                        if (total >= out_cap) { overflow = true; return; }
                        auto it = table.find(
                            std::string_view(lowered + s, e - s));
                        out_ids[total++] =
                            (it == table.end()) ? unk_id : it->second;
                        ++row_n;
                    });
        if (overflow) return -1;
        row_counts[r] = row_n;
    }
    return (int)total;
}

// ---------------------------------------------------------------------------
// SMF parser
// ---------------------------------------------------------------------------

namespace {

struct Cursor {
    const uint8_t* d;
    int32_t pos, len;
    bool ok = true;
    uint8_t u8() {
        if (pos >= len) { ok = false; return 0; }
        return d[pos++];
    }
    uint32_t be32() {
        uint32_t v = 0;
        for (int k = 0; k < 4; ++k) v = (v << 8) | u8();
        return v;
    }
    uint16_t be16() { return (uint16_t)((u8() << 8) | u8()); }
    uint32_t varlen() {
        uint32_t v = 0;
        for (int k = 0; k < 4; ++k) {
            uint8_t b = u8();
            v = (v << 7) | (b & 0x7F);
            if (!(b & 0x80)) break;
        }
        return v;
    }
    void skip(uint32_t n) { pos = (pos + (int32_t)n > len) ? len : pos + n; }
};

// kind 0=off 1=on 2=tempo; ch = MIDI channel (status low nibble)
struct Ev { int64_t tick; int kind; int d1; int d2; int ch; };

}  // namespace

// Parses an SMF byte buffer into parallel note arrays (seconds).  Returns
// note count, -1 on malformed input, -2 if max_notes too small,
// -3 for SMPTE division.
extern "C" int fd_parse_smf(const uint8_t* data, int32_t len, double* starts,
                 double* ends, int32_t* pitches, int32_t* vels,
                 int32_t max_notes) {
    if (len < 14 || std::memcmp(data, "MThd", 4) != 0) return -1;
    Cursor hc{data, 4, len};
    uint32_t hlen = hc.be32();
    hc.be16();                       // format
    uint16_t ntrks = hc.be16();
    uint16_t division = hc.be16();
    if (division & 0x8000) return -3;
    double tpq = division ? division : 480;
    int32_t pos = 8 + (int32_t)hlen;

    std::vector<Ev> evs;
    for (int t = 0; t < ntrks; ++t) {
        if (pos + 8 > len || std::memcmp(data + pos, "MTrk", 4) != 0)
            return -1;
        Cursor lc{data, pos + 4, len};
        uint32_t tlen = lc.be32();
        Cursor c{data, pos + 8, std::min(len, pos + 8 + (int32_t)tlen)};
        int64_t tick = 0;
        uint8_t status = 0;
        while (c.pos < c.len && c.ok) {
            tick += c.varlen();
            uint8_t b = c.u8();
            if (b & 0x80) status = b;
            else { c.pos--; if (!status) return -1; }
            if (status == 0xFF) {
                uint8_t mtype = c.u8();
                uint32_t mlen = c.varlen();
                if (mtype == 0x51 && mlen == 3) {
                    int tempo = (c.u8() << 16); tempo |= (c.u8() << 8);
                    tempo |= c.u8();
                    evs.push_back({tick, 2, tempo, 0, 0});
                } else c.skip(mlen);
                status = 0;
            } else if (status == 0xF0 || status == 0xF7) {
                c.skip(c.varlen());
                status = 0;
            } else {
                uint8_t kind = status & 0xF0;
                int ch = status & 0x0F;
                if (kind == 0x80 || kind == 0x90 || kind == 0xA0 ||
                    kind == 0xB0 || kind == 0xE0) {
                    uint8_t d1 = c.u8(), d2 = c.u8();
                    if (kind == 0x90 && d2 > 0)
                        evs.push_back({tick, 1, d1, d2, ch});
                    else if (kind == 0x80 || (kind == 0x90 && d2 == 0))
                        evs.push_back({tick, 0, d1, 0, ch});
                } else if (kind == 0xC0 || kind == 0xD0) {
                    c.u8();
                } else return -1;
            }
        }
        pos += 8 + (int32_t)tlen;
    }

    std::stable_sort(evs.begin(), evs.end(),
                     [](const Ev& a, const Ev& b) { return a.tick < b.tick; });

    // tempo map -> seconds
    std::vector<std::pair<int64_t, int>> tempo{{0, 500000}};
    for (auto& e : evs)
        if (e.kind == 2) tempo.push_back({e.tick, e.d1});
    auto tick_to_sec = [&](int64_t tick) {
        double sec = 0.0;
        int64_t prev = 0;
        int cur = 500000;
        for (auto& [tt, tp] : tempo) {
            if (tt >= tick) break;
            sec += (double)(tt - prev) * cur / (tpq * 1e6);
            prev = tt; cur = tp;
        }
        return sec + (double)(tick - prev) * cur / (tpq * 1e6);
    };

    // FIFO pairing keyed by (channel, pitch) — kept in lockstep with the
    // Python parser (fewshot_torch/data/midi.py) for the byte-for-byte parity test.
    struct Note { double s, e; int p, v; };
    std::vector<Note> notes;
    std::vector<std::vector<std::pair<int64_t, int>>> open(16 * 128);
    for (auto& e : evs) {
        int key = e.ch * 128 + e.d1;
        if (e.kind == 1) {
            open[key].push_back({e.tick, e.d2});
        } else if (e.kind == 0 && !open[key].empty()) {
            auto [on_tick, vel] = open[key].front();
            open[key].erase(open[key].begin());
            if (e.tick > on_tick)
                notes.push_back({tick_to_sec(on_tick), tick_to_sec(e.tick),
                                 e.d1, vel});
        }
    }
    std::stable_sort(notes.begin(), notes.end(), [](const Note& a,
                                                    const Note& b) {
        return a.s < b.s || (a.s == b.s && a.p < b.p);
    });
    if ((int32_t)notes.size() > max_notes) return -2;
    for (size_t i = 0; i < notes.size(); ++i) {
        starts[i] = notes[i].s;
        ends[i] = notes[i].e;
        pitches[i] = notes[i].p;
        vels[i] = notes[i].v;
    }
    return (int)notes.size();
}


