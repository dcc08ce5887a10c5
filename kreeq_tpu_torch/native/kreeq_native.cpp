// Native host helpers, exposed with a plain C ABI for ctypes:
// - sequence ingest: FASTA/FASTQ (plain or gzip) -> one buffer of 2-bit
//   codes (A=0 C=1 G=2 T=3, anything else BAD=4), every sequence
//   followed by one BAD: the layout of the device chunks, which are cut
//   from it by sequence boundaries.  The reference's ingest path is C++ too
//   (gfalibs StreamObj + kcount, reference: src/input.cpp:188-308);
// - `.kreeq` database loading (every map file parsed on several threads
//   straight into the caller's arrays) and SwissTable slot placement
//   for its writes (layout in kreeq_tpu_torch/io/kreeqdb.py).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

const uint8_t kBad = 4;

struct Parsed {
    std::vector<uint8_t> codes;     // each sequence's codes, then one BAD
    std::vector<uint64_t> offsets;  // start offset of each sequence

    // Start a sequence, closing the previous one with its separator.
    void open() {
        if (!offsets.empty()) codes.push_back(kBad);
        offsets.push_back(codes.size());
    }
    // Close the last sequence (an empty one keeps its separator too).
    void close() {
        if (!offsets.empty()) codes.push_back(kBad);
    }
};

uint8_t code_table[256];

struct TableInit {
    TableInit() {
        memset(code_table, kBad, sizeof(code_table));
        const char *bases = "ACGT";
        for (int i = 0; i < 4; ++i) {
            code_table[(unsigned char)bases[i]] = i;
            code_table[(unsigned char)(bases[i] + 32)] = i;
        }
    }
} table_init;

}  // namespace

extern "C" {

// Parse a FASTA/FASTQ file (gzip-transparent).  Returns an opaque
// handle; query sizes/pointers with the accessors below.  kn_num_codes
// counts the separators: one a sequence.
void *kn_parse_fastx(const char *path) {
    gzFile fh = gzopen(path, "rb");
    if (!fh) return nullptr;
    gzbuffer(fh, 1 << 20);

    Parsed *out = new Parsed();
    out->codes.reserve(1 << 20);

    std::vector<char> line(1 << 16);
    int first = gzgetc(fh);
    if (first < 0) {
        gzclose(fh);
        return out;  // empty file
    }
    bool fastq = (first == '@');
    gzungetc(first, fh);

    int state = 0;  // FASTA: 0=want header, 1=sequence
                    // FASTQ line cycle: 0 header, 1 seq, 2 plus, 3 qual
    bool line_start = true;  // long lines span several gzgets chunks
    while (gzgets(fh, line.data(), (int)line.size())) {
        size_t len = strlen(line.data());
        bool eol = len > 0 && line[len - 1] == '\n';
        while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            --len;
        if (fastq) {
            if (state == 0) {
                if (line_start) out->open();
            } else if (state == 1) {
                size_t base = out->codes.size();
                out->codes.resize(base + len);
                for (size_t i = 0; i < len; ++i)
                    out->codes[base + i] =
                        code_table[(unsigned char)line[i]];
            }
            if (eol) state = (state + 1) & 3;
        } else {
            if (len > 0 && line[0] == '>' && state != 2 && line_start) {
                out->open();
                state = eol ? 1 : 2;  // 2 = skipping long header
            } else if (state == 2) {
                if (eol) state = 1;  // rest of a long header line
            } else if (state == 1) {
                size_t base = out->codes.size();
                out->codes.resize(base + len);
                for (size_t i = 0; i < len; ++i)
                    out->codes[base + i] =
                        code_table[(unsigned char)line[i]];
            }
        }
        line_start = eol;
    }
    out->close();
    gzclose(fh);
    return out;
}

uint64_t kn_num_seqs(void *h) { return ((Parsed *)h)->offsets.size(); }
uint64_t kn_num_codes(void *h) { return ((Parsed *)h)->codes.size(); }
const uint8_t *kn_codes(void *h) { return ((Parsed *)h)->codes.data(); }
const uint64_t *kn_offsets(void *h) {
    return ((Parsed *)h)->offsets.data();
}
void kn_free(void *h) { delete (Parsed *)h; }

}  // extern "C"

// ---------------------------------------------------------------------
// `.kreeq` DB loading: every map file of a DB, in two passes.
//
// kn_db_open maps each file and walks its submap headers (pass 1): the
// size fields give each file's row count, so the caller allocates the
// outputs once.  kn_db_load parses the files on several threads (pass
// 2), each u8 map into its own range of the outputs: keys biased to the
// port's int64 form (key ^ 2^63), counters as u8 [n, 9]; tombstones
// (cov 255: the record lives in the hc map) are dropped and their keys
// kept.  The holes they leave are then filled with rows from the
// outputs' end (the caller sorts the rows, so their order is free), and
// the hc map's rows follow the live u8 rows: keys, u32 counters apart
// (their u8 counters zero: the caller places the u32 ones).

static const uint64_t kPhmapVersion = 0xFFFFFFFFFFFFFFF5ULL;
static const uint64_t kBias = 1ULL << 63;

namespace {

struct MapFile {
    const uint8_t *data = nullptr;  // the file, mapped read-only
    uint64_t size = 0;              // bytes
    uint64_t rows = 0;              // the submaps' size fields summed
    uint64_t first = 0;             // its first row in the outputs
    uint64_t live = 0;              // rows written (pass 2)
    std::vector<int64_t> tombstones;  // biased keys (pass 2)
};

struct DbLoad {
    std::vector<MapFile> maps;  // the u8 maps, then the hc map if any
    bool has_hc = false;
    int error = 0;  // 0, -1 a corrupt archive, else an errno
    uint64_t rows8 = 0, rows_hc = 0, bytes = 0;
    std::vector<int64_t> tombstones;

    ~DbLoad() {
        for (MapFile &m : maps)
            if (m.data) munmap((void *)m.data, m.size);
    }
};

// Call fn(i) for i in [0, n) on min(hardware threads, n) threads, this
// one among them (it works alone where no other thread starts).
template <class F>
void parallel_for(uint64_t n, F fn) {
    uint64_t nt = std::min<uint64_t>(std::thread::hardware_concurrency(), n);
    std::atomic<uint64_t> next(0);
    auto work = [&] {
        for (uint64_t i; (i = next.fetch_add(1)) < n;) fn(i);
    };
    std::vector<std::thread> pool;
    try {
        for (uint64_t t = 1; t < nt; ++t) pool.emplace_back(work);
    } catch (const std::system_error &) {
    }
    work();
    for (std::thread &th : pool) th.join();
}

// Walk a phmap dump (slot bytes a record), checking the version marker,
// the bounds and the trailing bytes; visit(ctrl, slots, cap, count) on
// every non-empty submap, which returns false on a corrupt one.
template <class F>
bool walk_phmap(const uint8_t *data, uint64_t size, uint64_t slot,
                F visit) {
    if (size < 8) return false;
    uint64_t subcnt, off = 8;
    memcpy(&subcnt, data, 8);
    for (uint64_t s = 0; s < subcnt; ++s) {
        uint64_t hdr[3];  // version, size, capacity
        if (size - off < 24) return false;
        memcpy(hdr, data + off, 24);
        off += 24;
        if (hdr[0] != kPhmapVersion) return false;
        if (hdr[1] == 0) continue;
        uint64_t cap = hdr[2];
        // cap + 17 control bytes, cap slots, u64 growth_left
        if (hdr[1] > cap || cap > size ||
            size - off < cap * (slot + 1) + 25)
            return false;
        if (!visit(data + off, data + off + cap + 17, cap, hdr[1]))
            return false;
        off += cap * (slot + 1) + 25;
    }
    return off == size;
}

// fn(i) for every full slot i < cap (control byte's top bit clear),
// eight control bytes a word (little-endian, as the files are).
template <class F>
void for_full_slots(const uint8_t *ctrl, uint64_t cap, F fn) {
    for (uint64_t i = 0; i < cap; i += 8) {
        uint64_t group;  // cap + 17 control bytes: 8 from i < cap fit
        memcpy(&group, ctrl + i, 8);
        uint64_t full = ~group & 0x8080808080808080ULL;
        if (cap - i < 8) full &= (1ULL << 8 * (cap - i)) - 1;
        for (; full; full &= full - 1) fn(i + __builtin_ctzll(full) / 8);
    }
}

// Pass 2 of a u8 map: its live rows from m.first on, its tombstones.
bool load_u8(MapFile &m, int64_t *keys, uint8_t *vals8) {
    uint64_t at = m.first;
    bool ok = walk_phmap(
        m.data, m.size, 24,
        [&](const uint8_t *ctrl, const uint8_t *slots, uint64_t cap,
            uint64_t count) {
            uint64_t seen = 0;
            for_full_slots(ctrl, cap, [&](uint64_t i) {
                if (++seen > count) return;
                const uint8_t *rec = slots + i * 24;
                uint64_t key;
                memcpy(&key, rec, 8);
                if (rec[16] == 255) {
                    m.tombstones.push_back((int64_t)(key ^ kBias));
                    return;
                }
                keys[at] = (int64_t)(key ^ kBias);
                memcpy(vals8 + at * 9, rec + 8, 9);
                ++at;
            });
            return seen == count;
        });
    m.live = at - m.first;
    return ok;
}

// Pass 2 of the hc map: its keys (biased) and u32 counters.
bool load_hc(MapFile &m, int64_t *keys, uint32_t *vals) {
    uint64_t at = 0;
    return walk_phmap(
        m.data, m.size, 48,
        [&](const uint8_t *ctrl, const uint8_t *slots, uint64_t cap,
            uint64_t count) {
            uint64_t seen = 0;
            for_full_slots(ctrl, cap, [&](uint64_t i) {
                if (++seen > count) return;
                const uint8_t *rec = slots + i * 48;
                uint64_t key;
                memcpy(&key, rec, 8);
                keys[at] = (int64_t)(key ^ kBias);
                memcpy(vals + at * 9, rec + 8, 36);
                ++at;
            });
            return seen == count;
        });
}

}  // namespace

extern "C" {

// Pass 1: map the n files (the u8 maps, then the hc map when has_hc)
// and count their rows.  Always returns a handle: kn_db_error says
// whether a file failed to open (its errno) or is corrupt (-1).
void *kn_db_open(const char *const *paths, uint64_t n, int has_hc) {
    DbLoad *db = new DbLoad();
    db->maps.resize(n);
    db->has_hc = has_hc && n > 0;
    std::vector<int> errs(n, 0);
    parallel_for(n, [&](uint64_t f) {
        MapFile &m = db->maps[f];
        int fd = open(paths[f], O_RDONLY);
        struct stat st;
        if (fd < 0 || fstat(fd, &st) != 0) {
            errs[f] = errno;
            if (fd >= 0) close(fd);
            return;
        }
        m.size = (uint64_t)st.st_size;
        if (m.size > 0) {
            void *p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, fd, 0);
            if (p == MAP_FAILED) {
                errs[f] = errno;
                m.size = 0;
            } else {
                m.data = (const uint8_t *)p;
            }
        }
        close(fd);
        if (errs[f]) return;
        bool hc = db->has_hc && f == n - 1;
        if (!walk_phmap(m.data, m.size, hc ? 48 : 24,
                        [&](const uint8_t *, const uint8_t *, uint64_t,
                            uint64_t count) {
                            m.rows += count;
                            return true;
                        }))
            errs[f] = -1;
    });
    for (uint64_t f = 0; f < n; ++f) {
        if (errs[f] && !db->error) db->error = errs[f];
        db->bytes += db->maps[f].size;
        if (db->has_hc && f == n - 1) {
            db->rows_hc = db->maps[f].rows;
        } else {
            db->maps[f].first = db->rows8;
            db->rows8 += db->maps[f].rows;
        }
    }
    return db;
}

int kn_db_error(void *h) { return ((DbLoad *)h)->error; }
uint64_t kn_db_rows(void *h, int hc) {
    DbLoad *db = (DbLoad *)h;
    return hc ? db->rows_hc : db->rows8;
}
uint64_t kn_db_bytes(void *h) { return ((DbLoad *)h)->bytes; }

// Pass 2 into the caller's arrays: keys int64 [rows8 + rows_hc], vals8
// u8 [rows8 + rows_hc, 9], vals_hc u32 [rows_hc, 9].  Returns the live
// u8 rows L (rows [0, L) the u8 maps', [L, L + rows_hc) the hc map's),
// or -1 on a corrupt archive.
int64_t kn_db_load(void *h, int64_t *keys, uint8_t *vals8,
                   uint32_t *vals_hc) {
    DbLoad *db = (DbLoad *)h;
    uint64_t n = db->maps.size(), n8 = n - (db->has_hc ? 1 : 0);
    std::vector<int64_t> hc_keys(db->rows_hc);
    std::vector<char> ok(n, 1);
    parallel_for(n, [&](uint64_t f) {
        ok[f] = f < n8 ? load_u8(db->maps[f], keys, vals8)
                       : load_hc(db->maps[f], hc_keys.data(), vals_hc);
    });
    for (uint64_t f = 0; f < n; ++f)
        if (!ok[f]) return -1;
    // fill the holes below `live` with the live rows above it
    uint64_t live = 0;
    for (uint64_t f = 0; f < n8; ++f) live += db->maps[f].live;
    uint64_t src_f = n8, src = 0, src_end = 0;  // next row to move
    for (uint64_t f = 0; f < n8; ++f) {
        MapFile &m = db->maps[f];
        uint64_t hole = m.first + m.live;
        uint64_t end = std::min(m.first + m.rows, live);
        for (; hole < end; ++hole) {
            while (src == src_end) {  // the next map's rows above live
                MapFile &s = db->maps[--src_f];
                src = std::max(s.first, live);
                src_end = std::max(s.first + s.live, src);
            }
            --src_end;
            keys[hole] = keys[src_end];
            memcpy(vals8 + hole * 9, vals8 + src_end * 9, 9);
        }
    }
    std::copy(hc_keys.begin(), hc_keys.end(), keys + live);
    memset(vals8 + live * 9, 0, db->rows_hc * 9);
    for (uint64_t f = 0; f < n8; ++f)
        db->tombstones.insert(db->tombstones.end(),
                              db->maps[f].tombstones.begin(),
                              db->maps[f].tombstones.end());
    return (int64_t)live;
}

uint64_t kn_db_tombstone_count(void *h) {
    return ((DbLoad *)h)->tombstones.size();
}
const int64_t *kn_db_tombstone_keys(void *h) {
    return ((DbLoad *)h)->tombstones.data();
}
void kn_db_close(void *h) { delete (DbLoad *)h; }

// SwissTable slot placement for phmap-compatible writes: replays
// find_first_non_full (group-of-16 triangular probing) so a table
// written with these positions is probe-consistent for the reference's
// own find() after phmap_load (raw ctrl/slot restore).  hs are the
// *mixed* hashes (phmap_mix of std::hash, computed by the caller); cap
// is 2^n - 1; pos_out receives the slot index of each key.  Returns 0
// on success, -1 if the table over-fills (caller sized cap wrong).
int kn_phmap_place(const uint64_t *hs, uint64_t n, uint64_t cap,
                   uint32_t *pos_out) {
    std::vector<uint8_t> ctrl(cap + 17, 0x80);  // kEmpty
    ctrl[cap] = 0xFF;                           // kSentinel
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t h1 = hs[i] >> 7;
        uint64_t offset = h1 & cap, index = 0;
        int64_t found = -1;
        for (uint64_t probes = 0; probes <= cap && found < 0;
             probes += 16) {
            for (uint64_t j = 0; j < 16; ++j) {
                uint64_t p = (offset + j) & cap;
                if (ctrl[p] == 0x80) {
                    found = (int64_t)p;
                    break;
                }
            }
            index += 16;
            offset = (offset + index) & cap;
        }
        if (found < 0) return -1;
        ctrl[found] = (uint8_t)(hs[i] & 0x7F);
        pos_out[i] = (uint32_t)found;
    }
    return 0;
}

}  // extern "C"
