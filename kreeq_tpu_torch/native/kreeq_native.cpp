// Native sequence ingest: FASTA/FASTQ (plain or gzip) -> per-sequence
// 2-bit code arrays (A=0 C=1 G=2 T=3, anything else BAD=4), ready for
// packing into device chunks.  The reference's ingest path is C++ too
// (gfalibs StreamObj + kcount, reference: src/input.cpp:188-308).
// Exposed with a plain C ABI for ctypes.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
    std::vector<uint8_t> codes;     // concatenated per-sequence codes
    std::vector<uint64_t> offsets;  // start offset of each sequence
};

uint8_t code_table[256];

struct TableInit {
    TableInit() {
        memset(code_table, 4, sizeof(code_table));
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
// handle; query sizes/pointers with the accessors below.
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
                if (line_start) out->offsets.push_back(out->codes.size());
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
                out->offsets.push_back(out->codes.size());
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
