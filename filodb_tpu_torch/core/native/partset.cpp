// Native partition set: the ingest hot-path part-key table.
//
// Reference role: core/.../memstore/PartitionSet.scala — a specialized
// open-addressing set probed directly against ingest BinaryRecords with no
// allocation, sitting under getOrAddPartitionAndIngest
// (TimeSeriesShard.scala:1183), the hottest loop of the write path. Here the
// same structure is C++: open addressing with linear probing over
// (hash, pid) entries plus a key arena for exact-bytes verification on hash
// hits, batch-resolved with ONE call per container.
//
// Build: core/native/build.sh -> libfilodb_partset.so (loaded via ctypes by
// core/native/__init__.py; Python dict fallback in core/memstore.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Entry {
    uint64_t hash;
    uint64_t key_off;
    uint32_t key_len;
    int32_t pid;       // -1 = empty, -2 = tombstone
};

struct PartSet {
    Entry* entries;
    uint64_t cap;       // power of two
    uint64_t size;      // live entries
    uint64_t used;      // live + tombstones (controls rehash)
    uint8_t* arena;
    uint64_t arena_len;
    uint64_t arena_cap;
};

const int32_t EMPTY = -1;
const int32_t TOMB = -2;

void ps_rehash(PartSet* s, uint64_t new_cap);

PartSet* ps_alloc(uint64_t cap_hint) {
    uint64_t cap = 64;
    while (cap < cap_hint * 2) cap <<= 1;
    PartSet* s = (PartSet*)std::malloc(sizeof(PartSet));
    s->entries = (Entry*)std::malloc(cap * sizeof(Entry));
    for (uint64_t i = 0; i < cap; i++) s->entries[i].pid = EMPTY;
    s->cap = cap;
    s->size = 0;
    s->used = 0;
    s->arena_cap = 1 << 20;
    s->arena = (uint8_t*)std::malloc(s->arena_cap);
    s->arena_len = 0;
    return s;
}

inline bool key_eq(const PartSet* s, const Entry& e, const uint8_t* key,
                   uint32_t len) {
    return e.key_len == len &&
           std::memcmp(s->arena + e.key_off, key, len) == 0;
}

// find live entry; returns pid or -1
inline int32_t ps_find(const PartSet* s, uint64_t hash, const uint8_t* key,
                       uint32_t len) {
    uint64_t mask = s->cap - 1;
    uint64_t i = hash & mask;
    while (true) {
        const Entry& e = s->entries[i];
        if (e.pid == EMPTY) return -1;
        if (e.pid != TOMB && e.hash == hash && key_eq(s, e, key, len))
            return e.pid;
        i = (i + 1) & mask;
    }
}

void ps_insert_raw(PartSet* s, uint64_t hash, const uint8_t* key,
                   uint32_t len, int32_t pid) {
    if ((s->used + 1) * 4 >= s->cap * 3) {
        // mostly tombstones -> rebuild at the same capacity (purges them and
        // compacts the arena); genuinely full -> double
        ps_rehash(s, (s->size + 1) * 4 >= s->cap * 3 ? s->cap << 1 : s->cap);
    }
    uint64_t mask = s->cap - 1;
    uint64_t i = hash & mask;
    uint64_t first_free = (uint64_t)-1;
    while (true) {
        Entry& e = s->entries[i];
        if (e.pid == EMPTY) break;
        if (e.pid == TOMB) {
            if (first_free == (uint64_t)-1) first_free = i;
        } else if (e.hash == hash && key_eq(s, e, key, len)) {
            e.pid = pid;   // overwrite (slot reuse under same key)
            return;
        }
        i = (i + 1) & mask;
    }
    // key not present anywhere in the chain: claim the earliest tombstone
    // (else the empty slot) — never insert before checking the whole chain,
    // or a live duplicate would shadow/unshadow nondeterministically
    if (first_free != (uint64_t)-1) {
        i = first_free;
    } else {
        s->used++;
    }
    Entry& e = s->entries[i];
    if (s->arena_len + len > s->arena_cap) {
        while (s->arena_len + len > s->arena_cap) s->arena_cap <<= 1;
        s->arena = (uint8_t*)std::realloc(s->arena, s->arena_cap);
    }
    std::memcpy(s->arena + s->arena_len, key, len);
    e.hash = hash;
    e.pid = pid;
    e.key_off = s->arena_len;
    e.key_len = len;
    s->arena_len += len;
    s->size++;
}

void ps_rehash(PartSet* s, uint64_t new_cap) {
    // rebuilds entries AND the key arena: tombstoned entries drop out and
    // their arena bytes are reclaimed, so long-running eviction churn does
    // not grow either structure without bound
    Entry* old = s->entries;
    uint64_t old_cap = s->cap;
    uint8_t* old_arena = s->arena;
    uint64_t live_bytes = 0;
    for (uint64_t i = 0; i < old_cap; i++)
        if (old[i].pid >= 0) live_bytes += old[i].key_len;
    uint64_t acap = 1 << 20;
    while (acap < live_bytes) acap <<= 1;
    s->arena = (uint8_t*)std::malloc(acap);
    s->arena_cap = acap;
    s->arena_len = 0;
    s->entries = (Entry*)std::malloc(new_cap * sizeof(Entry));
    for (uint64_t i = 0; i < new_cap; i++) s->entries[i].pid = EMPTY;
    s->cap = new_cap;
    uint64_t mask = new_cap - 1;
    uint64_t live = 0;
    for (uint64_t i = 0; i < old_cap; i++) {
        const Entry& e = old[i];
        if (e.pid < 0) continue;
        uint64_t j = e.hash & mask;
        while (s->entries[j].pid != EMPTY) j = (j + 1) & mask;
        Entry& ne = s->entries[j];
        ne = e;
        ne.key_off = s->arena_len;
        std::memcpy(s->arena + s->arena_len, old_arena + e.key_off, e.key_len);
        s->arena_len += e.key_len;
        live++;
    }
    s->used = live;
    s->size = live;
    std::free(old);
    std::free(old_arena);
}

}  // namespace

extern "C" {

void* ps_new(uint64_t cap_hint) { return ps_alloc(cap_hint); }

void ps_free(void* h) {
    PartSet* s = (PartSet*)h;
    std::free(s->entries);
    std::free(s->arena);
    std::free(s);
}

uint64_t ps_size(void* h) { return ((PartSet*)h)->size; }

void ps_insert(void* h, uint64_t hash, const uint8_t* key, uint32_t len,
               int32_t pid) {
    ps_insert_raw((PartSet*)h, hash, key, len, pid);
}

// Remove by exact key; returns 1 if removed.
int32_t ps_remove(void* h, uint64_t hash, const uint8_t* key, uint32_t len) {
    PartSet* s = (PartSet*)h;
    uint64_t mask = s->cap - 1;
    uint64_t i = hash & mask;
    while (true) {
        Entry& e = s->entries[i];
        if (e.pid == EMPTY) return 0;
        if (e.pid != TOMB && e.hash == hash && key_eq(s, e, key, len)) {
            e.pid = TOMB;   // arena bytes reclaimed at the next rehash
            s->size--;
            return 1;
        }
        i = (i + 1) & mask;
    }
}

// Batch insert: one call for a whole container's worth of new series —
// per-key ctypes calls cost ~10us each, the dominant term of cold-path
// registration (TimeSeriesShard.scala:1183's getOrAdd loop is the analog).
void ps_insert_batch(void* h, const uint64_t* hashes, const uint8_t* keys,
                     const uint64_t* offs, const int32_t* pids, int64_t n) {
    PartSet* s = (PartSet*)h;
    for (int64_t i = 0; i < n; i++) {
        ps_insert_raw(s, hashes[i], keys + offs[i],
                      (uint32_t)(offs[i + 1] - offs[i]), pids[i]);
    }
}

// Batch probe: keys concatenated, offs[n+1] prefix offsets. out_pids[i] = pid
// or -1 on miss. Returns miss count.
int64_t ps_resolve_batch(void* h, const uint64_t* hashes, const uint8_t* keys,
                         const uint64_t* offs, int64_t n, int32_t* out_pids) {
    PartSet* s = (PartSet*)h;
    int64_t misses = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t pid = ps_find(s, hashes[i], keys + offs[i],
                              (uint32_t)(offs[i + 1] - offs[i]));
        out_pids[i] = pid;
        if (pid < 0) misses++;
    }
    return misses;
}

// Sorted-unique int32 intersection. Small-vs-large pairs gallop (binary
// search of each small element into the large side, advancing the base);
// similar sizes linear-merge. out needs room for min(n_a, n_b) entries.
// Serves the part-key index's filter intersection (PartKeyLuceneIndex's
// postings intersection analog) where numpy's per-call overhead dominates
// 10k x 10k lookups.
int64_t sorted_intersect_i32(const int32_t* a, int64_t n_a,
                             const int32_t* b, int64_t n_b, int32_t* out) {
    if (n_a > n_b) { const int32_t* t = a; a = b; b = t;
                     int64_t tn = n_a; n_a = n_b; n_b = tn; }
    int64_t k = 0;
    if (n_a == 0) return 0;
    if (n_b / (n_a + 1) >= 8) {
        int64_t lo = 0;
        for (int64_t i = 0; i < n_a; i++) {
            int32_t x = a[i];
            // gallop forward from the last match position
            int64_t step = 1, hi = lo;
            while (hi < n_b && b[hi] < x) { lo = hi; hi += step; step <<= 1; }
            if (hi > n_b) hi = n_b;
            while (lo < hi) {           // binary search in (lo, hi]
                int64_t mid = (lo + hi) >> 1;
                if (b[mid] < x) lo = mid + 1; else hi = mid;
            }
            if (lo < n_b && b[lo] == x) out[k++] = x;
        }
        return k;
    }
    int64_t i = 0, j = 0;
    while (i < n_a && j < n_b) {
        int32_t x = a[i], y = b[j];
        if (x < y) i++;
        else if (y < x) j++;
        else { out[k++] = x; i++; j++; }
    }
    return k;
}

// FNV-1a 64 over concatenated keys (offs[n+1]); wire-stable with
// record.fnv1a64 (the Python per-byte loop costs ~5us per 50-byte key).
void fnv1a64_batch(const uint8_t* keys, const uint64_t* offs, int64_t n,
                   uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint64_t hv = 0xCBF29CE484222325ULL;
        for (uint64_t j = offs[i]; j < offs[i + 1]; j++) {
            hv = (hv ^ keys[j]) * 0x100000001B3ULL;
        }
        out[i] = hv;
    }
}

}  // extern "C"
