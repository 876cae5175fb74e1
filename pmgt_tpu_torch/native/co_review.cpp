// Co-review pair counting for the item-graph build (the expensive part of
// reference notebook cell 20: item_user_mat @ item_user_mat^T with a
// min-common-users threshold). Streams (item, user) records, dedups them,
// and counts item co-occurrences per user with an open-addressing hash
// table — no dense or CSR matmul materialization, so production-scale
// dumps build in O(sum_u n_u^2) pair updates and O(edges) memory.
//
// Two-call protocol (ctypes): co_review_build returns the qualifying edge
// count (or -1 when the pair workload exceeds the safety cap and the
// caller should fall back to the scipy path); co_review_fetch copies the
// (src, dst, common_count) triples out and frees the staging buffers.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Slot {
  uint64_t key;   // (i << 32) | j, i < j; key 0 means empty (pair (0,0)
                  // is remapped to the sentinel handling below)
  int32_t count;
};

std::vector<int32_t> g_src, g_dst, g_count;

}  // namespace

extern "C" {

// items/users: m parallel int32 arrays. Returns #edges with
// count >= min_common, or -1 if the quadratic pair workload exceeds
// `max_pairs` (caller falls back).
int64_t co_review_build(const int32_t* items, const int32_t* users,
                        int64_t m, int32_t min_common, int64_t max_pairs) {
  g_src.clear();
  g_dst.clear();
  g_count.clear();

  // Group by user and dedup (user, item) records.
  std::vector<std::pair<int32_t, int32_t>> rec(static_cast<size_t>(m));
  for (int64_t i = 0; i < m; ++i) {
    rec[static_cast<size_t>(i)] = {users[i], items[i]};
  }
  std::sort(rec.begin(), rec.end());
  rec.erase(std::unique(rec.begin(), rec.end()), rec.end());

  // Pair workload bound.
  int64_t total_pairs = 0;
  for (size_t s = 0; s < rec.size();) {
    size_t e = s;
    while (e < rec.size() && rec[e].first == rec[s].first) ++e;
    const int64_t n = static_cast<int64_t>(e - s);
    total_pairs += n * (n - 1) / 2;
    s = e;
  }
  if (total_pairs > max_pairs) return -1;

  // Open-addressing table sized for the pair multiset (upper bound:
  // every pair distinct).
  size_t cap = 16;
  while (static_cast<int64_t>(cap) < 2 * std::max<int64_t>(total_pairs, 1)) {
    cap <<= 1;
  }
  std::vector<Slot> table(cap, Slot{0, 0});
  const uint64_t mask = cap - 1;
  const uint64_t kEmpty = ~0ULL;  // (i,j) == (0xffffffff, ...) impossible
  for (auto& s : table) s.key = kEmpty;

  auto bump = [&](uint64_t key) {
    uint64_t h = key * 0x9E3779B97F4A7C15ULL;
    size_t idx = static_cast<size_t>(h & mask);
    for (;;) {
      Slot& s = table[idx];
      if (s.key == key) {
        ++s.count;
        return;
      }
      if (s.key == kEmpty) {
        s.key = key;
        s.count = 1;
        return;
      }
      idx = (idx + 1) & mask;
    }
  };

  for (size_t s = 0; s < rec.size();) {
    size_t e = s;
    while (e < rec.size() && rec[e].first == rec[s].first) ++e;
    for (size_t a = s; a < e; ++a) {
      const uint64_t ia = static_cast<uint32_t>(rec[a].second);
      for (size_t b = a + 1; b < e; ++b) {
        const uint64_t ib = static_cast<uint32_t>(rec[b].second);
        const uint64_t key =
            ia < ib ? (ia << 32) | ib : (ib << 32) | ia;
        bump(key);
      }
    }
    s = e;
  }

  for (const Slot& s : table) {
    if (s.key != kEmpty && s.count >= min_common) {
      g_src.push_back(static_cast<int32_t>(s.key >> 32));
      g_dst.push_back(static_cast<int32_t>(s.key & 0xffffffffULL));
      g_count.push_back(s.count);
    }
  }
  return static_cast<int64_t>(g_src.size());
}

void co_review_fetch(int32_t* src, int32_t* dst, int32_t* count) {
  std::copy(g_src.begin(), g_src.end(), src);
  std::copy(g_dst.begin(), g_dst.end(), dst);
  std::copy(g_count.begin(), g_count.end(), count);
  g_src.clear();
  g_src.shrink_to_fit();
  g_dst.clear();
  g_dst.shrink_to_fit();
  g_count.clear();
  g_count.shrink_to_fit();
}

}  // extern "C"
