// mfa_tpu_torch native runtime: host-side serving bookkeeping (a copy of
// the JAX package's csrc/runtime.cpp, the same C ABI).
//
// The host work that stays hot in a continuous-batching engine is its
// bookkeeping: page allocation, admission control and block-table
// assembly across many concurrent sequences, every decode step. Those
// loops live here as a plain C ABI with no CUDA, loaded through ctypes.
// mfa_tpu_torch/utils/native.py builds it with g++ at first use into
// mfa_tpu_torch/_build/<key>/ (nvcc never sees this file).
//
// Ownership model: one Allocator per model replica. All functions are
// single-threaded by design: the scheduler is deterministic and owns its
// allocator (mfa_tpu_torch/serve/scheduler.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- allocator

struct Allocator {
  std::vector<int32_t> free_list;  // LIFO stack of free page ids
  int32_t num_pages;
};

// Page 0 is reserved as the null page (uninitialized block-table entries
// must stay in bounds), matching the Python PageAllocator.
Allocator* mfa_alloc_create(int32_t num_pages) {
  auto* a = new Allocator();
  a->num_pages = num_pages;
  a->free_list.reserve(num_pages);
  for (int32_t p = num_pages - 1; p >= 1; --p) a->free_list.push_back(p);
  return a;
}

void mfa_alloc_destroy(Allocator* a) { delete a; }

int32_t mfa_alloc_free_count(const Allocator* a) {
  return static_cast<int32_t>(a->free_list.size());
}

// Pop n pages into out. Returns n on success, -1 (no change) on exhaustion.
int32_t mfa_alloc_pages(Allocator* a, int32_t n, int32_t* out) {
  if (n < 0 || static_cast<size_t>(n) > a->free_list.size()) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = a->free_list.back();
    a->free_list.pop_back();
  }
  return n;
}

void mfa_free_pages(Allocator* a, const int32_t* pages, int32_t n) {
  for (int32_t i = 0; i < n; ++i) {
    if (pages[i] > 0 && pages[i] < a->num_pages) a->free_list.push_back(pages[i]);
  }
}

// ---------------------------------------------------------------- admission

// Greedy FIFO admission (scheduler.admit): walk prompt lengths in order,
// admit while a slot and ceil(len/page)+1 pages are available. Writes the
// number of prompt pages per admitted request into pages_needed and
// returns the number admitted. Pure function of its inputs (allocator not
// consulted so Python can dry-run); headroom=1 page per request keeps the
// first decode token from OOMing.
int32_t mfa_admit(const int32_t* prompt_lens, int32_t n_waiting,
                  int32_t free_slots, int32_t free_pages, int32_t page_size,
                  int32_t* pages_needed) {
  int32_t admitted = 0;
  int64_t budget = free_pages;
  while (admitted < n_waiting && admitted < free_slots) {
    int32_t len = prompt_lens[admitted];
    int32_t np = (len + page_size - 1) / page_size;
    if (np == 0) np = 1;
    if (budget < np + 1) break;
    pages_needed[admitted] = np;
    budget -= np;
    ++admitted;
  }
  return admitted;
}

// ------------------------------------------------------------- page faults

// For each active sequence, decide whether its next token crosses into an
// unmapped page (scheduler.ensure_decode_page over the whole batch).
// lengths[i]: current token count; mapped_pages[i]: pages currently mapped.
// Writes 1/0 per sequence into needs_page; returns the number of sequences
// needing a page.
int32_t mfa_page_faults(const int32_t* lengths, const int32_t* mapped_pages,
                        int32_t n, int32_t page_size, int8_t* needs_page) {
  int32_t count = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t page_index = lengths[i] / page_size;
    needs_page[i] = page_index >= mapped_pages[i] ? 1 : 0;
    count += needs_page[i];
  }
  return count;
}

// --------------------------------------------------------- batch assembly

// Pack per-request page lists into a dense [n, pages_per_seq] block table
// (row-major int32, zero-filled), the layout both the paged kernels and
// the reference's block_table consume (csrc/mfa/api.cpp:242-257).
void mfa_pack_block_table(const int32_t* pages_flat, const int32_t* page_counts,
                          int32_t n, int32_t pages_per_seq, int32_t* table_out) {
  std::memset(table_out, 0, sizeof(int32_t) * static_cast<size_t>(n) * pages_per_seq);
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t c = page_counts[i];
    if (c > pages_per_seq) c = pages_per_seq;
    std::memcpy(table_out + static_cast<int64_t>(i) * pages_per_seq,
                pages_flat + off, sizeof(int32_t) * c);
    off += page_counts[i];
  }
}

// Build cu_seqlens (exclusive prefix sum with leading 0) for varlen batch
// assembly (reference semantics: interface.py:40-92).
void mfa_cu_seqlens(const int32_t* lens, int32_t n, int32_t* cu_out) {
  cu_out[0] = 0;
  for (int32_t i = 0; i < n; ++i) cu_out[i + 1] = cu_out[i] + lens[i];
}

}  // extern "C"
