// The exchange of warp.cuh's thread groups for a host build: a group of n
// threads run as coroutines on one host thread (tests/torch_csrc_host_check.cc,
// tests/torch_msm_host_check.cc). Included once per host library.
#pragma once

#include <stdint.h>
#include <ucontext.h>

#include <functional>
#include <vector>

#include "warp.cuh"

// A group of n threads (a team, a K3 group, a warp) as coroutines on one
// host thread, with a slot each: sync() passes control to the next thread,
// round robin, so when a thread's sync() returns, every thread has reached
// the same point.
namespace {
constexpr unsigned MAX_THREADS = 32;

struct Exchange {
  ucontext_t main_ctx, ctx[MAX_THREADS];
  unsigned n = 0, cur = 0;
  uint32_t slot[MAX_THREADS];

  void sync() {
    const unsigned me = cur;
    cur = (me + 1) % n;
    swapcontext(&ctx[me], &ctx[cur]);
  }
};

Exchange* current_ex = nullptr;                              // the group run
const std::function<void(unsigned)>* current_fn = nullptr;

void run_thread(int j) {
  (*current_fn)((unsigned)j);
  current_ex->cur = j + 1;        // uc_link resumes thread j + 1
}

// Run fn(i) as threads i = 0..n-1 of one group, in step at every exchange.
// A thread that returns hands over to the next; the last one back to the
// caller.
void run_threads(unsigned n, const std::function<void(unsigned)>& fn) {
  Exchange ex;
  ex.n = n;
  std::vector<std::vector<char>> stacks(n, std::vector<char>(1 << 18));
  for (unsigned j = 0; j < n; ++j) {
    getcontext(&ex.ctx[j]);
    ex.ctx[j].uc_stack.ss_sp = stacks[j].data();
    ex.ctx[j].uc_stack.ss_size = stacks[j].size();
    ex.ctx[j].uc_link = j + 1 < n ? &ex.ctx[j + 1] : &ex.main_ctx;
    makecontext(&ex.ctx[j], (void (*)())run_thread, 1, (int)j);
  }
  current_ex = &ex;
  current_fn = &fn;
  swapcontext(&ex.main_ctx, &ex.ctx[0]);
  current_ex = nullptr;
}


uint32_t exchange_from(unsigned j, uint32_t x, unsigned src) {
  current_ex->slot[j] = x;
  current_ex->sync();
  const uint32_t r = current_ex->slot[src];
  current_ex->sync();
  return r;
}

unsigned exchange_ballot(unsigned j, bool p) {
  current_ex->slot[j] = p;
  current_ex->sync();
  unsigned m = 0;
  for (unsigned k = 0; k < current_ex->n; ++k)
    m |= (current_ex->slot[k] != 0 ? 1u : 0u) << k;
  current_ex->sync();
  return m;
}
}  // namespace

// The exchange warp.cuh asks a host build for
namespace wp {
uint32_t group_from(unsigned i, uint32_t x, unsigned src) {
  return exchange_from(i, x, src);
}
unsigned group_ballot(unsigned i, bool p) { return exchange_ballot(i, p); }
unsigned group_thread() { return current_ex->cur; }
}  // namespace wp

