// A column-parallel reverse recursion as a stream: the ring of shared-memory
// stages filled by cp.async that the draw K6 (sampler_batch.cu) and the
// smoother rows K2r (smoother_batch_rows.cu) run.
//
// The recursion is block-diagonal, so the n_col = NB x B (block, lane)
// columns run independently; every operand is (T, D, n_col), columns
// innermost.  A CTA owns kStreamCols = 32 neighbouring columns and has two
// warps: a consumer warp, one thread per column carrying its state in
// registers from step T-1 down to 0, and a producer warp, which feeds it.
// The loads go through a ring of K shared-memory stages of S steps each:
// one step of the CTA is R runs of 32 floats (128 B each), R the rows of
// all operands (StreamRows), and the producer refills the stage the
// consumer has just consumed while the consumer works on the next, keeping
// K - 1 stages of cp.async loads in flight ahead of it.  A stage's O output
// rows per step are staged in shared memory by the consumer and leave,
// stored by the producer, as coalesced 16-byte stores, each to the address
// the kernel's dest functor gives.  With the copies, their addresses and
// the stores in the consumer's own warp, K2r's ~110 operations a step and
// the address work shared one warp's issue, and K2r ran at 44 % of its
// bound; each producer thread copies and stores the same rows of every
// step, so their addresses at step 0 and their strides are fixed once
// (StageCopies, the drain's at0 and step_of) and a copy or a store costs a
// multiply-add (PERF.md).  Where the rows are not 16-byte aligned the same
// pipeline copies and stores 4 bytes at a time (V = 1, chosen at launch);
// the last CTA masks the columns past n_col, and the last stage the steps
// before row 0, so any n_steps >= 0 and n_col >= 1 run.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace rodeo {

constexpr int kStreamCols = 32;  // columns per CTA, a consumer thread each

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           std::integral_constant<int, 16>) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           std::integral_constant<int, 4>) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rows a step reads: operand k has D_k rows of a step, operand 0's
// first.  Row r of a step is row rank(r) of operand op(r).  Each is a chain
// of compares and selects, not an indexed array, which for a runtime
// argument would sit in local memory.
template <int... D>
struct StreamRows {
  static constexpr int kOps = sizeof...(D);
  static constexpr int R = (D + ...);
  __host__ __device__ static constexpr int depth(int k) {
    int i = 0, d = 0;
    ((d = i++ == k ? D : d), ...);
    return d;
  }
  // the operands whose rows end at or before r, at most the last
  __host__ __device__ static constexpr int op(int r) {
    int k = 0, end = 0;
    ((end += D, k += r >= end ? 1 : 0), ...);
    return k < kOps ? k : kOps - 1;
  }
  __host__ __device__ static constexpr int rank(int r) {
    const int k = op(r);
    int i = 0, first = 0, end = 0;
    ((first = i++ == k ? end : first, end += D), ...);
    return r - first;
  }
};

// a[k] for a runtime k, by selects
template <int N>
__device__ __forceinline__ const float* pick(const float* const (&a)[N],
                                             int k) {
  const float* r = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (k == i) r = a[i];
  return r;
}

// The first column, from the CTA's, of thread tx's chunk of a row when a
// copy or store moves V floats.
template <int V>
__device__ __forceinline__ int chunk_col(int tx) {
  return tx % (kStreamCols / V) * V;
}

// A producer thread's share of the copies of a stage.  A copy moves V
// floats, so a row of kStreamCols floats is kStreamCols / V copies and the
// warp takes V rows of a step at a time: lane l copies chunk l %
// (kStreamCols / V) of rows r_j = l / (kStreamCols / V) + j V, j < ceil(R /
// V), of every step (those below R).  The address of each of its rows at
// step 0 and the floats from one step's row to the next are fixed, so a
// copy costs a multiply-add.
template <class Rows, int V>
struct StageCopies {
  static constexpr int kChunks = kStreamCols / V;
  static constexpr int kRows = (Rows::R + V - 1) / V;  // rows a thread copies
  static_assert(kStreamCols % V == 0, "V must divide the CTA's columns");
  int col;                // the thread's chunk: first column, from the CTA's
  int row0;               // the thread's first row of a step
  const float* src[kRows];
  int stride[kRows];

  __device__ StageCopies(int lane, size_t n_col, size_t col0,
                         const float* const (&ops)[Rows::kOps])
      : col(chunk_col<V>(lane)), row0(lane / kChunks) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = row0 + j * V;
      const int o = Rows::op(r);
      src[j] = pick(ops, o) + Rows::rank(r) * n_col + col0 + col;
      stride[j] = Rows::depth(o) * static_cast<int>(n_col);
    }
  }

  // whether the thread's j-th row of a step exists (R is not always a
  // multiple of V)
  __device__ __forceinline__ bool has_row(int j) const {
    return Rows::R % V == 0 || row0 + j * V < Rows::R;
  }
};

// Issue the copies of stage k (steps top, top - 1, .., down to row 0 at
// most, top = n_steps - 1 - k S) into ring slot `slot`, and commit them as
// one group; past the last stage, commit an empty group, so that the count
// of groups stays the count of stages.
template <class Rows, int V, int S>
__device__ __forceinline__ void fill_stage(
    float (&slot)[S][Rows::R][kStreamCols], int k, int n_stage, int n_steps,
    int width, const StageCopies<Rows, V>& w) {
  using Copies = StageCopies<Rows, V>;
  if (k < n_stage && w.col < width) {
    const int top = n_steps - 1 - k * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s > top) break;  // before row 0
      const int n = top - s;
#pragma unroll
      for (int j = 0; j < Copies::kRows; ++j)
        if (w.has_row(j))
          copy_async(&slot[s][w.row0 + j * V][w.col],
                     w.src[j] + static_cast<long long>(n) * w.stride[j],
                     std::integral_constant<int, 4 * V>());
    }
  }
  commit_async();
}

// The named barriers through which the two warps of a CTA hand the ring's
// stages to each other (barrier 0 is __syncthreads'): the producer arrives
// at kRingFull when a stage has landed and the consumer waits there; the
// consumer arrives at kRingDone when it has consumed a stage and staged its
// output rows, and the producer waits there.  Each is passed once a stage,
// in order, by all 2 x kStreamCols threads.
constexpr int kRingFull = 1;
constexpr int kRingDone = 2;

__device__ __forceinline__ void ring_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kStreamCols)
               : "memory");
}

__device__ __forceinline__ void ring_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kStreamCols)
               : "memory");
}

// The threads of a stream's CTA: warp 0 consumes (thread t carries column
// col0 + t), warp 1 produces (copies the operands in, stores the staged
// output rows out).
inline dim3 stream_cta() { return dim3(2 * kStreamCols); }

// The stream of one CTA: columns col0 .. col0 + width - 1 of n_col, steps
// n_steps - 1 down to 0, operand arrays ops (T, D_k, n_col) in the order of
// Rows.  The consumer thread of each live column t calls step(n, v, out, t)
// for each step n, with its column's R operands of the step in v (in
// registers), and writes its O output rows out[O][kStreamCols]; the
// producer warp keeps the ring's K - 1 next stages of copies in flight and
// stores output row o of step n, V floats at a time, to dest(n, o), the
// address of that row at the producer thread's chunk (column col0 +
// chunk_col<V>(lane), lane = threadIdx.x - kStreamCols), which the kernel
// computes.  The two warps meet twice a stage (kRingFull, kRingDone), so
// that the consumer's stream of instructions is the recursion's alone and
// the copies' and stores' addresses are worked out beside it.  ring holds K
// stages, out two stages of output rows (the consumer stages one while the
// producer stores the other); both 16-byte aligned.  Every thread of the
// CTA must call this (it holds barriers).
template <class Rows, int O, int V, int S, int K, class Step, class Dest>
__device__ __forceinline__ void stream_stages(
    float (*ring)[S][Rows::R][kStreamCols],
    float (&out)[2][S][O][kStreamCols], int n_steps, size_t n_col,
    size_t col0, int width, const float* const (&ops)[Rows::kOps],
    Step&& step, Dest&& dest) {
  static_assert(S * O % V == 0, "a stage's output rows go V at a time");
  const int n_stage = (n_steps + S - 1) / S;
  if (threadIdx.x < kStreamCols) {
    const int t = threadIdx.x;
    for (int k = 0; k < n_stage; ++k) {
      ring_wait(kRingFull);  // stage k has landed
      const int top = n_steps - 1 - k * S;
      const float(&in)[S][Rows::R][kStreamCols] = ring[k % K];
      if (t < width) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s > top) break;
          float v[Rows::R];  // column t's operands of the step
#pragma unroll
          for (int r = 0; r < Rows::R; ++r) v[r] = in[s][r][t];
          step(top - s, v, out[k & 1][s], t);
        }
      }
      ring_arrive(kRingDone);  // its slot is free, its rows staged
    }
    return;
  }
  // the producer: lane l of warp 1 (threadIdx.x % kStreamCols, so that the
  // compiler knows it below kStreamCols)
  const StageCopies<Rows, V> w(threadIdx.x % kStreamCols, n_col, col0, ops);
  // the thread's staged output rows f = s O + o, f = w.row0 + p V: their
  // steps s, and where V = 4 (a thread's row then varies with its lane) the
  // address of each at step 0 and the floats between steps (dest is linear
  // in n), so that a store costs a multiply-add
  constexpr int P = S * O / V;
  int s_of[P];
  float* at0[V == 4 ? P : 1];
  int step_of[V == 4 ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int f = w.row0 + p * V;
    s_of[p] = f / O;
    if constexpr (V == 4) {
      at0[p] = dest(0, f % O);
      step_of[p] = static_cast<int>(dest(1, f % O) - at0[p]);
    }
  }
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    fill_stage<Rows, V, S>(ring[k], k, n_stage, n_steps, width, w);
  for (int k = 0; k <= n_stage; ++k) {
    // the slot of stage k - 1, free once the consumer is done with it
    if (k > 0) ring_wait(kRingDone);
    if (k < n_stage) {
      fill_stage<Rows, V, S>(ring[(k + K - 1) % K], k + K - 1, n_stage,
                             n_steps, width, w);
      wait_async<K - 1>();     // this thread's copies of stage k have landed
      ring_arrive(kRingFull);  // and, once the warp has arrived, every one's
    }
    // the output rows of stage k - 1
    if (k == 0 || w.col >= width) continue;
    const int top = n_steps - 1 - (k - 1) * S;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int f = w.row0 + p * V;
      const int s = s_of[p];
      if (s > top) continue;
      const float* src = &out[(k - 1) & 1][s][f % O][w.col];
      if constexpr (V == 4) {
        float* dst = at0[p] + static_cast<long long>(top - s) * step_of[p];
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        *dest(top - s, f % O) = *src;
      }
    }
  }
}

// Whether every row of these arrays can move 16 bytes at a time: n_col a
// multiple of 4 floats and each base address 16-byte aligned.
template <class... P>
bool stream_aligned(int n_col, const P*... ptrs) {
  return n_col % 4 == 0 &&
         ((reinterpret_cast<std::uintptr_t>(ptrs) % 16 == 0) && ...);
}

}  // namespace rodeo
