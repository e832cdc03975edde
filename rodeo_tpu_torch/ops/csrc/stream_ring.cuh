// A recursion as a stream: the ring of shared-memory stages filled by
// cp.async that the draw K6 (sampler_batch.cu), the smoother rows K2r
// (smoother_batch_rows.cu), fenrir's backward filters K7b
// (fenrir_backward_batch.cu), K11b (fenrir_backward_batch_tan.cuh) and K7a
// (fenrir_backward_single.cu), the single-solve smoother K4
// (smoother_single.cu), MAGI's filter K10a (magi_batch.cu) and its adjoint
// K10b (magi_adjoint_batch.cu) run.
//
// A CTA has W consumer warps, which carry the recursion's state in
// registers from step T-1 down to 0 (K10a, a forward recursion: from step 0
// up to T-1; FWD below), and a producer warp, which feeds them
// (ring_consume, ring_produce).  The loads go through a ring of K
// shared-memory stages of S steps each, and the producer refills the stage
// the consumers have just consumed while they work on the next, keeping K
// - 1 stages of cp.async loads in flight ahead of them; the warps meet
// twice a stage at named barriers.  A stage's output rows are staged in
// shared memory by the consumers and leave, stored by the producer, as
// coalesced 16-byte stores.  With the copies, their addresses and the
// stores in the consumer's own warp, K2r's ~110 operations a step and the
// address work shared one warp's issue, and K2r ran at 44 % of its bound;
// each producer thread copies and stores the same rows of every step, so
// their addresses at step 0 and their strides are fixed once (StageCopies,
// the drain's at0 and step_of) and a copy or a store costs a multiply-add
// (PERF.md).
//
// The column streams (K6, K2r, K7b, K11b, K10a, K10b): the recursion is
// block-diagonal, so the n_col = NB x B (block, lane) columns run
// independently; every operand is (T, D, n_col), columns innermost.  A CTA
// owns kStreamCols = 32 neighbouring columns, a consumer thread each (a warp
// per theta direction in K11b); one step of the CTA is R runs of 32 floats
// (128 B each), R the rows of all operands (StreamRows).  Where the rows are
// not 16-byte aligned the same pipeline copies and stores 4 bytes at a time
// (V = 1, chosen at launch); the last CTA masks the columns past n_col, and
// the last stage the steps past the last, so any n_steps >= 0 and n_col >= 1
// run.  The slab streams (K4, K7a) read the single-solve layout (T, NB, D)
// in slabs of consecutive rows (SlabRuns).
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
  // operand k's first row of a step
  __host__ __device__ static constexpr int first(int k) {
    int i = 0, f = 0, end = 0;
    ((f = i++ == k ? end : f, end += D), ...);
    return f;
  }
  // the operands whose rows end at or before r, at most the last
  __host__ __device__ static constexpr int op(int r) {
    int k = 0, end = 0;
    ((end += D, k += r >= end ? 1 : 0), ...);
    return k < kOps ? k : kOps - 1;
  }
  __host__ __device__ static constexpr int rank(int r) {
    return r - first(op(r));
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
// warp takes V rows at a time: lane l copies chunk l % (kStreamCols / V) of
// the rows row0 + j V, row0 = l / (kStreamCols / V), of every step.  The
// address of each of its rows at step n is fixed up to n, so a copy costs a
// multiply-add.  Where a thread copies few rows of a step (kFixed), the
// rows are those of the step, j < ceil(R / V), and the address of each at
// step 0 and the floats from one step's row to the next are kept (src,
// stride); else the rows are each operand's own, j < ceil(D_k / V), and
// the address comes from the operand's at step 0 (base, row0 included), so
// that a thread keeps three pointers, not two numbers a row.
template <class Rows, int V>
struct StageCopies {
  static constexpr int kChunks = kStreamCols / V;
  static constexpr int kRows = (Rows::R + V - 1) / V;  // rows of a step
  static constexpr bool kFixed = kRows <= 8;
  static constexpr int kKept = kFixed ? kRows : 1;
  static_assert(kStreamCols % V == 0, "V must divide the CTA's columns");
  int col;                // the thread's chunk: first column, from the CTA's
  int row0;               // the thread's first row of a step (of an operand)
  int n_col;
  const float* src[kKept];
  int stride[kKept];
  const float* base[Rows::kOps];

  __device__ StageCopies(int lane, size_t n_col_, size_t col0,
                         const float* const (&ops)[Rows::kOps])
      : col(chunk_col<V>(lane)), row0(V == 1 ? 0 : lane / kChunks),
        n_col(static_cast<int>(n_col_)) {
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = row0 + j * V;
        const int o = Rows::op(r);
        src[j] = pick(ops, o) + Rows::rank(r) * n_col_ + col0 + col;
        stride[j] = Rows::depth(o) * n_col;
      }
    } else {
#pragma unroll
      for (int o = 0; o < Rows::kOps; ++o)
        base[o] = ops[o] + row0 * n_col_ + col0 + col;
    }
  }

  // Issue the thread's copies of step n into dst, the step's rows of a
  // stage.
  __device__ __forceinline__ void copy_step(
      float (&dst)[Rows::R][kStreamCols], int n) const {
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (Rows::R % V == 0 || row0 + j * V < Rows::R)
          copy_async(&dst[row0 + j * V][col],
                     src[j] + static_cast<long long>(n) * stride[j],
                     std::integral_constant<int, 4 * V>());
    } else {
      copy_operands(dst, n, std::make_integer_sequence<int, Rows::kOps>());
    }
  }

 private:
  // operand O's rows of step n, each operand's loop known to the compiler
  // (an operand index the compiler does not know would put base in local
  // memory)
  template <int... O>
  __device__ __forceinline__ void copy_operands(
      float (&dst)[Rows::R][kStreamCols], int n,
      std::integer_sequence<int, O...>) const {
    (copy_operand<O>(dst, n), ...);
  }

  template <int O>
  __device__ __forceinline__ void copy_operand(
      float (&dst)[Rows::R][kStreamCols], int n) const {
    constexpr int depth = Rows::depth(O), first = Rows::first(O);
    const float* at = base[O] + static_cast<long long>(n) * depth * n_col;
#pragma unroll
    for (int j = 0; j < (depth + V - 1) / V; ++j)
      if (depth % V == 0 || row0 + j * V < depth)
        copy_async(&dst[first + row0 + j * V][col],
                   at + static_cast<long long>(j) * V * n_col,
                   std::integral_constant<int, 4 * V>());
  }
};

// Step s of stage k of a column stream, top = n_steps - 1 - k S: stage k
// holds its steps s = 0 .. min(S - 1, top), the last stage the steps left
// over.  A reverse stream counts them down from step top, a forward one (FWD)
// up from step k S.
template <bool FWD>
__device__ __forceinline__ int stage_step(int n_steps, int top, int s) {
  return FWD ? n_steps - 1 - top + s : top - s;
}

// Issue the copies of stage k (its steps, stage_step) into ring slot
// `slot`, and commit them as one group; past the last stage, commit an empty
// group, so that the count of groups stays the count of stages.
template <class Rows, int V, int S, bool FWD = false>
__device__ __forceinline__ void fill_stage(
    float (&slot)[S][Rows::R][kStreamCols], int k, int n_stage, int n_steps,
    int width, const StageCopies<Rows, V>& w) {
  if (k < n_stage && w.col < width) {
    const int top = n_steps - 1 - k * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s > top) break;  // past the last step
      w.copy_step(slot[s], stage_step<FWD>(n_steps, top, s));
    }
  }
  commit_async();
}

// The slab copy, the single-solve layout's counterpart of StageCopies: an
// operand (T, NB, D) with the entries of a block innermost, of which a CTA
// holding the blocks b0 .. b0 + width - 1 reads, at row n, the run of width
// D floats from (n NB + b0) D.  A stage is the rows lo .. hi, lo a multiple
// of the stage's rows; in shared memory it is [(n - lo) width + b] D + e,
// the runs one after the other.  Where the CTA holds every block (width =
// NB) the runs of consecutive rows join in device memory too, and the stage
// is one slab of (hi - lo + 1) NB D floats from lo NB D: V = 4 then moves it
// 16 bytes at a time from an aligned start (lo NB D is a multiple of 4
// floats when the stage's rows are), the last floats of a stage that is no
// multiple of 4 floats 4 bytes at a time; V = 1 moves every float on its
// own, run by run.  each(D, lo, hi, lane, f) calls f(s, g, v) for the
// chunks of lane `lane` of the warp: v floats (4 or 1) at float s of the
// stage in shared memory and float g of the operand.  The same chunks copy
// a stage in (copy_async) and store its staged output rows out.
template <int V>
struct SlabRuns {
  int n_block, b0, width;

  template <class F>
  __device__ __forceinline__ void each(int D, int lo, int hi, int lane,
                                       F&& f) const {
    const int run = width * D;           // floats of a row
    const int n = (hi - lo + 1) * run;   // floats of the stage
    if constexpr (V == 4) {
      const long long g0 = static_cast<long long>(lo) * run;
      const int body = n & ~3;
      for (int i = 4 * lane; i < body; i += 4 * 32) f(i, g0 + i, 4);
      for (int i = body + lane; i < n; i += 32) f(i, g0 + i, 1);
    } else {
      for (int i = lane; i < n; i += 32) {
        const int r = i / run;
        f(i, (static_cast<long long>(lo + r) * n_block + b0) * D + i - r * run,
          1);
      }
    }
  }
};

// Copy chunk (s, g, v) of a slab stage in.
__device__ __forceinline__ void copy_chunk(float* stage, const float* src,
                                           int s, long long g, int v) {
  if (v == 4)
    copy_async(stage + s, src + g, std::integral_constant<int, 16>());
  else
    copy_async(stage + s, src + g, std::integral_constant<int, 4>());
}

// Store chunk (s, g, v) of a staged slab stage out.
__device__ __forceinline__ void store_chunk(float* dst, const float* stage,
                                            int s, long long g, int v) {
  if (v == 4)
    *reinterpret_cast<float4*>(dst + g) =
        *reinterpret_cast<const float4*>(stage + s);
  else
    dst[g] = stage[s];
}

// The named barriers through which the warps of a CTA hand the ring's
// stages to each other (barrier 0 is __syncthreads'): the producer arrives
// at kRingFull when a stage has landed and the consumers wait there; the
// consumers arrive at kRingDone when they have consumed a stage and staged
// its output rows, and the producer waits there.  Each is passed once a
// stage, in order, by the W consumer warps and the producer warp, (W + 1) x
// 32 threads.
constexpr int kRingFull = 1;
constexpr int kRingDone = 2;

template <int W>
__device__ __forceinline__ void ring_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"((W + 1) * 32)
               : "memory");
}

template <int W>
__device__ __forceinline__ void ring_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"((W + 1) * 32)
               : "memory");
}

// The ring's two sides, one ring for every stream of the port: the column
// streams K6, K2r, K10a and K10b (stream_stages below), K7b, K11b and
// K10a's "ld" emit, and the slab streams K4 and K7a.  The W consumer warps
// (threads 0 .. 32 W - 1) call ring_consume, the producer warp (the next
// 32 threads) ring_produce, with the same n_stage stages and K slots.
//
// consume(k, slot): the consumers' work on stage k, which has landed in
// ring slot `slot` = k % K.
template <int W, int K, class Consume>
__device__ __forceinline__ void ring_consume(int n_stage, Consume&& consume) {
  for (int k = 0; k < n_stage; ++k) {
    ring_wait<W>(kRingFull);  // stage k has landed
    consume(k, k % K);
    ring_arrive<W>(kRingDone);  // its slot is free, its rows staged
  }
}

// fill(k, slot): issue the copies of stage k into ring slot `slot`, none
// past the last stage, and commit them as one group (an empty one past the
// last stage, so that the count of groups stays the count of stages);
// drain(k): the producer's work once the consumers are done with stage k
// (storing the output rows they staged).  The producer keeps the ring's K -
// 1 next stages of copies in flight.
template <int W, int K, class Fill, class Drain>
__device__ __forceinline__ void ring_produce(int n_stage, Fill&& fill,
                                             Drain&& drain) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k) fill(k, k);
  for (int k = 0; k <= n_stage; ++k) {
    // the slot of stage k - 1, free once the consumers are done with it
    if (k > 0) ring_wait<W>(kRingDone);
    if (k < n_stage) {
      fill(k + K - 1, (k + K - 1) % K);
      wait_async<K - 1>();        // this thread's copies of stage k landed
      ring_arrive<W>(kRingFull);  // and, once the warp has arrived, every one's
    }
    if (k > 0) drain(k - 1);
  }
}

// The threads of a stream's CTA: warp 0 consumes (thread t carries column
// col0 + t), warp 1 produces (copies the operands in, stores the staged
// output rows out).
inline dim3 stream_cta() { return dim3(2 * kStreamCols); }

// The stream of one CTA: columns col0 .. col0 + width - 1 of n_col, steps
// n_steps - 1 down to 0 (FWD: 0 up to n_steps - 1), operand arrays ops (T,
// D_k, n_col) in the order of
// Rows, on the ring (ring_consume, ring_produce) with one consumer warp.
// The consumer thread of each live column t calls step(n, v, out, t) for
// each step n, with its column's R operands of the step in v (in
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
template <class Rows, int O, int V, int S, int K, bool FWD = false,
          class Step, class Dest>
__device__ __forceinline__ void stream_stages(
    float (*ring)[S][Rows::R][kStreamCols],
    float (&out)[2][S][O][kStreamCols], int n_steps, size_t n_col,
    size_t col0, int width, const float* const (&ops)[Rows::kOps],
    Step&& step, Dest&& dest) {
  static_assert(S * O % V == 0, "a stage's output rows go V at a time");
  const int n_stage = (n_steps + S - 1) / S;
  if (threadIdx.x < kStreamCols) {
    const int t = threadIdx.x;
    ring_consume<1, K>(n_stage, [&](int k, int slot) {
      const int top = n_steps - 1 - k * S;
      const float(&in)[S][Rows::R][kStreamCols] = ring[slot];
      if (t < width) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s > top) break;
          float v[Rows::R];  // column t's operands of the step
#pragma unroll
          for (int r = 0; r < Rows::R; ++r) v[r] = in[s][r][t];
          step(stage_step<FWD>(n_steps, top, s), v, out[k & 1][s], t);
        }
      }
    });
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
  ring_produce<1, K>(
      n_stage,
      [&](int k, int slot) {
        fill_stage<Rows, V, S, FWD>(ring[slot], k, n_stage, n_steps, width,
                                    w);
      },
      [&](int k) {  // the output rows of stage k
        if (w.col >= width) return;
        const int top = n_steps - 1 - k * S;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int f = w.row0 + p * V;
          const int s = s_of[p];
          if (s > top) continue;
          const float* src = &out[k & 1][s][f % O][w.col];
          const int n = stage_step<FWD>(n_steps, top, s);
          if constexpr (V == 4) {
            float* dst = at0[p] + static_cast<long long>(n) * step_of[p];
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(src);
          } else {
            *dest(n, f % O) = *src;
          }
        }
      });
}

// Whether every pointer is 16-byte aligned.
template <class... P>
bool aligned16(const P*... ptrs) {
  return ((reinterpret_cast<std::uintptr_t>(ptrs) % 16 == 0) && ...);
}

// Whether every row of these arrays can move 16 bytes at a time: n_col a
// multiple of 4 floats and each base address 16-byte aligned.
template <class... P>
bool stream_aligned(int n_col, const P*... ptrs) {
  return n_col % 4 == 0 && aligned16(ptrs...);
}

}  // namespace rodeo
