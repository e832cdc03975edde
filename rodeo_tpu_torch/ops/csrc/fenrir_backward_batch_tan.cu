// The C entry points of K11b, fenrir's tangent backward filter
// (fenrir_backward_batch_tan.cuh): each picks the instance of (q, n_tan)
// and calls its launch, compiled in fenrir_tan_instances_q*.cu.
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "fenrir_tan_instances.cuh"
#include "stream_ring.cuh"

// q: the derivatives per block, 3, 4 or 5; n_tan tangent directions, 1 to
// kMaxTan (7); any other returns cudaErrorInvalidValue.  Every pointer is
// device memory laid out as fenrir_backward_batch_tan (ops/fused_fenrir.py)
// documents: the chain A, b, C (N, NAUG d, n_block, B), the seeds m_seed
// (NAUG q, n_block, B) and p_seed (NAUG n_tri, ..), the observation grid as
// for rodeo_fenrir_backward_batch; ld_blocks is (NAUG, n_block, B).  Rows go
// 16 bytes at a time where n_block x B is a multiple of 4 and A, b and C
// are 16-byte aligned, else 4 bytes at a time.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_tan(
    int q, int n_steps, int n_block, int n_lane, int n_tan, const void* A,
    const void* b, const void* C, const void* d, const void* y,
    const void* om, const void* mask, const void* m_seed, const void* p_seed,
    void* ld_blocks, void* stream) {
  using namespace rodeo;
  if (n_steps < 1 || n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const bool vec = stream_aligned(n_block * n_lane, A, b, C);
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  const FenrirTanArgs a{n_steps,   n_block, n_lane,  in(A),      in(b),
                        in(C),     in(d),   in(y),   in(om),     in(mask),
                        in(m_seed), in(p_seed), static_cast<float*>(ld_blocks)};
  auto s = static_cast<cudaStream_t>(stream);
  return with_value<3, 4, 5>(q, [&](auto qq) {
    return FenrirTanInstances<decltype(qq)::value>::launch(n_tan, vec, a, s);
  });
}

// The launch rodeo_fenrir_backward_batch_tan makes at q for n_block x
// n_lane columns and n_tan directions with aligned operands on the current
// device, as report_geometry's nine ints (block_step.cuh; the shared memory
// is the ring's, dynamic), then the ring's stages and the steps a stage
// holds, in out.  Returns a cudaError_t.
extern "C" int rodeo_fenrir_backward_batch_tan_geometry(int q, int n_block,
                                                        int n_lane, int n_tan,
                                                        void* out) {
  using namespace rodeo;
  if (n_block < 1 || n_lane < 1) return cudaErrorInvalidValue;
  const int n_col = n_block * n_lane;
  return with_value<3, 4, 5>(q, [&](auto qq) {
    return FenrirTanInstances<decltype(qq)::value>::geometry(
        n_tan, n_col, n_col % 4 == 0, static_cast<int*>(out));
  });
}
