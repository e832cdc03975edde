// The instances of K1 (filter_batch.cuh) and K3 (filter_single.cuh) for
// Chkrebtii's second-order ODE at q = 4, one in each interrogation mode.
#include "filter_batch.cuh"
#include "filter_single.cuh"

namespace rodeo {

template struct FilterBatchInstances<Chkrebtii, 4>;
template struct FilterSingleInstances<Chkrebtii, 4>;

}  // namespace rodeo
