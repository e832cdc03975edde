// The instances of K1 (filter_batch.cuh) and K3 (filter_single.cuh) for
// Lorenz63 at q = 3, one in each interrogation mode.
#include "filter_batch.cuh"
#include "filter_single.cuh"

namespace rodeo {

template struct FilterBatchInstances<Lorenz63, 3>;
template struct FilterSingleInstances<Lorenz63, 3>;

}  // namespace rodeo
