// The instances of K1 (filter_batch.cuh) and K3 (filter_single.cuh) for
// Hes1 at q = 3, one in each interrogation mode.
#include "filter_batch.cuh"
#include "filter_single.cuh"

namespace rodeo {

template struct FilterBatchInstances<Hes1, 3>;
template struct FilterSingleInstances<Hes1, 3>;

}  // namespace rodeo
