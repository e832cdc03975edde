// The instances of K11a (filter_batch_tan.cuh) for Chkrebtii's second-order
// ODE at q = 4, under kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<Chkrebtii, 4>;

}  // namespace rodeo
