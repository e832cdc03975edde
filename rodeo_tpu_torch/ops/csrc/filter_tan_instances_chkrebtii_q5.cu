// The instances of K11a (filter_batch_tan.cuh) for Chkrebtii's second-order
// ODE at q = 5, under kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<Chkrebtii, 5>;

}  // namespace rodeo
