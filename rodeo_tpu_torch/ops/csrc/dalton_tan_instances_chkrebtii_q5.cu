// The instances of K11c (dalton_filter_batch_tan.cuh) for Chkrebtii's second-
// order ODE at q = 5, under kramer and rodeo, with and without data.
#include "dalton_filter_batch_tan.cuh"

namespace rodeo {

template struct DaltonFilterTanInstances<Chkrebtii, 5>;

}  // namespace rodeo
