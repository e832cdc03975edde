// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) for
// Chkrebtii's second-order ODE at q = 5, under kramer and rodeo, with and
// without data.
#include "dalton_filter_batch.cuh"

namespace rodeo {

template struct DaltonFilterInstances<Chkrebtii, 5>;

}  // namespace rodeo
