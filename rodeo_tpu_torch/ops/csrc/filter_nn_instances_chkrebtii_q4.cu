// The instances of K9 (filter_nn_batch.cuh) for Chkrebtii's second-order ODE
// at q = 4, under kramer and rodeo, with the observation functors Gauss and
// Poisson.
#include "filter_nn_batch.cuh"

namespace rodeo {

template struct NnFilterInstances<Chkrebtii, 4>;

}  // namespace rodeo
