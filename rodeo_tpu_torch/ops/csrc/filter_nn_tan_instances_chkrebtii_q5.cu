// The instances of K11d (filter_nn_batch_tan.cuh) for Chkrebtii's second-
// order ODE at q = 5, under kramer and rodeo, with the observation functors
// Gauss and Poisson.
#include "filter_nn_batch_tan.cuh"

namespace rodeo {

template struct NnFilterTanInstances<Chkrebtii, 5>;

}  // namespace rodeo
