// The instances of K9 (filter_nn_batch.cuh) for Hes1 at q = 3, under kramer
// and rodeo, with the observation functors Gauss and Poisson.
#include "filter_nn_batch.cuh"

namespace rodeo {

template struct NnFilterInstances<Hes1, 3>;

}  // namespace rodeo
