// The instances of K11d (filter_nn_batch_tan.cuh) for SEIRAH at q = 3 (its
// Jacobian on nested Duals under kramer), under kramer and rodeo,
// with the observation functors Gauss and Poisson.
#include "filter_nn_batch_tan.cuh"

namespace rodeo {

template struct NnFilterTanInstances<Seirah, 3>;

}  // namespace rodeo
