// The instances of K9 (filter_nn_batch.cuh) for FitzHugh-Nagumo at q = 3,
// under kramer and rodeo, with the observation functors Gauss and Poisson.
#include "filter_nn_batch.cuh"

namespace rodeo {

template struct NnFilterInstances<FitzHughNagumo, 3>;

}  // namespace rodeo
