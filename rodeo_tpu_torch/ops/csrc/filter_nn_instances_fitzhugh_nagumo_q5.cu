// The instances of K9 (filter_nn_batch.cuh) for FitzHugh-Nagumo at q = 5 (its
// weight and initial state padded with zeros past the third derivative),
// under kramer and rodeo, with the observation functors Gauss and Poisson.
#include "filter_nn_batch.cuh"

namespace rodeo {

template struct NnFilterInstances<FitzHughNagumo, 5>;

}  // namespace rodeo
