// The instances of K11d (filter_nn_batch_tan.cuh) for FitzHugh-Nagumo at q =
// 4 (its weight and initial state padded with zeros past the third
// derivative), under kramer and rodeo, with the observation functors Gauss
// and Poisson.
#include "filter_nn_batch_tan.cuh"

namespace rodeo {

template struct NnFilterTanInstances<FitzHughNagumo, 4>;

}  // namespace rodeo
