// The instances of K11c (dalton_filter_batch_tan.cuh) for FitzHugh-Nagumo at
// q = 3, under kramer and rodeo, with and without data.
#include "dalton_filter_batch_tan.cuh"

namespace rodeo {

template struct DaltonFilterTanInstances<FitzHughNagumo, 3>;

}  // namespace rodeo
