// The instances of K11c (dalton_filter_batch_tan.cuh) for FitzHugh-Nagumo at
// q = 4 (its weight and initial state padded with zeros past the third
// derivative), under kramer and rodeo, with and without data.
#include "dalton_filter_batch_tan.cuh"

namespace rodeo {

template struct DaltonFilterTanInstances<FitzHughNagumo, 4>;

}  // namespace rodeo
