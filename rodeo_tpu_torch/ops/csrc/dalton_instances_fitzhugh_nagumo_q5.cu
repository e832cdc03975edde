// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) for
// FitzHugh-Nagumo at q = 5 (its weight and initial state padded with zeros
// past the third derivative), under kramer and rodeo, with and without data.
#include "dalton_filter_batch.cuh"

namespace rodeo {

template struct DaltonFilterInstances<FitzHughNagumo, 5>;

}  // namespace rodeo
