// The instances of K1 (filter_batch.cuh) and K3 (filter_single.cuh) for
// FitzHugh-Nagumo at q = 4 (its weight and initial state padded with zeros
// past the third derivative), one in each interrogation mode.
#include "filter_batch.cuh"
#include "filter_single.cuh"

namespace rodeo {

template struct FilterBatchInstances<FitzHughNagumo, 4>;
template struct FilterSingleInstances<FitzHughNagumo, 4>;

}  // namespace rodeo
