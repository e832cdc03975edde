// The instances of K11a (filter_batch_tan.cuh) for FitzHugh-Nagumo at q = 5
// (its weight and initial state padded with zeros past the third derivative),
// under kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<FitzHughNagumo, 5>;

}  // namespace rodeo
