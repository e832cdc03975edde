// The instances of K11c (dalton_filter_batch_tan.cuh) for SEIRAH at q = 3
// (its Jacobian on nested Duals under kramer), under kramer and rodeo, with
// and without data.
#include "dalton_filter_batch_tan.cuh"

namespace rodeo {

template struct DaltonFilterTanInstances<Seirah, 3>;

}  // namespace rodeo
